"""The mesh's multi-round program on the card: one NCCL rank (the card's
machine has one card, and NCCL refuses two ranks on one card), one round
captured into a CUDA graph and replayed R times, against R eager
``fed_round`` calls, to the bit under deterministic algorithms. Marked
``cuda``: the ``nccl_rank`` fixture skips without CUDA (decided at run
time). No jax here, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_mesh_rounds_cuda.py
"""
import socket
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core import mesh as meshmod
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef, tree_leaves

pytestmark = pytest.mark.cuda

D, DB, BC, K, R = 8192, 24, 4, 2, 4
SEL = dict(algorithm="fedcams", aggregation="sparse", compressor="blocktopk")
CASES = {
    "fused-kernel": (dict(SEL, track_gamma=False),
                     ("topk_ef_sparse", "fedams_ingest")),
    "two-pass": (dict(SEL, fused_ingest="off"),
                 ("topk_ef_sparse", "fedams_update")),
    "dense-blocktopk": (dict(SEL, aggregation="dense"),
                        ("topk_ef", "fedams_update")),
    "faults-hetero": (dict(SEL, track_gamma=False, local_steps=3,
                           local_steps_min=1, eta_l_decay=0.9,
                           fault=FaultConfig(corrupt_prob=0.4,
                                             corrupt_mode="nan",
                                             max_update_norm=40.0)),
                      ("topk_ef_sparse", "fedams_update")),
}
#: the warning of ``torch.cuda.set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"


class Model:
    """``loss = 0.5·Σ(x·W − t)²`` with W the (D,) leaf seen as (64, D/64)
    and a small bias leaf: a matmul and its gradient through cuBLAS."""

    tp = 1

    def defs(self):
        return {"w": ParamDef((D,), dtype="float32"),
                "b": ParamDef((DB,), dtype="float32")}

    def loss(self, p, b, ctx, remat_policy="none", chunk=0):
        y = b["x"] @ p["w"].reshape(64, D // 64)
        e = y - b["t"]
        eb = p["b"][None, :] - b["t"][:, :DB]
        return 0.5 * (e * e).sum() + 0.5 * (eb * eb).sum(), ()

    def train_batch_defs(self, global_batch, seq_len):
        return {"x": ParamDef((global_batch, 64)),
                "t": ParamDef((global_batch, D // 64))}


@pytest.fixture
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield torch.device("cuda")
    finally:
        dist.destroy_process_group()


def _batches(k: int):
    rng = np.random.default_rng(3)
    return [{"x": rng.normal(size=(k, BC, 64)).astype(np.float32),
             "t": rng.normal(size=(k, BC, D // 64)).astype(np.float32)}
            for _ in range(R)]


def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _leaves(st):
    return [t for f in ("params", "m", "v", "vhat", "errors")
            for t in tree_leaves(getattr(st, f))] + [st.round]


@pytest.mark.parametrize("name", list(CASES))
def test_one_graph_of_the_round_equals_the_eager_loop(nccl_rank, name):
    """Under deterministic algorithms, on one NCCL rank: R eager rounds and
    one program call of R rounds from the same init give the same state and
    metrics to the bit; the program reports ``captured``; between the first
    replay and the last no synchronizing CUDA operation runs (sync debug
    mode "warn"), and one runs after them (the metrics' read); the wrappers
    launch only in the warm-up round, and the capture recorded one round's
    launches."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import ParallelContext
    kw, kernels = CASES[name]
    fed = FedConfig(eta=0.1, eps=1e-4, eta_l=0.05, num_clients=1,
                    client_axes=("data",), compress_ratio=1 / 64,
                    **dict(dict(local_steps=K), **kw))
    mesh = make_mesh((1,), ("data",), "cuda")
    ctx = ParallelContext(client_axes=("data",), num_clients=1, mesh=mesh)
    train = TrainConfig(global_batch=BC, seq_len=1, remat_policy="none")
    model = Model()
    rnd = meshmod.build_fed_round(model, fed, train, ctx,
                                  kernel_impl=ops.KernelImpl())
    init = lambda: meshmod.init_fed_state(
        model, fed, torch.Generator().manual_seed(0), ctx, "cuda")
    raws = _batches(fed.local_steps)
    one = lambda raw: meshmod.shard_batch(raw, model, fed, train, ctx,
                                          "cuda")
    staged = meshmod.shard_batch(
        {k: np.stack([raw[k] for raw in raws]) for k in raws[0]}, model,
        fed, train, ctx, "cuda", staged=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        st, mets = init(), []
        ops.reset_launches()
        for r, raw in enumerate(raws):
            st, met = rnd(st, one(raw), r)
            mets.append(met)
        torch.cuda.synchronize()
        eager = dict(ops.launches)
        scan = meshmod.build_fed_rounds_scan(rnd)
        G = torch.cuda.CUDAGraph
        replay, at = G.replay, []
        mode = torch.cuda.get_sync_debug_mode()
        ops.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            syncs = lambda: sum(SYNC_WARNING in str(w.message)
                                for w in caught)

            def spy(self):
                at.append(syncs())
                return replay(self)

            G.replay = spy
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st_g, stacked = scan(init(), staged, list(range(R)))
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                G.replay = replay
            total = syncs()
        wrapper = dict(ops.launches)
    finally:
        torch.use_deterministic_algorithms(False)
    assert scan.last["captured"] is True and len(at) == R
    assert at[-1] == at[0] and total - at[-1] == 1, (at, total)
    assert all(_same_bits(a, b) for a, b in zip(_leaves(st), _leaves(st_g)))
    for key, col in stacked.items():
        for r in range(R):
            assert _same_bits(mets[r][key].reshape(()), col[r]), (key, r)
    prog = scan.last["program"]
    for k in kernels:
        assert eager[k] > 0 and prog.counts[k] * R == eager[k], (k, eager)
    assert all(wrapper[k] * R == eager[k] for k in eager), (wrapper, eager)
