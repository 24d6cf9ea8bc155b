"""The step builders' train step on the card (``launch/steps.py::
build_train_step``'s ``launch.programs.TrainStep``): on one NCCL rank (the
card's machine has one card, and NCCL refuses two ranks on one card) one
round, with remat "full" and fedcams' top-k over the dense uplink (route
z's settings at the xlstm smoke config), captured into a CUDA graph and
replayed a call, to the bit its eager twin under
``repro_torch.disable_graphs()`` with deterministic algorithms; and
``repro_torch.clear_caches()`` handing the program's memory back. Marked
``cuda``: the ``nccl_rank`` fixture skips without CUDA (decided at run
time). No jax here, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_train_step_program_cuda.py
"""
import dataclasses
import gc
import socket

import pytest
import torch
import torch.distributed as dist

from repro_torch import clear_caches, disable_graphs
from repro_torch.kernels import ops
from repro_torch.models.params import tree_leaves

pytestmark = pytest.mark.cuda

R, SEQ, BATCH = 3, 32, 4


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
        clear_caches()
        dist.destroy_process_group()


def _step():
    """Route z's step at the xlstm smoke config on a (1, 1) mesh: the dry
    run's settings at one local step (fedcams, top-k 1/64 over the dense
    uplink, remat "full"); its TrainConfig at the step's shape, the
    init and R rounds' batches on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.mesh import init_fed_state, shard_batch
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    fed, train = dryrun.build_configs(dryrun.parser().parse_args(
        ["--local-steps", "1"]))
    spec = get_arch("xlstm-350m")
    spec = dataclasses.replace(spec, model=spec.smoke)
    b = steps.build_train_step(spec, ShapeConfig("train_4k", SEQ, BATCH,
                                                 "train"),
                               make_mesh((1, 1), ("data", "model"), "cuda"),
                               fed, train)
    tcfg = dataclasses.replace(train, global_batch=BATCH, seq_len=SEQ)
    data = FederatedLMData(num_clients=1, vocab_size=spec.model.vocab_size,
                           seed=0)
    batches = [shard_batch(data.mesh_batch(r, 1, BATCH, SEQ), b.model,
                           b.fed, tcfg, b.ctx, "cuda") for r in range(R)]
    init = lambda: init_fed_state(b.model, b.fed,
                                  torch.Generator().manual_seed(0), b.ctx,
                                  "cuda")
    return b, init, batches


def _leaves(st):
    return [t for f in ("params", "m", "v", "vhat", "errors")
            for t in tree_leaves(getattr(st, f))] + [st.round]


def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def test_the_remat_dense_uplink_round_is_captured_bitwise_its_twin(
        nccl_rank):
    """Under deterministic algorithms: R calls of ``b.fn`` (one program,
    one capture after a warm-up round, a replay a call, the carry the
    first state's tensors) against R calls under ``disable_graphs()``:
    the state (params, m, v, v̂, the EF row, the round) and every round's
    metrics to the bit; the capture recorded one ``topk_ef`` and one
    ``fedams_update`` launch a leaf (``ops.captured_launches``) and no
    other kernel; the wrappers launched one round's (the warm-up's)."""
    b, init, batches = _step()
    leaves = len(tree_leaves(b.model.defs()))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with disable_graphs():
            st, twin = init(), []
            for r in range(R):
                st, met = b.fn(st, batches[r], r)
                twin.append(met)
        ops.reset_launches()
        st_p, mets = init(), []
        ids = [id(t) for t in _leaves(st_p)]
        for r in range(R):
            st_p, met = b.fn(st_p, batches[r], r)
            mets.append(met)
        torch.cuda.synchronize()
        wrapper = {k: v for k, v in ops.launches.items() if v}
    finally:
        torch.use_deterministic_algorithms(False)
    last = b.fn.rounds.last
    prog = last["program"]
    assert last["captured"] is True and len(b.fn.rounds.programs) == 1
    assert prog.graph is not None and st_p is prog.carry
    assert [id(t) for t in _leaves(st_p)] == ids
    want = {"topk_ef": leaves, "fedams_update": leaves}
    assert {k: v for k, v in prog.counts.items() if v} == want, prog.counts
    assert wrapper == want, wrapper
    assert all(_same_bits(a, c) for a, c in zip(_leaves(st), _leaves(st_p)))
    for r in range(R):
        assert sorted(mets[r]) == sorted(twin[r])
        for key, v in mets[r].items():
            assert _same_bits(twin[r][key].reshape(()), v), (r, key)
    assert all(torch.isfinite(t).all() for t in tree_leaves(st_p.params))


def _reserved() -> int:
    """The card's reserved bytes after ``empty_cache()``."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def test_clear_caches_gives_the_train_steps_memory_back(nccl_rank):
    """A round under ``disable_graphs()`` first, then ``clear_caches()``;
    then the program's calls (its graph's pool, its stream's blocks and
    cuBLAS's workspace on that stream, its static inputs) raise the
    card's reserved bytes; after ``clear_caches()`` (which drops the
    program and cuBLAS's workspaces) and ``torch.cuda.empty_cache()``
    they are back at their level before the program: the carry is the
    caller's state, held throughout."""
    b, init, batches = _step()
    st = init()
    with disable_graphs():
        b.fn(st, batches[0], 0)
    clear_caches()
    before = _reserved()
    for r in range(R):
        st, _ = b.fn(st, batches[r], r)
    held = _reserved()
    assert b.fn.rounds.last["captured"] is True and held > before
    clear_caches()
    assert b.fn.rounds.programs == {} and b.fn.rounds.last is None
    assert _reserved() == before, (before, held)
