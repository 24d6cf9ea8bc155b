"""The per-round entry points on the card: ``FedSim.round`` and the async
engine's dispatch and flush, each one CUDA graph per shape and setting,
captured at the first call after one dropped warm-up run and replayed once
a call, against their eager twins under ``repro_torch.disable_graphs()``,
to the bit under deterministic algorithms. Marked ``cuda``: the ``card``
fixture skips without CUDA (decided at run time). No jax here, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_round_program_cuda.py
"""
import os
import re
import tempfile
import warnings

import numpy as np
import pytest
import torch

from repro_torch import disable_graphs
from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig
from repro_torch.core.sim import WARMUP_ROUNDS, FedSim
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.kernels import ops
from repro_torch.models import convmixer as cm
from repro_torch.models.params import init_params

pytestmark = pytest.mark.cuda

M, N, K, B, R = 20, 4, 2, 8, 4
MC = cm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
_SPARSE = dict(compressor="blocktopk", track_gamma=False)

CASES = {
    "sparse-fused": dict(_SPARSE, fused_ingest="kernel"),
    "dense-blocktopk": dict(compressor="blocktopk", sparse_uplink=False),
    "sign-wire-two-way": dict(compressor="sign", wire=True, two_way=True),
    "faults-wire": dict(_SPARSE, wire=True, fault=FaultConfig(
        crash_prob=0.3, corrupt_prob=0.4, corrupt_mode="bitflip", seed=3)),
}
ASYNC = dict(_SPARSE, wire=True, async_buffer=2, fused_ingest="kernel")
#: each kernel's device functions, as a graph's ``debug_dump`` names them
KERNEL_SYMBOLS = {"topk_ef_sparse": ("topk_ef_sparse_kernel",),
                  "topk_ef": ("topk_ef_kernel",),
                  "sign_ef": ("sign_ef_kernel",),
                  "fedams_ingest": ("fedams_ingest_kernel",),
                  "fedams_update": ("fedams_update_kernel",),
                  "pack_uint": ("pack_bits_kernel", "pack_groups_kernel"),
                  "unpack_uint": ("unpack_bits_kernel",
                                  "unpack_groups_kernel")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield torch.device("cuda")
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture
def captures(monkeypatch):
    """Counts the CUDA graph captures begun."""
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kw):
        seen.append(self)
        return begin(self, *args, **kw)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", counted)
    return seen


def _nodes(graph) -> dict:
    """A graph's kernel nodes by kernel (its ``debug_dump``), the kernels
    that have any."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.dot")
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="DEBUG: calling")
            graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    counts = {name: sum(len(re.findall(rf"(?<![A-Za-z_]){sym}", text))
                        for sym in syms)
              for name, syms in KERNEL_SYMBOLS.items()}
    return {k: n for k, n in counts.items() if n}


def _parts(st):
    parts = [st.params, st.errors, st.server_error, st.x_client]
    for t in st.opt:
        parts += list(t) if isinstance(t, tuple) else [t]
    return parts


def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _same_mets(want, got):
    assert len(want) == len(got)
    for m_e, m_g in zip(want, got):
        assert set(m_e) == set(m_g)
        for key, v in m_e.items():
            if isinstance(v, torch.Tensor):
                assert _same_bits(v.reshape(()), m_g[key].reshape(())), key
            else:
                assert v == m_g[key], key


def _setup(kw):
    data = FederatedClassification(num_clients=M, feature_dim=32, seed=0)
    fed = FedConfig(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
                    local_steps=K, num_clients=M, participating=N, **kw)
    p0 = init_params(cm.mlp_defs(MC), torch.Generator().manual_seed(0))
    gen = np.random.default_rng(1)
    ids = np.stack([gen.choice(M, N, replace=False) for _ in range(R)])
    per = [data.round_batches(ids[r], r, K, B) for r in range(R)]
    make = lambda: FedSim(lambda p, b: cm.mlp_loss(p, b, MC), fed)
    return make, p0, ids, per


@pytest.mark.parametrize("kw", list(CASES.values()), ids=list(CASES))
def test_round_is_one_capture_replayed_and_its_eager_twin(card, captures,
                                                          kw):
    """R calls of ``round``: one capture, then a replay a call; the state
    and every metric equal R eager rounds' to the bit; the wrappers launch
    only in the warm-up (one round's worth), and the graph's kernel nodes
    are one eager round's wrapper launches, the capture's record."""
    make, p0, ids, per = _setup(kw)
    sim_e = make()
    st = sim_e.init(p0)
    ops.reset_launches()
    mets = []
    with disable_graphs():
        for r in range(R):
            st, met = sim_e.round(st, per[r], ids[r])
            mets.append(met)
    torch.cuda.synchronize()
    eager = {k: v for k, v in ops.launches.items() if v}
    sim_p = make()
    st_p = sim_p.init(p0)
    ops.reset_launches()
    mets_p = []
    for r in range(R):
        st_p, met = sim_p.round(st_p, per[r], ids[r])
        mets_p.append(met)
    torch.cuda.synchronize()
    wrapper = {k: v for k, v in ops.launches.items() if v}
    (prog,) = sim_p._programs.values()
    assert len(captures) == 1 and prog.graph is not None
    assert prog.replays == R
    assert all(_same_bits(a, b) for a, b in zip(_parts(st), _parts(st_p)))
    assert (st_p.bits, st_p.round) == (st.bits, st.round)
    _same_mets(mets, mets_p)
    assert eager
    per_round = {k: n // R for k, n in eager.items()}
    assert all(n == per_round[k] * R for k, n in eager.items())
    assert wrapper == {k: n * WARMUP_ROUNDS for k, n in per_round.items()}
    assert {k: n for k, n in prog.counts.items() if n} == per_round
    assert _nodes(prog.graph) == per_round


def test_async_steps_are_two_captures_and_their_eager_twins(card, captures):
    """The async engine (B = 2 of 4, the fused ingest) through its dispatch
    and flush programs: two captures, a replay a step; the state and every
    flush's metrics equal the eager steps' to the bit; the two graphs'
    kernel nodes times their replays are the eager run's launches."""
    make, p0, ids, per = _setup(ASYNC)
    batches = {k: np.stack([b[k] for b in per]) for k in per[0]}
    sim_e = make()
    ops.reset_launches()
    with disable_graphs():
        st, mets = sim_e.run_rounds(sim_e.init(p0), batches, ids)
    torch.cuda.synchronize()
    eager = {k: v for k, v in ops.launches.items() if v}
    sim_p = make()
    st_p, mets_p = sim_p.run_rounds(sim_p.init(p0), batches, ids)
    torch.cuda.synchronize()
    assert len(captures) == 2
    assert all(_same_bits(a, b) for a, b in zip(_parts(st), _parts(st_p)))
    _same_mets(mets, mets_p)
    progs = {key[0]: p for key, p in sim_p._programs.items()}
    assert sorted(progs) == ["dispatch", "flush"]
    assert progs["dispatch"].replays == R
    assert progs["flush"].replays == len(mets)
    graph = {}
    for prog in progs.values():
        nodes = _nodes(prog.graph)
        assert nodes == {k: n for k, n in prog.counts.items() if n}
        for k, n in nodes.items():
            graph[k] = graph.get(k, 0) + n * prog.replays
    assert graph == eager == {"topk_ef_sparse": R,
                              "fedams_ingest": len(mets)}


def test_two_chains_share_one_capture(card, captures):
    """Two chains on one FedSim, their calls interleaved: one capture; the
    second chain's EF buffer is lent into the program's slot (the first
    chain's) for each of its replays, so each chain's buffer is updated in
    place and the other's is left as it was; both chains equal their eager
    twins to the bit."""
    make, p0, ids, per = _setup(CASES["sparse-fused"])
    sim = make()
    a, b = sim.init(p0), sim.init(p0)
    bufs = a.errors, b.errors
    twin_a, twin_b = make(), make()
    ea, eb = twin_a.init(p0), twin_b.init(p0)
    for r in range(R):
        a, _ = sim.round(a, per[r], ids[r])
        before = a.errors.clone()
        b, _ = sim.round(b, per[R - 1 - r], ids[R - 1 - r])
        assert _same_bits(a.errors, before)
        with disable_graphs():
            ea, _ = twin_a.round(ea, per[r], ids[r])
            eb, _ = twin_b.round(eb, per[R - 1 - r], ids[R - 1 - r])
    torch.cuda.synchronize()
    (prog,) = sim._programs.values()
    assert len(captures) == 1 and prog.replays == 2 * R
    assert a.errors is bufs[0] and b.errors is bufs[1]
    for got, want in ((a, ea), (b, eb)):
        assert all(_same_bits(x, y) for x, y in zip(_parts(want),
                                                     _parts(got)))
