"""``FedSim.run_rounds`` on the card: one CUDA graph of a round, replayed,
against the eager loop of ``FedSim.round`` (under
``repro_torch.disable_graphs``: ``round`` is itself a replayed graph
outside it), to the bit. Marked ``cuda``:
the ``card`` fixture skips without CUDA (decided at run time). No jax here,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_run_rounds_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import disable_graphs
from repro_torch.configs.base import FedConfig
from repro_torch.core.sim import WARMUP_ROUNDS, FedSim
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.kernels import ops
from repro_torch.models import convmixer as cm
from repro_torch.models.params import init_params

pytestmark = pytest.mark.cuda

M, N, K, B, R = 20, 4, 2, 8, 4
MC = cm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)

CASES = {
    "fused-kernel": dict(compressor="blocktopk", track_gamma=False,
                         fused_ingest="kernel"),
    "sign": dict(compressor="sign"),
    "wire-two-way-hetero": dict(compressor="blocktopk", wire=True,
                                two_way=True, local_steps_min=1),
    "randk-chunk": dict(compressor="randk", client_chunk=2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _parts(st):
    parts = [st.params, st.errors, st.server_error, st.x_client]
    for t in st.opt:
        parts += list(t) if isinstance(t, tuple) else [t]
    return parts


def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


@pytest.mark.parametrize("kw", list(CASES.values()), ids=list(CASES))
def test_run_rounds_replays_one_graph_of_the_eager_round(card, kw):
    """Under deterministic algorithms: R eager rounds and one run_rounds
    call from the same init give the same state and metrics to the bit;
    the wrappers launch only in the warm-up, and the capture recorded one
    round's launches; a second call with the same shapes replays the same
    graph, loaded anew."""
    data = FederatedClassification(num_clients=M, feature_dim=32, seed=0)
    fed = FedConfig(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
                    local_steps=K, num_clients=M, participating=N, **kw)
    p0 = init_params(cm.mlp_defs(MC), torch.Generator().manual_seed(0))
    gen = np.random.default_rng(1)
    ids = np.stack([gen.choice(M, N, replace=False) for _ in range(R)])
    per = [data.round_batches(ids[r], r, K, B) for r in range(R)]
    batches = {k: np.stack([b[k] for b in per]) for k in per[0]}
    rngs = lambda: [torch.Generator().manual_seed(r) for r in range(R)]
    loss = lambda p, b: cm.mlp_loss(p, b, MC)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sim = FedSim(loss, fed)
        st = sim.init(p0)
        ops.reset_launches()
        mets = []
        with disable_graphs():
            for r in range(R):
                st, met = sim.round(st, {k: v[r] for k, v in
                                         batches.items()}, ids[r], rngs()[r])
                mets.append(met)
        torch.cuda.synchronize()
        eager = dict(ops.launches)
        sim_g = FedSim(loss, fed)
        ops.reset_launches()
        st_g, mets_g = sim_g.run_rounds(sim_g.init(p0), batches, ids, rngs())
        graph = dict(ops.launches)
        st_2, mets_2 = sim_g.run_rounds(sim_g.init(p0), batches, ids, rngs())
    finally:
        torch.use_deterministic_algorithms(False)
    (prog,) = sim_g._programs.values()
    assert prog.graph is not None
    for got in (st_g, st_2):
        assert all(_same_bits(a, b) for a, b in zip(_parts(st), _parts(got)))
        assert (got.bits, got.round) == (st.bits, st.round)
    for ms in (mets_g, mets_2):
        for m_e, m_g in zip(mets, ms):
            assert set(m_e) == set(m_g)
            for key, v in m_e.items():
                if isinstance(v, torch.Tensor):
                    assert _same_bits(v.reshape(()), m_g[key]), key
                elif ms is mets_g:   # the CommLog's sums go on across calls
                    assert v == m_g[key], key
    assert any(eager.values())
    assert all(graph[k] * R == eager[k] * WARMUP_ROUNDS
               for k in eager), (graph, eager)
    assert all(prog.counts[k] * R == eager[k] for k in eager), (
        prog.counts, eager)
