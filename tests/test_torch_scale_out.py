"""Scale-out in the port: the EF store (a copy of the reference's, held to
it under one operation sequence), ``ef_store`` against the resident buffer
(bitwise), client chunks against the unchunked round (bitwise on the
sparse path, within ``CHUNK_DENSE_RTOL`` on the dense one), the grouped
aggregate against the JAX function, grouped and chunked FedSim against the
JAX FedSim, and the JAX FedSim's ``__init__`` refusals."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.checkpoint.store import EFStore as JaxEFStore
from repro.core import stages as jstages
from repro_torch.checkpoint.store import EFStore
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import stages as tstages
from repro_torch.core.sim import FedSim
from test_torch_sim import (LOSS_RTOL, M, N, _cfg, _port_loss, _run_both,
                            _staged_rounds, staged_init)

torch.set_num_threads(1)

#: chunked dense against unchunked: the chunks' hats are summed chunk by
#: chunk and then over chunks, where the unchunked round takes one mean
#: over the (n, d) block — a few fp32 roundings of the aggregate a round
CHUNK_DENSE_RTOL = 1e-6


# -- the EF store ---------------------------------------------------------------


def _ops(seed: int, m: int, d: int, steps: int):
    """A random sequence of store operations over overlapping cohorts:
    gathers (matching a queued prefetch or not), prefetches and scatters
    that land while a prefetch covering some of their rows is in flight."""
    r = np.random.default_rng(seed)
    ops, prev = [], None
    for _ in range(steps):
        n = int(r.integers(1, 12))
        idx = r.choice(m, n, replace=False)
        if prev is not None and r.random() < 0.5:
            idx[: min(n, prev.size) // 2] = prev[: min(n, prev.size) // 2]
            idx = np.unique(idx)
        kind = r.choice(["gather", "prefetch", "scatter", "cycle"])
        ops.append((kind, idx, r.standard_normal((idx.size, d))
                    .astype(np.float32)))
        prev = idx
    return ops


@pytest.mark.parametrize("m,d,shard", [(500, 16, 64), (250, 8, 100),
                                       (37, 5, 256), (1000, 3, 1)])
def test_ef_store_is_the_reference_store(m, d, shard):
    """The same operation sequence on both stores — including a prefetch
    running while a scatter patches its rows, and the round cycle gather →
    prefetch(next) → scatter — gives equal rows from every gather and equal
    ``nbytes`` after every operation, ragged last shard included."""
    stores = (JaxEFStore(m, d, shard_clients=shard),
              EFStore(m, d, shard_clients=shard))
    for kind, idx, rows in _ops(m + d, m, d, 60):
        outs = ([], [])
        for s, out in zip(stores, outs):
            if kind == "gather":
                out.append(s.gather(idx))
            elif kind == "prefetch":
                s.prefetch(idx)
            elif kind == "scatter":
                s.scatter(idx, rows)
            else:
                out.append(s.gather(idx))
                s.prefetch(idx[::-1])
                s.scatter(idx, rows)
                out.append(s.gather(idx[::-1]))    # consumes the prefetch
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        assert stores[0].nbytes == stores[1].nbytes
    np.testing.assert_array_equal(stores[0].gather(np.arange(m)),
                                  stores[1].gather(np.arange(m)))


def test_ef_store_is_lazy_ragged_and_joins_its_threads():
    s = EFStore(10 ** 9, 64)
    assert s.nbytes == 0 and not s.gather(np.array([0, 999_999_999])).any()
    s = EFStore(250, 8, shard_clients=100)
    s.scatter(np.array([249]), np.full((1, 8), 3.0, np.float32))
    assert s.nbytes == 50 * 8 * 4
    s = EFStore(2_000, 8, shard_clients=64)
    rng = np.random.default_rng(1)
    for _ in range(20):
        idx = rng.choice(2_000, 64, replace=False)
        s.prefetch(idx)
        s.scatter(idx[:32], np.ones((32, 8), np.float32))
        assert (s.gather(idx)[:32] == 1.0).all()
    assert threading.active_count() < 20
    with pytest.raises(ValueError, match="scatter rows shape"):
        s.scatter(np.array([1, 2]), np.ones((3, 8), np.float32))


def test_ef_store_prefetch_patching_holds_under_thread_switches():
    """The prefetch thread and the round's scatter share the prefetch
    buffer: with the interpreter switching threads every microsecond, 200
    round cycles over overlapping cohorts (a client in consecutive rounds
    is read from the in-flight prefetch after its scatter) read exactly a
    numpy mirror's rows — a lost patch would leave a stale row — and leave
    no thread running."""
    import sys
    m, d, n = 300, 32, 24
    store, mirror = EFStore(m, d, shard_clients=16), np.zeros((m, d),
                                                               np.float32)
    r = np.random.default_rng(7)
    nxt = r.choice(m, n, replace=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(200):
            idx = nxt
            np.testing.assert_array_equal(store.gather(idx), mirror[idx])
            nxt = np.concatenate([idx[: n // 2], r.choice(
                np.setdiff1d(np.arange(m), idx), n - n // 2, replace=False)])
            store.prefetch(nxt)
            rows = r.standard_normal((n, d)).astype(np.float32)
            store.scatter(idx, rows)
            mirror[idx] = rows
        last = store._pf.thread
        np.testing.assert_array_equal(store.gather(nxt), mirror[nxt])
    finally:
        sys.setswitchinterval(old)
    assert store._pf is None and not last.is_alive()


# -- FedSim: ef_store, chunks, groups ------------------------------------------


def _run_port(kw, rounds=5, run_rounds=False, seed=0):
    """The port's FedSim over ``rounds`` staged rounds (a generator a round,
    seeded r, for randk's draws); returns (sim, state, mets, all m EF
    rows)."""
    defs, _, data = make_problem("mlp", M)
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw), device="cpu")
    st = ts.init(params_from_jax(jax.device_get(staged_init(defs, seed))))
    staged = _staged_rounds(data, rounds)
    gens = [torch.Generator().manual_seed(r) for r in range(rounds)]
    if run_rounds:
        st, mets = ts.run_rounds(
            st, {k: np.stack([s[1][k] for s in staged])
                 for k in staged[0][1]},
            np.stack([s[0] for s in staged]), gens)
    else:
        mets = []
        for (idx, b, _), g in zip(staged, gens):
            st, met = ts.round(st, b, idx, g)
            mets.append(met)
    rows = (torch.from_numpy(ts._efs.gather(np.arange(M)))
            if ts._efs is not None else st.errors)
    return ts, st, mets, rows


def _same_state(a, b):
    for name in ("params", "x_client", "server_error"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("m", "v", "vhat", "t"):
        assert torch.equal(getattr(a.opt, name), getattr(b.opt, name)), name
    assert (a.bits, a.round) == (b.bits, b.round)


@pytest.mark.parametrize("run_rounds", [False, True],
                         ids=["round_loop", "run_rounds"])
@pytest.mark.parametrize("extra", [
    dict(), dict(track_gamma=False, fused_ingest="jnp"),
    dict(client_chunk=2, agg_groups=2, wire=True, track_gamma=False),
    dict(compressor="sign"), dict(compressor="randk")],
    ids=["sparse", "fused", "chunked-grouped-wire", "sign", "randk"])
def test_ef_store_is_bitwise_the_resident_buffer(extra, run_rounds):
    """The same rounds with the (m, d) EF rows in the host store and on the
    device: equal losses, params, server state and every client's EF row,
    to the bit; the device holds an (n, d) block; ``run_rounds`` prefetches
    each next round's rows."""
    kw = _cfg("b", **extra)
    _, st_r, m_r, rows_r = _run_port(kw, run_rounds=run_rounds)
    ts, st_s, m_s, rows_s = _run_port(dict(kw, ef_store=True),
                                      run_rounds=run_rounds)
    assert tuple(st_s.errors.shape) == (N, st_s.params.numel())
    assert tuple(st_r.errors.shape) == (M, st_r.params.numel())
    assert 0 < ts._efs.nbytes
    _same_state(st_s, st_r)
    assert torch.equal(rows_s, rows_r)
    assert [float(m["loss"]) for m in m_s] == [float(m["loss"]) for m in m_r]


@pytest.mark.parametrize("extra", [
    dict(), dict(track_gamma=False), dict(agg_groups=2),
    dict(wire=True, wire_value_dtype="bfloat16"),
    dict(compressor="topk")], ids=["gamma", "no-gamma", "grouped",
                                   "bf16-wire", "topk"])
def test_chunked_sparse_is_bitwise_the_unchunked_round(extra):
    """The chunks scatter into the running sum in client order, so params,
    server state, EF rows and losses are bitwise the unchunked round's; γ
    (its means summed chunk by chunk) within 1e-6 relative."""
    kw = _cfg("b", **extra)
    ts, st_c, m_c, rows_c = _run_port(dict(kw, client_chunk=2))
    _, st_u, m_u, rows_u = _run_port(kw)
    assert ts.sparse and ts._fused == "off"
    _same_state(st_c, st_u)
    assert torch.equal(rows_c, rows_u)
    assert [float(m["loss"]) for m in m_c] == [float(m["loss"]) for m in m_u]
    np.testing.assert_allclose([float(m["gamma"]) for m in m_c],
                               [float(m["gamma"]) for m in m_u], rtol=1e-6)


@pytest.mark.parametrize("extra", [
    dict(compressor="sign"), dict(sparse_uplink=False),
    dict(compressor="sign", wire=True), dict(compressor="randk")],
    ids=["sign", "blocktopk-dense", "sign-wire", "randk"])
def test_chunked_dense_is_within_float_of_the_unchunked_round(extra):
    """Dense chunks compress each row as the unchunked round does, so after
    one round the EF rows are bitwise the unchunked round's, and the
    aggregate — the chunks' hats summed chunk by chunk, where the unchunked
    round takes one mean over the (n, d) block — moves params and m by at
    most ``CHUNK_DENSE_RTOL`` relative. Over 5 rounds those last bits feed
    back through training: losses within ``CHUNK_DENSE_RTOL`` relative,
    params within 1e-6 absolute (measured: 1.1e-7 and 3.0e-8)."""
    kw = _cfg("b", **extra)
    ts, st_c, _, rows_c = _run_port(dict(kw, client_chunk=2), rounds=1)
    _, st_u, _, rows_u = _run_port(kw, rounds=1)
    assert not ts.sparse
    assert torch.equal(rows_c, rows_u)
    np.testing.assert_allclose(st_c.params.numpy(), st_u.params.numpy(),
                               rtol=CHUNK_DENSE_RTOL, atol=0)
    np.testing.assert_allclose(st_c.opt.m.numpy(), st_u.opt.m.numpy(),
                               rtol=CHUNK_DENSE_RTOL, atol=0)
    _, st_c, m_c, _ = _run_port(dict(kw, client_chunk=2))
    _, st_u, m_u, _ = _run_port(kw)
    np.testing.assert_allclose([float(m["loss"]) for m in m_c],
                               [float(m["loss"]) for m in m_u],
                               rtol=CHUNK_DENSE_RTOL)
    np.testing.assert_allclose(st_c.params.numpy(), st_u.params.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_aggregate_is_the_jax_function(groups):
    """Bitwise ``repro.core.stages.server_aggregate_sparse_grouped`` on
    selections with collisions inside and across groups and padded-tail
    indices; against the flat scatter-mean, only coordinates picked in two
    or more groups move, by at most 1 ulp."""
    n, k, d = 8, 60, 700
    r = np.random.default_rng(groups)
    vals = r.standard_normal((n, k)).astype(np.float32)
    idx = np.stack([r.choice(768, size=k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    want = np.asarray(jstages.server_aggregate_sparse_grouped(
        jnp.asarray(vals), jnp.asarray(idx), d, n, groups))
    got = tstages.server_aggregate_sparse_grouped(
        torch.from_numpy(vals), torch.from_numpy(idx), d, n, groups).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    flat = tstages.server_aggregate_sparse(
        torch.from_numpy(vals), torch.from_numpy(idx), d, n).numpy()
    picked = np.zeros((groups, d + 100), bool)
    for g in range(groups):
        picked[g, idx[g * n // groups:(g + 1) * n // groups].ravel()] = True
    across = picked[:, :d].sum(axis=0) >= 2
    assert across.any()
    np.testing.assert_array_equal(got[~across], flat[~across])
    assert (np.abs(got - flat) <= np.spacing(np.abs(flat))).all()


@pytest.mark.parametrize("extra", [
    dict(agg_groups=2), dict(client_chunk=2),
    dict(client_chunk=2, agg_groups=2, wire=True),
    dict(agg_groups=4, wire=True, track_gamma=False),
    dict(compressor="sign", client_chunk=2, wire=True)],
    ids=["grouped", "chunked", "chunked-grouped-wire", "grouped-4-wire",
         "sign-chunked-wire"])
def test_grouped_and_chunked_fedsim_tracks_jax_fedsim(extra):
    """10 MLP rounds of each scale-out configuration on both packages:
    per-round loss (and γ) within ``LOSS_RTOL``; ``bits`` and the tiered
    wire billing (tier 2: g dense fp32 partials) equal (``_run_both``);
    final params within 1e-4."""
    kw = _cfg("b", **extra)
    hist, jflat, tstate, ts = _run_both("mlp", kw, rounds=10)
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist[:, 3], hist[:, 2], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tstate.params.numpy(), jflat, atol=1e-4)
    if kw.get("wire") and kw.get("agg_groups", 1) > 1:
        assert ts.comm_log.edge_bytes == 10 * kw["agg_groups"] * 4 * ts._d


def test_trainer_saves_the_cohort_block_under_ef_store(tmp_path, monkeypatch):
    """``FederatedTrainer`` with ``ef_store`` (staged rounds, so through
    ``run_rounds``' prefetching loop) saves what the JAX trainer saves: the
    manifests match key for key, shape for shape and dtype for dtype — the
    ``errors`` leaf is the (n, d) cohort block in both — and the JAX
    package restores the port's file into its trainer's state."""
    import json

    from repro.checkpoint import load_pytree as jax_load
    from repro.configs.base import FedConfig as JaxFedConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.core.api import FederatedTrainer as JaxTrainer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.api import FederatedTrainer
    kw = _cfg("b", ef_store=True)
    defs, jloss, data = make_problem("mlp", M)
    jt = JaxTrainer(fed=JaxFedConfig(**kw), train=JaxTrainConfig(),
                    loss_fn=jloss, init_params=staged_init(defs))
    jt.data = data
    jt.run(3, batch_size=8, scan_rounds=3, log=None)
    tt = FederatedTrainer(
        fed=FedConfig(**kw), train=TrainConfig(), loss_fn=_port_loss("mlp"),
        init_params=params_from_jax(jax.device_get(staged_init(defs))),
        device="cpu")
    tt.data = data
    prefetched = []
    prefetch = tt._sim._efs.__class__.prefetch

    def recording(store, idx):
        prefetched.append(np.array(idx))
        return prefetch(store, idx)

    monkeypatch.setattr(tt._sim._efs.__class__, "prefetch", recording)
    tt.run(3, batch_size=8, scan_rounds=3, log=None)
    assert len(prefetched) == 2          # rounds 1 and 2, ahead of time
    jt.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    mj, mt = (json.load(open(tmp_path / w / "manifest.json"))
              for w in ("jax", "port"))
    assert mj == mt
    assert tuple(tt._state.errors.shape) == (N, tt._state.params.numel())
    tree, meta = jax_load(str(tmp_path / "port"),
                          jax.device_get(jt._state._asdict()))
    assert meta["round"] == 3
    np.testing.assert_array_equal(np.asarray(tree["errors"]),
                                  tt._state.errors.numpy())
