"""The async buffered engine in the port against the JAX package: the
staleness rules and the weighted aggregate (bitwise), the buffer == cohort
anchor against the port's own sync round (bitwise), buffered runs with
B < n, faults and a custom weight rule against the JAX async run on staged
ids, batches and init (flushes, staleness, fills, bits, wire counters and
verdicts equal; losses within ``LOSS_RTOL``; params within 1e-4, the
bound the other trajectory tests use), EF repayment across in-flight
dispatches, and the trainer's async route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as jax_api
import repro_torch.core.api as port_api
from benchmarks.common import make_problem
from repro.comm import async_engine as jasync
from repro.comm import faults as jf
from repro.comm.transport import NetworkConfig as JaxNetworkConfig
from repro.comm.transport import SimulatedNetwork as JaxNetwork
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import stages as jstages
from repro.core.api import FederatedTrainer as JaxTrainer
from repro.core.sim import FedSim as JaxSim
from repro_torch.comm import async_engine as tasync
from repro_torch.comm import faults as tf
from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import stages as tstages
from repro_torch.core.api import FederatedTrainer
from repro_torch.core.sim import FedSim
from test_torch_sim import (LOSS_RTOL, M, N, _port_loss, _staged_rounds,
                            staged_init)

torch.set_num_threads(1)

pytestmark = pytest.mark.async_rounds

PARAMS_ATOL = 1e-4
#: per-flush metrics held equal to the JAX engine's
FLUSH_KEYS = ("staleness_mean", "staleness_max", "buffer_fill", "bits",
              "survivors", "crashed", "rejected", "wire_up_bytes",
              "wire_up_bytes_attempted", "wire_down_bytes", "wire_bytes",
              "round_time_s", "sim_time_s", "weight_sum")


def _kw(**extra):
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=2, num_clients=M, participating=N,
              compressor="blocktopk", compress_ratio=1 / 8,
              track_gamma=False, wire=True)
    kw.update(extra)
    return kw


def _configs(kw, fault):
    return (JaxFedConfig(**kw, fault=fault and jf.FaultConfig(**fault)),
            FedConfig(**kw, fault=fault and tf.FaultConfig(**fault)))


def _staged(rounds):
    defs, jloss, data = make_problem("mlp", M)
    staged = _staged_rounds(data, rounds)
    ids = np.stack([s[0] for s in staged])
    batches = {k: np.stack([s[1][k] for s in staged]) for k in staged[0][1]}
    keys = jnp.stack([s[2] for s in staged])
    return defs, jloss, ids, batches, keys


def _run_port(kw, rounds, net=None, fault=None):
    """The port's run of ``rounds`` staged cohorts: run_rounds (the async
    engine, or the sync loop without async_buffer)."""
    defs, _, ids, batches, _ = _staged(rounds)
    ts = FedSim(_port_loss("mlp"), _configs(kw, fault)[1],
                network=SimulatedNetwork(NetworkConfig(**(net or {})), M),
                device="cpu")
    st = ts.init(params_from_jax(jax.device_get(staged_init(defs))))
    st, mets = ts.run_rounds(st, batches, ids)
    return ts, st, mets


def _run_both(kw, rounds, net, fault=None, weight_fn=None):
    defs, jloss, ids, batches, keys = _staged(rounds)
    jfed, tfed = _configs(kw, fault)
    p0 = staged_init(defs)
    js = JaxSim(jloss, jfed, network=JaxNetwork(JaxNetworkConfig(**net), M))
    ts = FedSim(_port_loss("mlp"), tfed,
                network=SimulatedNetwork(NetworkConfig(**net), M),
                device="cpu")
    if weight_fn is not None:
        js._async = jasync.AsyncRoundEngine(js, weight_fn=weight_fn)
        ts._async = tasync.AsyncRoundEngine(ts, weight_fn=weight_fn)
    jst, jm = js.run_rounds(js.init(p0), jax.tree.map(jnp.asarray, batches),
                            jnp.asarray(ids), keys)
    tst, tm = ts.run_rounds(ts.init(params_from_jax(jax.device_get(p0))),
                            batches, ids)
    return js, jst, jm, ts, tst, tm


def _assert_tracks(jst, jm, tst, tm):
    assert len(tm) == len(jm)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        for key in FLUSH_KEYS:
            assert float(t[key]) == float(j[key]), key
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]),
                                   rtol=LOSS_RTOL)
    jflat = np.asarray(jax.flatten_util.ravel_pytree(jst.params)[0])
    np.testing.assert_allclose(tst.params.numpy(), jflat, rtol=0,
                               atol=PARAMS_ATOL)
    assert (tst.bits, tst.round) == (jst.bits, jst.round)


# -- the staleness rules and the weighted aggregate ---------------------------


@pytest.mark.parametrize("rule", sorted(jasync.STALENESS_WEIGHTS))
def test_staleness_rules_equal_the_originals(rule):
    tau = np.concatenate([np.arange(0.0, 40.0), [63.0, 100.0, 1e3]])
    want = jasync.resolve_staleness_weight(rule)(tau)
    got = tasync.resolve_staleness_weight(rule)(tau)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.float32(got[0]) == 1.0
    assert sorted(tasync.STALENESS_WEIGHTS) == sorted(
        jasync.STALENESS_WEIGHTS)
    with pytest.raises(ValueError) as jerr:
        jasync.resolve_staleness_weight("cubic")
    with pytest.raises(ValueError) as terr:
        tasync.resolve_staleness_weight("cubic")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["staleness", "nan at weight 0",
                                  "partial flush", "unit"])
def test_weighted_aggregate_is_bitwise_the_jax_function(case):
    """Random selections with collisions and padded-tail indices, weighted
    as a flush weights them: staleness weights; a rejected entry with NaN
    values and a flipped index at weight 0; a partial flush's empty slots
    (idx 0, vals 0, weight 0); unit weights, where it is also bitwise the
    plain scatter-mean."""
    n, k, d = 5, 40, 500
    r = np.random.default_rng(4)
    vals = r.standard_normal((n, k)).astype(np.float32)
    idx = np.stack([r.choice(512, size=k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    w = (1.0 / np.sqrt(1.0 + np.array([0, 1, 2, 3, 7.0]))).astype(np.float32)
    if case == "nan at weight 0":
        vals[2, 3] = np.nan
        idx[2, 0] ^= 1 << 29
        w[2] = 0.0
    elif case == "partial flush":
        vals[3:], idx[3:], w[3:] = 0.0, 0, 0.0
    elif case == "unit":
        w[:] = 1.0
    want = np.asarray(jstages.server_aggregate_sparse_weighted(
        jnp.asarray(vals), jnp.asarray(idx), d, jnp.asarray(w)))
    got = tstages.server_aggregate_sparse_weighted(
        torch.from_numpy(vals), torch.from_numpy(idx), d,
        torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(got).all()
    if case == "unit":
        plain = tstages.server_aggregate_sparse(
            torch.from_numpy(vals), torch.from_numpy(idx), d, n)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      plain.numpy().view(np.uint32))


# -- the anchor: B == n is the sync round --------------------------------------


@pytest.mark.parametrize("staleness", ["uniform", "inv_sqrt"])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_buffer_equals_cohort_is_bitwise_sync(staleness, fused):
    """async_buffer == n with unit weights (w(0) = 1 under every rule): each
    flush is bitwise the port's sync round — params, m, v, v̂, every EF row
    and x_client — on the fused ingest and the two-pass server; one flush a
    cohort, bits, losses and wire bytes equal; round_time_s is the event
    clock's (t0 + t) − t0, within 1e-12 of the slowest client's t."""
    rounds = 5
    net = dict(straggler_prob=0.3, seed=3)
    ss, st_s, h_s = _run_port(_kw(fused_ingest=fused), rounds, net)
    sa, st_a, h_a = _run_port(_kw(fused_ingest=fused, async_buffer=N,
                                  staleness_weight=staleness), rounds, net)
    assert sa._async is not None and ss._async is None
    assert ss._fused == sa._fused == ("jnp" if fused == "auto" else "off")
    for name in ("params", "errors", "x_client", "server_error"):
        assert torch.equal(getattr(st_a, name), getattr(st_s, name)), name
    for name in ("m", "v", "vhat", "t"):
        assert torch.equal(getattr(st_a.opt, name),
                           getattr(st_s.opt, name)), name
    assert (st_a.bits, st_a.round) == (st_s.bits, st_s.round)
    assert len(h_a) == len(h_s) == rounds
    for s, a in zip(h_s, h_a):
        assert float(a["loss"]) == float(s["loss"])
        for key in ("bits", "wire_up_bytes", "wire_down_bytes"):
            assert a[key] == s[key], key
        assert a["round_time_s"] == pytest.approx(s["round_time_s"],
                                                  rel=1e-12)
        assert a["staleness_max"] == 0.0 and a["buffer_fill"] == float(N)
        assert float(a["weight_sum"]) == float(N)


# -- B < n against the JAX async run -------------------------------------------


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_buffered_run_tracks_the_jax_async_run(fused):
    """B = 2 of n = 4 under 30 % stragglers, inv_sqrt weights, 6 cohorts:
    12 flushes, some stale, on both packages; every flush's staleness,
    fill, weight sum, bits, wire counters and simulated times equal."""
    kw = _kw(async_buffer=2, staleness_weight="inv_sqrt",
             fused_ingest=fused)
    js, jst, jm, ts, tst, tm = _run_both(kw, 6, dict(straggler_prob=0.3,
                                                     seed=3))
    assert ts._fused == js._fused
    assert len(tm) == 12 and max(m["staleness_max"] for m in tm) > 0
    assert any(float(m["weight_sum"]) < m["buffer_fill"] for m in tm)
    _assert_tracks(jst, jm, tst, tm)


@pytest.mark.parametrize("mode", ["bitflip", "nan"])
def test_fault_verdicts_equal_the_jax_async_run(mode):
    """Crashes (never delivered: fewer deliveries, a partial last flush)
    and corrupted payloads (rejected at the flush): per flush the fill,
    crashed, rejected and survivors equal the JAX engine's."""
    kw = _kw(async_buffer=3, staleness_weight="inv_sqrt")
    fault = dict(crash_prob=0.25, corrupt_prob=0.3, corrupt_mode=mode,
                 seed=2)
    js, jst, jm, ts, tst, tm = _run_both(kw, 8, dict(straggler_prob=0.2,
                                                     seed=3), fault)
    assert ts._fused == js._fused == "off"
    assert sum(m["crashed"] for m in tm) > 0
    assert sum(float(m["rejected"]) for m in tm) > 0
    delivered = sum(m["buffer_fill"] for m in tm)
    assert len(tm) == int(np.ceil(delivered / 3))
    _assert_tracks(jst, jm, tst, tm)
    for name in ("params", "errors"):
        assert torch.isfinite(getattr(tst, name)).all()


def test_weight_fn_override_tracks_the_jax_engine():
    """A custom rule (stale work dropped) on both engines: the same calls'
    weights, so the same weight sums, flush for flush."""
    calls = {"jax": [], "port": []}

    def dropping(side):
        def wf(tau):
            calls[side].append(tau.copy())
            return np.where(tau > 0, 0.0, 1.0)
        return wf

    kw = _kw(async_buffer=2)
    net = dict(straggler_prob=0.4, seed=3)
    defs, jloss, ids, batches, keys = _staged(6)
    p0 = staged_init(defs)
    js = JaxSim(jloss, JaxFedConfig(**kw),
                network=JaxNetwork(JaxNetworkConfig(**net), M))
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw),
                network=SimulatedNetwork(NetworkConfig(**net), M),
                device="cpu")
    js._async = jasync.AsyncRoundEngine(js, weight_fn=dropping("jax"))
    ts._async = tasync.AsyncRoundEngine(ts, weight_fn=dropping("port"))
    jst, jm = js.run_rounds(js.init(p0), jax.tree.map(jnp.asarray, batches),
                            jnp.asarray(ids), keys)
    tst, tm = ts.run_rounds(ts.init(params_from_jax(jax.device_get(p0))),
                            batches, ids)
    assert len(calls["port"]) == len(calls["jax"]) == len(tm)
    for a, b in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(a, b)
    stale = [m for m in tm if m["staleness_max"] > 0]
    assert stale and all(float(m["weight_sum"]) < m["buffer_fill"]
                         for m in stale)
    _assert_tracks(jst, jm, tst, tm)


# -- EF across in-flight dispatches, the trainer, the refusal ------------------


def test_ef_residual_repays_on_the_next_dispatch():
    """A client's residual booked at dispatch r shifts its selection at
    dispatch r + 1, while the first payload is still in flight: against a
    twin whose client 0 row was zeroed in between, client 0's second
    payload differs and every other client's is bitwise the same."""
    defs, _, ids, batches, _ = _staged(2)
    ts = FedSim(_port_loss("mlp"), FedConfig(**_kw(async_buffer=N)),
                device="cpu")
    st = ts.init(params_from_jax(jax.device_get(staged_init(defs))))
    rows = torch.as_tensor(ids[0])
    b = [{k: torch.as_tensor(v[r]) for k, v in batches.items()}
         for r in range(2)]
    ts._async_dispatch(st.errors, st.x_client, b[0], rows, 0, None)
    assert st.errors[rows].abs().sum() > 0          # residual booked
    twin = st.errors.clone()
    twin[rows[0]] = 0.0
    v, i, _ = ts._async_dispatch(st.errors.clone(), st.x_client, b[1], rows,
                                 1, None)
    vz, iz, _ = ts._async_dispatch(twin, st.x_client, b[1], rows, 1, None)
    assert not (torch.equal(v[0], vz[0]) and torch.equal(i[0], iz[0]))
    assert torch.equal(v[1:], vz[1:]) and torch.equal(i[1:], iz[1:])


def test_trainer_routes_async_and_tracks_the_jax_trainer(monkeypatch):
    """``FederatedTrainer.run`` under async_buffer stages the whole run and
    records one row a flush; on the JAX trainer's ids (its sampler
    recorded, the port's patched to replay them) the rows track the JAX
    trainer's."""
    ids = []
    orig = jax_api.sample_clients

    def recording(key, m, n):
        out = orig(key, m, n)
        ids.append(np.array(out))
        return out

    monkeypatch.setattr(jax_api, "sample_clients", recording)
    kw = _kw(async_buffer=2)
    net = dict(straggler_prob=0.3, seed=3)
    defs, jloss, data = make_problem("mlp", M)
    jt = JaxTrainer(fed=JaxFedConfig(**kw), train=JaxTrainConfig(),
                    loss_fn=jloss, init_params=staged_init(defs),
                    network=JaxNetwork(JaxNetworkConfig(**net), M))
    jt.data = data
    jhist = jt.run(6, batch_size=8, log=None)
    replay = iter(ids)
    monkeypatch.setattr(port_api, "sample_clients",
                        lambda gen, m, n: torch.tensor(next(replay)))
    tt = FederatedTrainer(
        fed=FedConfig(**kw), train=TrainConfig(), loss_fn=_port_loss("mlp"),
        init_params=params_from_jax(jax.device_get(staged_init(defs))),
        network=SimulatedNetwork(NetworkConfig(**net), M), device="cpu")
    tt.data = data
    thist = tt.run(6, batch_size=8, log=None)
    assert len(thist) == len(jhist) == 12        # flushes, not cohorts
    for j, t in zip(jhist, thist):
        assert set(t) == set(j)
        for key in FLUSH_KEYS + ("round",):
            assert t[key] == j[key], key
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
    assert thist[-1]["sim_time_s"] == pytest.approx(
        sum(h["round_time_s"] for h in thist), abs=1e-9)


def test_round_refuses_under_async_as_jax_does():
    defs, jloss, ids, batches, keys = _staged(1)
    kw = _kw(async_buffer=2)
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw), device="cpu")
    p0 = staged_init(defs)
    b0 = {k: v[0] for k, v in batches.items()}
    with pytest.raises(ValueError) as jerr:
        js.round(js.init(p0), jax.tree.map(jnp.asarray, b0),
                 jnp.asarray(ids[0]), keys[0])
    with pytest.raises(ValueError) as terr:
        ts.round(ts.init(params_from_jax(jax.device_get(p0))), b0, ids[0])
    assert str(terr.value) == str(jerr.value)
    assert "run_rounds" in str(terr.value)
