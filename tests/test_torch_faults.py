"""Fault-tolerant rounds in the port against the JAX package: the copied
fault model and planner (bitwise), the wire damage and the server's
validation before ingest (bitwise but for the norm clip), the
survivor-masked aggregate, and whole FedSim fault rounds on staged ids,
batches and init (verdicts and host counters equal, losses within
``LOSS_RTOL``); the EF rollback against a snapshot and the all-ones plan
against the port's own fault-free round, bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.comm import faults as jf
from repro.comm.transport import NetworkConfig as JaxNetworkConfig
from repro.comm.transport import SimulatedNetwork as JaxNetwork
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import stages as jstages
from repro.core.sim import FedSim as JaxSim
from repro_torch.comm import faults as tf
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import stages as tstages
from repro_torch.core.sim import FedSim
from test_torch_sim import (EXACT_KEYS, LOSS_RTOL, M, N, _port_loss,
                            _staged_rounds, staged_init)

torch.set_num_threads(1)

#: the norm clip's bound, relative: the sum of squares runs in another
#: order than XLA's (a few ulp of the norm), and the sqrt and the division
#: are correctly rounded on both sides
CLIP_RTOL = 1e-6

BAD_FAULTS = [    # tests/test_faults.py::test_faultconfig_rejects_bad_values
    dict(crash_prob=1.5), dict(crash_prob=-0.1), dict(corrupt_prob=2.0),
    dict(corrupt_mode="zap"), dict(deadline_s=-1.0),
    dict(max_update_norm=-2.0), dict(crash_trace=((0, 5, 1),)),
    dict(crash_trace=((-1, 0, 1),)),
]


@pytest.mark.parametrize("kw", BAD_FAULTS)
def test_faultconfig_validation_matches(kw):
    with pytest.raises(ValueError) as jax_err:
        jf.FaultConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        tf.FaultConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_fault_model_copies_match():
    fields = lambda cls: [(f.name, f.default)
                          for f in dataclasses.fields(cls)]
    assert fields(tf.FaultConfig) == fields(jf.FaultConfig)
    assert tf.FaultPlan._fields == jf.FaultPlan._fields
    assert tf.FAULT_CORRUPT_MODES == jf.FAULT_CORRUPT_MODES
    assert tf.INVALID_IDX == jf.INVALID_IDX
    assert tf.INVALID_IDX.dtype == jf.INVALID_IDX.dtype
    for kw in (dict(), dict(crash_prob=0.1), dict(max_update_norm=1.0)):
        assert tf.FaultConfig(**kw).any_faults == \
            jf.FaultConfig(**kw).any_faults


_BASE = dict(algorithm="fedcams", compressor="blocktopk",
             compress_ratio=1 / 8, track_gamma=False)


@pytest.mark.parametrize("kw", [
    dict(fault="ok"), dict(deadline_s=1.0, wire=True),
    dict(fault="ok", track_gamma=True), dict(deadline_s=1.0),
    dict(deadline_s=1.0, track_gamma=True, wire=True),
    dict(fault=dict(deadline_s=2.0)),
    dict(deadline_s=1.0, wire=True, fault=dict(deadline_s=2.0)),
    dict(fault="ok", agg_groups=2), dict(fault="ok", client_chunk=2),
    dict(fault={"crash_prob": 0.5}),
    dict(fault=dict(deadline_s=1.0), wire=True, async_buffer=2,
         participating=4),
])
def test_fedconfig_fault_validation_matches(kw):
    """``FedConfig`` with a fault plan or a deadline, message for message
    (the cases of tests/test_faults.py::test_fedconfig_fault_validation,
    and a fault deadline beside the async buffer); a dict stands for the
    ``FaultConfig`` of each package, the string "ok" for the default one,
    and a raw dict under ``{"crash_prob": ...}`` is refused by type."""
    def build(cfg_cls, fault_cls):
        args = dict(_BASE, **kw)
        fault = args.get("fault")
        if fault == "ok":
            args["fault"] = fault_cls()
        elif isinstance(fault, dict) and "crash_prob" not in fault:
            args["fault"] = fault_cls(**fault)
        return cfg_cls(**args)

    try:
        build(JaxFedConfig, jf.FaultConfig)
    except ValueError as e:
        with pytest.raises(ValueError) as port_err:
            build(FedConfig, tf.FaultConfig)
        assert str(port_err.value) == str(e)
    else:
        cfg = build(FedConfig, tf.FaultConfig)
        assert cfg.fault is None or isinstance(cfg.fault, tf.FaultConfig)


# -- the planner -----------------------------------------------------------------


PLANS = {
    "crash": dict(crash_prob=0.3, seed=7),
    "trace": dict(crash_trace=((3, 1, 4), (11, 0, 99), (5, 2, 2))),
    "corrupt": dict(corrupt_prob=0.5, corrupt_mode="bitflip", seed=2),
    "deadline": dict(deadline_s=0.12, crash_prob=0.2, corrupt_prob=0.3,
                     corrupt_mode="truncate", seed=9),
    "everything": dict(crash_prob=0.2, crash_trace=((0, 0, 3),),
                       corrupt_prob=0.4, deadline_s=0.2, seed=4),
}


@pytest.mark.parametrize("name", PLANS)
def test_injector_plans_what_the_jax_planner_plans(name):
    """The same plan and info, bit for bit, over resampled cohorts and
    rounds; timings from the JAX network (deadline configs only)."""
    cfg = PLANS[name]
    jinj = jf.FaultInjector(jf.FaultConfig(**cfg), 30)
    tinj = tf.FaultInjector(tf.FaultConfig(**cfg), 30)
    net = JaxNetwork(JaxNetworkConfig(straggler_prob=0.3, seed=1), 30)
    r = np.random.default_rng(0)
    events = 0
    for rnd in range(8):
        ids = r.choice(30, size=8, replace=False)
        timing = (net.round(ids, 3000, 90000, rnd)
                  if cfg.get("deadline_s") else None)
        (jp, ji), (tp, ti) = (jinj.plan(ids, rnd, timing),
                              tinj.plan(ids, rnd, timing))
        assert ji == ti
        for a, b in zip(jp, tp):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        events += ti["crashed"] + ti["deadline_cut"] + tp.corrupt.sum()
    assert events > 0


def test_injector_refuses_a_deadline_without_timing():
    inj = tf.FaultInjector(tf.FaultConfig(deadline_s=1.0), 4)
    with pytest.raises(ValueError, match="RoundTiming"):
        inj.plan(np.arange(4), 0)


# -- wire damage and validation ----------------------------------------------------


def _plan(n, mode, seed=0):
    cfg = dict(corrupt_prob=0.6, corrupt_mode=mode, seed=seed)
    plan, _ = jf.FaultInjector(jf.FaultConfig(**cfg), 64).plan(
        np.arange(n), 3)
    assert plan.corrupt.any() and not plan.corrupt.all()
    return plan


def _jplan(plan):
    return jf.FaultPlan(*(jnp.asarray(a) for a in plan))


def _same(got, want):
    """Bitwise, a NaN meeting a NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        got, want = got.view(np.int32), want.view(np.int32)
        keep = ~np.isnan(np.asarray(want).view(np.float32))
        got, want = got[keep], want[keep]
    np.testing.assert_array_equal(got, want)


def _close(got, want, rtol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("max_norm", [0.0, 0.5])
@pytest.mark.parametrize("mode", tf.FAULT_CORRUPT_MODES)
def test_selection_damage_and_validation_match_jax(mode, max_norm):
    """``corrupt_selection`` then ``validate_selection`` on the same numpy
    selections (padded-tail indices in [d, nb·bs), a client already NaN):
    the damaged values and indices and the verdicts bitwise; the validated
    values bitwise without the clip, within ``CLIP_RTOL`` with it."""
    n, k, d, domain = 9, 24, 700, 768
    r = np.random.default_rng(1)
    vals = (r.standard_normal((n, k)) * 0.3).astype(np.float32)
    vals[2, 5] = np.nan
    idx = np.sort(r.choice(domain, size=(n, k)), axis=1).astype(np.int32)
    idx[:, -1] = r.integers(d, domain, size=n)   # padded tail: legitimate
    plan = _plan(n, mode)
    jv, ji = jf.corrupt_selection(jnp.asarray(vals), jnp.asarray(idx),
                                  _jplan(plan), mode)
    tv, ti = tf.corrupt_selection(torch.from_numpy(vals),
                                  torch.from_numpy(idx),
                                  tf.plan_to_device(plan, "cpu"), mode)
    _same(tv.numpy(), jv)
    _same(ti.numpy(), ji)
    jvv, jvalid = jf.validate_selection(jv, ji, domain, max_norm)
    tvv, tvalid = tf.validate_selection(tv, ti, domain, max_norm)
    _same(tvalid.numpy(), jvalid)
    assert 0 < float(tvalid.sum()) < n
    if max_norm:
        _close(tvv.numpy(), np.asarray(jvv), CLIP_RTOL)
        clipped = np.linalg.norm(np.asarray(jvv), axis=1)
        assert (np.abs(clipped[np.asarray(jvalid) > 0] - max_norm)
                < 1e-5).any()
    else:
        _same(tvv.numpy(), jvv)


@pytest.mark.parametrize("max_norm", [0.0, 2.0])
@pytest.mark.parametrize("mode", tf.FAULT_CORRUPT_MODES)
def test_dense_damage_and_validation_match_jax(mode, max_norm):
    """``corrupt_dense`` then ``validate_dense`` (with the length check
    under ``truncate``) on the same (n, d) hats, as ``repro.core.sim``'s
    fault round calls them: bitwise, the clip within ``CLIP_RTOL``."""
    n, d = 7, 333
    r = np.random.default_rng(2)
    hats = (r.standard_normal((n, d)) * 0.2).astype(np.float32)
    hats[4, 7] = np.inf
    plan = _plan(n, mode, seed=1)
    jh = jf.corrupt_dense(jnp.asarray(hats), _jplan(plan), mode)
    th = tf.corrupt_dense(torch.from_numpy(hats),
                          tf.plan_to_device(plan, "cpu"), mode)
    _same(th.numpy(), jh)
    trunc = plan.corrupt if mode == "truncate" else None
    jvh, jvalid = jf.validate_dense(
        jh, max_norm, None if trunc is None else jnp.asarray(trunc))
    tvh, tvalid = tf.validate_dense(
        th, max_norm, None if trunc is None else torch.from_numpy(trunc))
    _same(tvalid.numpy(), jvalid)
    if max_norm:
        _close(tvh.numpy(), np.asarray(jvh), CLIP_RTOL)
    else:
        _same(tvh.numpy(), jvh)


@pytest.mark.parametrize("surv", ["mixed", "all", "none"])
def test_masked_aggregate_matches_jax(surv):
    """``server_aggregate_sparse_masked`` on colliding client selections
    with padded-tail, ``INVALID_IDX`` and flipped indices and a NaN in a
    dead client: bitwise the JAX stage; with all survivors bitwise the
    plain aggregate, with none all zeros."""
    n, k, d = 6, 40, 500
    r = np.random.default_rng(3)
    vals = r.standard_normal((n, k)).astype(np.float32)
    idx = r.integers(0, 512, size=(n, k)).astype(np.int32)
    for c in range(n):
        idx[c] = r.choice(512, size=k, replace=False)
    mask = {"mixed": [1, 0, 1, 1, 0, 1], "all": [1] * n,
            "none": [0] * n}[surv]
    mask = np.asarray(mask, np.float32)
    if surv != "all":
        dead = int(np.flatnonzero(mask == 0)[0])
        vals[dead, 3] = np.nan
        idx[dead, 0] = jf.INVALID_IDX
        idx[dead, 1] ^= 1 << 29
    want = jstages.server_aggregate_sparse_masked(
        jnp.asarray(vals), jnp.asarray(idx), d, jnp.asarray(mask))
    got = tstages.server_aggregate_sparse_masked(
        torch.from_numpy(vals), torch.from_numpy(idx), d,
        torch.from_numpy(mask))
    _same(got.numpy(), want)
    if surv == "all":
        plain = tstages.server_aggregate_sparse(
            torch.from_numpy(vals), torch.from_numpy(idx), d, n)
        _same(got.numpy(), plain.numpy())
    if surv == "none":
        assert not got.any()


# -- whole fault rounds ------------------------------------------------------------


ROUNDS = 6
#: FedSim fault configurations: (FedConfig knobs, FaultConfig knobs)
FAULT_ROUNDS = {
    "sparse-bitflip": (dict(), dict(crash_prob=0.25, corrupt_prob=0.3,
                                    corrupt_mode="bitflip", seed=3)),
    "sparse-truncate-clip": (dict(), dict(
        crash_prob=0.15, crash_trace=((7, 0, 3),), corrupt_prob=0.3,
        corrupt_mode="truncate", max_update_norm=0.05, seed=1)),
    "dense-sign-nan": (dict(compressor="sign"), dict(
        crash_prob=0.2, corrupt_prob=0.3, corrupt_mode="nan", seed=1)),
    "dense-topk-inf-clip": (dict(sparse_uplink=False), dict(
        crash_prob=0.2, corrupt_prob=0.3, corrupt_mode="inf",
        max_update_norm=0.05, seed=2)),
    "wire-sparse-deadline": (dict(wire=True), dict(
        crash_prob=0.1, corrupt_prob=0.2, corrupt_mode="bitflip",
        deadline_s=0.14, seed=5)),
    "wire-sign-deadline": (dict(compressor="sign", wire=True,
                                deadline_s=0.14), dict(
        crash_prob=0.1, corrupt_prob=0.3, corrupt_mode="truncate", seed=6)),
}
VERDICTS = ("survivors", "rejected", "crashed", "deadline_cut")


def _fault_kw(fed_kw, fault_kw):
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=2, num_clients=M, participating=N,
              compressor="blocktopk", track_gamma=False)
    kw.update(fed_kw)
    return kw, fault_kw


@pytest.mark.parametrize("name", FAULT_ROUNDS)
def test_fault_rounds_track_jax_fedsim(name):
    """Six MLP rounds of each fault configuration on both packages with the
    same staged ids, batches and init: every round's survivors, rejected,
    crashed and deadline_cut, ``bits`` and the wire counters (delivered
    uplink bytes, the deadline-truncated ``round_time_s``) equal; losses
    within ``LOSS_RTOL``; and the run holds a crash or a cut and a
    rejection, so the verdicts are not all trivially equal."""
    kw, fkw = _fault_kw(*FAULT_ROUNDS[name])
    defs, jloss, data = make_problem("mlp", M)
    p0 = staged_init(defs)
    js = JaxSim(jloss, JaxFedConfig(**kw, fault=jf.FaultConfig(**fkw)))
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw,
                                             fault=tf.FaultConfig(**fkw)),
                device="cpu")
    assert ts._fused == js._fused == "off"
    jst, tst = js.init(p0), ts.init(params_from_jax(jax.device_get(p0)))
    seen = dict.fromkeys(VERDICTS, 0.0)
    for idx, b, key in _staged_rounds(data, ROUNDS):
        jst, jm = js.round(jst, jax.tree.map(jnp.asarray, b),
                           jnp.asarray(idx), key)
        tst, tm = ts.round(tst, b, idx)
        assert set(tm) == set(jm)
        for k in VERDICTS:
            assert float(tm[k]) == float(jm[k]), k
            seen[k] += float(tm[k])
        for k in EXACT_KEYS:
            if k in jm:
                assert tm[k] == jm[k], k
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(tm["survivors"]) + tm["crashed"] + tm["deadline_cut"] \
            + float(tm["rejected"]) == N
    assert seen["rejected"] > 0
    assert seen["crashed"] + seen["deadline_cut"] > 0
    if "deadline" in name:
        assert seen["deadline_cut"] > 0
    assert torch.isfinite(tst.params).all() and torch.isfinite(
        tst.errors).all()
    jflat = np.asarray(jax.flatten_util.ravel_pytree(jst.params)[0])
    np.testing.assert_allclose(tst.params.numpy(), jflat, atol=1e-4)


@pytest.mark.parametrize("name", ["sparse-bitflip", "dense-sign-nan",
                                  "wire-sign-deadline"])
def test_rollback_restores_the_pre_round_rows(name):
    """After each fault round the EF rows of the clients the server did not
    ingest equal a snapshot taken before the round, bit for bit (the
    uplink updated them in place first); the survivors' rows moved."""
    kw, fkw = _fault_kw(*FAULT_ROUNDS[name])
    defs, _, data = make_problem("mlp", M)
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw,
                                             fault=tf.FaultConfig(**fkw)),
                device="cpu")
    st = ts.init(params_from_jax(jax.device_get(staged_init(defs))))
    bits = lambda t: t.view(torch.int32)
    dead_rows = 0
    for idx, b, _ in _staged_rounds(data, ROUNDS):
        before = st.errors.clone()
        plan, _ = ts.faults.plan(idx, st.round, ts._round_timing(idx,
                                                                 st.round))
        st, met = ts.round(st, b, idx)
        same = [torch.equal(bits(st.errors[i]), bits(before[i])) for i in idx]
        # crashed and cut clients keep their rows, and so do the rejected
        # ones: exactly the validated survivors' rows moved
        assert all(s for s, alive in zip(same, plan.survivors) if not alive)
        assert same.count(False) == float(met["survivors"])
        dead_rows += same.count(True)
        others = np.setdiff1d(np.arange(M), idx)
        assert torch.equal(bits(st.errors[others]), bits(before[others]))
    assert dead_rows > 0


@pytest.mark.parametrize("fed_kw", [
    dict(), dict(compressor="sign"), dict(sparse_uplink=False),
    dict(wire=True), dict(compressor="sign", wire=True)],
    ids=["sparse", "sign", "topk-dense", "sparse-wire", "sign-wire"])
def test_all_ones_plan_is_the_fault_free_round(fed_kw):
    """``FaultConfig()`` (no crash, no corruption, no deadline) against no
    fault model, both on the two-pass server path: params, EF, server
    state and losses equal to the bit over 4 rounds, and every client a
    survivor."""
    kw, _ = _fault_kw(fed_kw, {})
    kw["fused_ingest"] = "off"
    defs, _, data = make_problem("mlp", M)
    p0 = params_from_jax(jax.device_get(staged_init(defs)))
    sims = [FedSim(_port_loss("mlp"), FedConfig(**kw, fault=fault),
                   device="cpu") for fault in (None, tf.FaultConfig())]
    sts = [s.init(p0) for s in sims]
    for idx, b, _ in _staged_rounds(data, 4):
        outs = [s.round(st, b, idx) for s, st in zip(sims, sts)]
        sts = [o[0] for o in outs]
        (a, ma), (f, mf) = outs
        assert float(mf["survivors"]) == N and float(mf["rejected"]) == 0
        assert float(ma["loss"]) == float(mf["loss"])
        for x, y in ((a.params, f.params), (a.errors, f.errors),
                     (a.opt.m, f.opt.m), (a.opt.v, f.opt.v),
                     (a.opt.vhat, f.opt.vhat), (a.x_client, f.x_client)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        for k in EXACT_KEYS:
            if k in ma:
                assert ma[k] == mf[k], k
