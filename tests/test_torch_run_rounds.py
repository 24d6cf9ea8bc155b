"""``FedSim.run_rounds``, the port's counterpart of the reference's
``lax.scan`` over rounds: R rounds staged on the host up front, then one
body run round after round on a static carry, reading its round's inputs
at a round counter on the device (on CUDA captured once into a CUDA graph
and replayed; here, on the CPU, run eagerly).

The staged body is held to R eager calls of ``FedSim.round`` (under
``repro_torch.disable_graphs``: outside it ``round`` runs its own program)
on the same inputs, state and per-round metrics ``torch.equal``, in the
nine configurations of
``tests/test_scan_driver.py::test_scan_driver_bit_identical_to_loop`` and in
more (faults, randk, the fused ingest kernel's twin, narrowed state and wire
values, grouped aggregation). A ``TorchDispatchMode`` around the body
(``tests/host_reads.py``) refuses every host read
(``aten::_local_scalar_dense``, ``is_nonzero``, ``nonzero``, a copy to
another device), so a body that passes here has no host sync to break a
capture on the card. One case tracks the JAX
``FedSim.run_rounds`` from a numpy-staged init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from host_reads import NoHostReads
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core.sim import FedSim as JaxSim
from repro_torch import disable_graphs
from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.sim import FedSim
from repro_torch.data.synthetic import FederatedClassification
from repro_torch.models import convmixer as cm
from repro_torch.models.params import init_params
from test_torch_sim import (LOSS_RTOL, _port_loss, _staged_rounds,
                            staged_init)
from test_torch_sim import M as SIM_M
from test_torch_sim import N as SIM_N

torch.set_num_threads(1)

MC = cm.MLPConfig(in_dim=16, hidden=32, depth=2, num_classes=4)
DATA = FederatedClassification(num_clients=12, num_classes=4, feature_dim=16,
                               alpha=0.5, seed=0)
M, N, K, R, B = 12, 4, 2, 5, 16

@pytest.fixture
def no_host_reads(monkeypatch):
    """Every run of the round body under :class:`NoHostReads`; yields the
    list of the programs the body ran for."""
    body = FedSim._rounds_body
    seen = []

    def guarded(self, prog):
        seen.append(prog)
        with NoHostReads():
            return body(self, prog)

    monkeypatch.setattr(FedSim, "_rounds_body", guarded)
    return seen


def _fault(kind: str):
    if kind == "h":     # chip_smoke.py route h's knobs, raised for 5 rounds
        return FaultConfig(crash_prob=0.3, corrupt_prob=0.4,
                           corrupt_mode="bitflip", deadline_s=1.0, seed=3)
    first = int(_stage(1)[0][0, 0])     # route i's: round 0's first client
    return FaultConfig(crash_trace=((first, 0, 3),), corrupt_prob=0.4,
                       corrupt_mode="nan", max_update_norm=0.05, seed=3)


#: the nine configurations of test_scan_driver_bit_identical_to_loop
SCAN_CASES = {
    "default": {}, "wire": {"wire": True},
    "wire-two-way": {"wire": True, "two_way": True},
    "sign": {"compressor": "sign"}, "sgdm": {"local_opt": "sgdm"},
    "prox": {"local_opt": "prox"}, "eta-decay": {"eta_l_decay": 0.9},
    "hetero": {"local_steps_min": 1},
    "sgdm-decay-hetero-chunk": {"local_opt": "sgdm", "eta_l_decay": 0.9,
                                "local_steps_min": 1, "client_chunk": 2},
}
_SPARSE = dict(compressor="blocktopk", track_gamma=False)
MORE_CASES = {
    "faults-h": dict(_SPARSE, wire=True, fault="h"),
    "faults-i": dict(compressor="sign", track_gamma=False, fault="i"),
    "faults-sign-wire": dict(compressor="sign", wire=True, track_gamma=False,
                             fault="h"),
    "randk": dict(compressor="randk", client_chunk=2),
    "randk-two-way": dict(compressor="randk", two_way=True),
    "fused-kernel": dict(_SPARSE, fused_ingest="kernel"),
    "fused-kernel-int8": dict(_SPARSE, fused_ingest="kernel",
                              server_state_dtype="int8"),
    "fused-jnp-bf16": dict(_SPARSE, fused_ingest="jnp",
                           server_state_dtype="bfloat16"),
    "groups": dict(_SPARSE, wire=True, client_chunk=2, agg_groups=2),
    "dense-blocktopk-wire": dict(compressor="blocktopk",
                                 sparse_uplink=False, wire=True),
    "topk-fp16-wire": dict(wire=True, wire_value_dtype="float16"),
    "blocktopk-int8-wire": dict(_SPARSE, wire=True, wire_value_dtype="int8"),
    "int8": dict(compressor="int8"),
    "sign-two-way": dict(compressor="sign", two_way=True),
    "int8-state-two-pass": dict(server_state_dtype="int8"),
    "fedavg": dict(algorithm="fedavg", eta=1.0),
    "fedadam-hetero": dict(algorithm="fedadam", local_steps_min=1),
}


def _make(**kw):
    kw = dict(kw)
    if isinstance(kw.get("fault"), str):
        kw["fault"] = _fault(kw["fault"])
    base = dict(algorithm="fedcams", eta=0.05, eta_l=0.1, local_steps=K,
                num_clients=M, participating=N, compressor="topk",
                compress_ratio=1 / 8)
    base.update(kw)
    sim = FedSim(lambda p, b: cm.mlp_loss(p, b, MC), FedConfig(**base),
                 device="cpu")
    return sim, sim.init(init_params(cm.mlp_defs(MC),
                                     torch.Generator().manual_seed(0)))


def _stage(rounds: int = R):
    gen = np.random.default_rng(1)
    ids = np.stack([gen.choice(M, N, replace=False) for _ in range(rounds)])
    per = [DATA.round_batches(ids[r], r, K, B) for r in range(rounds)]
    return ids, {k: np.stack([b[k] for b in per]) for k in per[0]}


def _rngs(rounds: int = R):
    return [torch.Generator().manual_seed(100 + r) for r in range(rounds)]


def _parts(st):
    parts = {"params": st.params, "errors": st.errors,
             "server_error": st.server_error, "x_client": st.x_client}
    for name, t in st.opt._asdict().items():
        for j, leaf in enumerate(t if isinstance(t, tuple) else (t,)):
            parts[f"opt.{name}.{j}"] = leaf
    return parts


def _assert_same(st_l, st_s, mets_l, mets_s):
    a, b = _parts(st_l), _parts(st_s)
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    assert (st_l.bits, st_l.round) == (st_s.bits, st_s.round)
    assert len(mets_l) == len(mets_s)
    for m_l, m_s in zip(mets_l, mets_s):
        assert set(m_l) == set(m_s)
        for key in m_l:
            want, got = m_l[key], m_s[key]
            if isinstance(want, torch.Tensor):
                assert isinstance(got, torch.Tensor), key
                assert torch.equal(got, want.reshape(())), (key, want, got)
            else:
                assert got == want, (key, want, got)


def _loop(sim, st, ids, batches, rngs):
    """R eager rounds: ``FedSim.round`` under ``disable_graphs``."""
    mets = []
    with disable_graphs():
        for r in range(len(ids)):
            st, met = sim.round(st, {k: v[r] for k, v in batches.items()},
                                ids[r], rngs[r])
            mets.append(met)
    return st, mets


@pytest.mark.parametrize("kw", list(SCAN_CASES.values()) +
                         list(MORE_CASES.values()),
                         ids=list(SCAN_CASES) + list(MORE_CASES))
def test_staged_body_is_the_round_loop_to_the_bit(kw, no_host_reads):
    """run_rounds == R × round: the same final state (params, every EF
    row, the server's m/v/v̂/t, the server EF, the clients' model) and the
    same per-round metrics (loss, γ, the fault counts, bits, the wire
    counters, the verdicts), bit for bit; the body never reads the host."""
    ids, batches = _stage()
    sim_l, st_l = _make(**kw)
    st_l, mets_l = _loop(sim_l, st_l, ids, batches, _rngs())
    sim_s, st_s = _make(**kw)
    p0 = st_s.params.clone()
    st_s, mets_s = sim_s.run_rounds(st_s, batches, ids, _rngs())
    _assert_same(st_l, st_s, mets_l, mets_s)
    assert len(no_host_reads) == R and len(sim_s._programs) == 1
    # the staged state stays the caller's: the carry is a copy
    assert not torch.equal(st_s.params, p0)
    if "fault" in kw:
        seen = {k: sum(float(m[k]) for m in mets_s)
                for k in ("crashed", "rejected")}
        assert seen["crashed"] > 0, seen
        # a bit flip of a dense payload may stay finite, and pass
        if kw["fault"] == "i" or kw["compressor"] == "blocktopk":
            assert seen["rejected"] > 0, seen


def test_run_rounds_leaves_the_input_state_as_it_was():
    ids, batches = _stage()
    sim, st = _make(**MORE_CASES["faults-h"])
    before = {k: v.clone() for k, v in _parts(st).items()}
    sim.run_rounds(st, batches, ids, _rngs())
    for name, t in _parts(st).items():
        assert torch.equal(t, before[name]), name


def test_program_is_reused_and_resumes_mid_stream(no_host_reads):
    """3 + 2 staged rounds == 5 (the counters carry across calls); a second
    call with the same shapes runs the same program, loaded anew."""
    ids, batches = _stage()
    part = lambda lo, hi: ({k: v[lo:hi] for k, v in batches.items()},
                           ids[lo:hi])
    sim_a, st_a = _make(local_steps_min=1)
    rngs = _rngs()
    st_a, m1 = sim_a.run_rounds(st_a, *part(0, 3), rngs[:3])
    b, i = part(3, 5)
    st_a, m2 = sim_a.run_rounds(st_a, b, i, rngs[3:])
    sim_b, st_b = _make(local_steps_min=1)
    st_b, mets_b = sim_b.run_rounds(st_b, batches, ids, _rngs())
    _assert_same(st_b, st_a, mets_b, m1 + m2)
    assert len(sim_a._programs) == 2          # R = 3 and R = 2
    st_a2, m3 = sim_a.run_rounds(st_a, b, i, rngs[3:])
    assert len(sim_a._programs) == 2          # the R = 2 program again
    assert st_a2.round == 7 and m3[-1]["bits"] == st_a2.bits


@pytest.mark.parametrize("plant", ["item", "bool", "nonzero"])
def test_the_dispatch_mode_catches_a_planted_host_read(plant, no_host_reads):
    """The guard is live: a round that reads a value on the host fails the
    body. The read is planted just after the local phase: inside it, in the
    loss, torch.func's vmap refuses a host read by itself, in every round
    (test_torch_local_block.py::test_a_loss_vmap_cannot_take_raises_by_name).
    """
    sim, st = _make()
    train = sim._train_block

    def reading(*args):
        delta, losses = train(*args)
        if plant == "item":
            losses[0].item()
        elif plant == "bool":
            bool(losses[0] > 0)
        else:
            torch.nonzero(delta)
        return delta, losses

    sim._train_block = reading
    ids, batches = _stage(2)
    with pytest.raises(AssertionError, match="host read"):
        sim.run_rounds(st, batches, ids, _rngs(2))
    # the same read outside the body is fine: the eager round
    with disable_graphs():
        sim.round(st, {k: v[0] for k, v in batches.items()}, ids[0])


def test_ids_are_checked_once_on_the_host():
    ids, batches = _stage(2)
    sim, st = _make()
    bad = ids.copy()
    bad[1, 1] = bad[1, 0]
    with pytest.raises(ValueError, match="distinct"):
        sim.run_rounds(st, batches, bad)
    bad = ids.copy()
    bad[0, 0] = M
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        sim.run_rounds(st, batches, bad)


def test_ef_store_and_async_keep_their_paths():
    """ef_store runs R × round, each one run of the round's program (one
    program for the R rounds), with the next round's rows prefetched;
    async_buffer runs the buffered engine, one metric dict a flush, through
    its dispatch and flush programs; neither makes a run_rounds program."""
    ids, batches = _stage()
    sim_s, st_s = _make(ef_store=True)
    prefetched = []
    prefetch = sim_s._efs.prefetch
    sim_s._efs.prefetch = lambda rows: (prefetched.append(list(rows)),
                                        prefetch(rows))[1]
    st_s, mets_s = sim_s.run_rounds(st_s, batches, ids)
    assert prefetched == [list(r) for r in ids[1:]]
    sim_l, st_l = _make(ef_store=True)
    st_l, mets_l = _loop(sim_l, st_l, ids, batches, [None] * R)
    _assert_same(st_l, st_s, mets_l, mets_s)
    sim_a, st_a = _make(compressor="blocktopk", wire=True,
                        track_gamma=False, async_buffer=2)
    st_a, mets_a = sim_a.run_rounds(st_a, batches, ids)
    assert len(mets_a) == R * N // 2 and "staleness_max" in mets_a[0]
    assert [key[0] for key in sim_s._programs] == ["round"]
    assert sorted(key[0] for key in sim_a._programs) == ["dispatch", "flush"]
    with pytest.raises(ValueError, match="run_rounds"):
        sim_a.round(st_a, {k: v[0] for k, v in batches.items()}, ids[0])


def test_a_capture_leaves_the_launch_counters_as_they_were():
    """ops.captured_launches hands the launches recorded in a capture to
    the caller and leaves the counters as they were: a capture launches
    nothing, and a replay counts in no wrapper."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    ops.launches["topk_ef_sparse"] += 2
    with ops.captured_launches() as counts:
        ops.launches["topk_ef_sparse"] += 1
        ops.launches["fedams_ingest"] += 1
    assert counts["topk_ef_sparse"] == counts["fedams_ingest"] == 1
    assert counts["sign_ef"] == 0
    assert ops.launches["topk_ef_sparse"] == 2
    assert ops.launches["fedams_ingest"] == 0
    ops.reset_launches()


def test_round_checks_its_ids_on_the_host():
    """round stages its one round as run_rounds stages R: the ids are
    checked on the host, so the kernels' row checks are off."""
    ids, batches = _stage(1)
    sim, st = _make()
    one = {k: v[0] for k, v in batches.items()}
    bad = ids[0].copy()
    bad[1] = bad[0]
    with pytest.raises(ValueError, match="distinct"):
        sim.round(st, one, bad)
    bad = ids[0].copy()
    bad[0] = -1
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        sim.round(st, one, bad)


def test_stacked_plans_go_to_the_device_as_one_plan():
    from repro_torch.comm.faults import (FaultInjector, plan_to_device,
                                         stack_plans)
    inj = FaultInjector(_fault("i"), M)
    ids, _ = _stage(3)
    plans = [inj.plan(ids[r], r, None)[0] for r in range(3)]
    dev = plan_to_device(stack_plans(plans), "cpu")
    for r, p in enumerate(plans):
        one = plan_to_device(p, "cpu")
        for a, b in zip(one, dev):
            assert b.shape == (3, N) and torch.equal(a, b[r])


def test_run_rounds_tracks_the_jax_scan():
    """The port's run_rounds against the JAX ``FedSim.run_rounds`` (its
    ``lax.scan``) on make_problem's MLP, route b's configuration with
    heterogeneous step counts, from a numpy-staged init: the same ids and
    batches, the step counts drawn by the JAX keys and handed to the port;
    per-round loss within LOSS_RTOL, final params within 1e-4, bits
    equal."""
    rounds = 6
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=3, local_steps_min=1, num_clients=SIM_M,
              participating=SIM_N, compressor="blocktopk")
    defs, jloss, data = make_problem("mlp", SIM_M)
    p0 = staged_init(defs)
    staged = _staged_rounds(data, rounds)
    js = JaxSim(jloss, JaxFedConfig(**kw))
    jstate = js.init(p0)
    jbatches = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                            *[b for _, b, _ in staged])
    jids = jnp.asarray(np.stack([i for i, _, _ in staged]))
    jkeys = jnp.stack([k for _, _, k in staged])
    jstate, jmets = js.run_rounds(jstate, jbatches, jids, jkeys)
    # the JAX round's step counts: its hetero draw from each round's key
    from repro.core.local import hetero_step_counts as jax_counts
    counts = [torch.from_numpy(np.array(jax_counts(
        JaxFedConfig(**kw), k, SIM_N))).long() for _, _, k in staged]
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw), device="cpu")
    it = iter(counts)
    ts._step_counts = lambda rng, n: next(it)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    tstate, tmets = ts.run_rounds(
        tstate, {k: np.stack([b[k] for _, b, _ in staged])
                 for k in staged[0][1]},
        np.stack([i for i, _, _ in staged]))
    jloss_r = np.array([float(m["loss"]) for m in jmets])
    tloss_r = np.array([float(m["loss"]) for m in tmets])
    np.testing.assert_allclose(tloss_r, jloss_r, rtol=LOSS_RTOL)
    jflat = np.asarray(jax.flatten_util.ravel_pytree(jstate.params)[0])
    np.testing.assert_allclose(tstate.params.numpy(), jflat, atol=1e-4)
    assert [m["bits"] for m in tmets] == [int(m["bits"]) for m in jmets]
    assert tstate.round == rounds and int(tstate.opt.t) == rounds
