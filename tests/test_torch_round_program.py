"""The per-round entry points as programs, the port's counterpart of the
reference's ``jax.jit(..., donate_argnums=(0,))`` of each: ``FedSim.round``,
the async engine's dispatch and flush (``FedSim._dispatch``,
``FedSim._flush``) and the mesh's per-round step (``MeshRounds.round``,
which ``FederatedTrainer(mesh=...).run`` and ``launch/train.py``'s
``train`` take a round at a time). On the card each is one CUDA graph per
shape and setting, replayed once a call
(``tests/test_torch_round_program_cuda.py``); here, on the CPU, the same
bodies run eagerly on the programs' buffers.

Each is held to its eager twin under ``repro_torch.disable_graphs()`` to
the bit: states, metric dicts and host counters, in
``tests/test_torch_run_rounds.py``'s configurations plus the EF store (with
client chunks and two aggregation groups) and the async engine. Every
body runs under ``tests/host_reads.py``'s ``NoHostReads`` (no host read, so
nothing to break a capture). ``round`` updates the input state's EF buffer
in place and leaves every state it returned earlier as it was; one program
serves R calls, and another is made when a setting changes."""
import numpy as np
import pytest
import torch

from host_reads import NoHostReads
from repro_torch import disable_graphs
from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core import mesh as meshmod
from repro_torch.core.sim import FedSim
from test_torch_mesh import spawn
from test_torch_mesh_rounds import (FIELDS, LM, SEL, Targets, TwoLeafModel,
                                    _fed, _guard_steps, _host_state,
                                    _same_state)
from test_torch_run_rounds import (MORE_CASES, SCAN_CASES, R, _assert_same,
                                   _loop, _make, _parts, _rngs, _stage)

torch.set_num_threads(1)

_SPARSE = dict(compressor="blocktopk", track_gamma=False)
#: test_torch_run_rounds.py's configurations, and the EF store's
CASES = dict(SCAN_CASES, **MORE_CASES, **{
    "ef-store": dict(ef_store=True),
    "ef-store-chunk-groups": dict(_SPARSE, wire=True, ef_store=True,
                                  client_chunk=2, agg_groups=2),
})
#: the async engine: B = 2 of 4 (stale flushes, partial last flush), the
#: fused ingest, heterogeneous steps, faults (crashes, bit flips, a clip)
ASYNC_CASES = {
    "b2": dict(_SPARSE, wire=True, async_buffer=2),
    "b2-fused-inv-sqrt": dict(_SPARSE, wire=True, async_buffer=2,
                              fused_ingest="kernel",
                              staleness_weight="inv_sqrt"),
    "b3-hetero": dict(_SPARSE, wire=True, async_buffer=3,
                      local_steps_min=1),
    "b2-faults": dict(_SPARSE, wire=True, async_buffer=2,
                      fault=FaultConfig(crash_prob=0.3, corrupt_prob=0.4,
                                        corrupt_mode="bitflip",
                                        max_update_norm=0.5, seed=3)),
}
BODIES = ("_rounds_body", "_dispatch_body", "_flush_body")


@pytest.fixture
def bodies(monkeypatch):
    """Every program body under :class:`NoHostReads`; yields the list of
    (body, program) each run appended."""
    seen = []
    for name in BODIES:
        def run(self, prog, fn=getattr(FedSim, name), name=name):
            seen.append((name, prog))
            with NoHostReads():
                return fn(self, prog)
        monkeypatch.setattr(FedSim, name, run)
    return seen


def _program_rounds(sim, st, ids, batches, rngs):
    """R calls of ``round`` through its program: the states and metrics
    each returned, and a copy of each state as it came back."""
    states, copies, mets = [], [], []
    for r in range(len(ids)):
        st, met = sim.round(st, {k: v[r] for k, v in batches.items()},
                            ids[r], rngs[r], prefetch_idx=ids[r + 1]
                            if r + 1 < len(ids) else None)
        states.append(st)
        copies.append({k: v.clone() for k, v in _parts(st).items()})
        mets.append(met)
    return states, copies, mets


@pytest.mark.parametrize("kw", list(CASES.values()), ids=list(CASES))
def test_round_is_its_eager_twin_to_the_bit(kw, bodies):
    """R calls of ``round`` through its program equal R calls under
    ``disable_graphs()``: the final state, every metric dict (the device
    metrics and the host counters: bits, wire bytes and times, the fault
    verdicts), bit for bit. One program serves the R calls, each call one
    run of its body, none reading the host."""
    ids, batches = _stage()
    sim_e, st_e = _make(**kw)
    st_e, mets_e = _loop(sim_e, st_e, ids, batches, _rngs())
    assert not sim_e._programs and not bodies      # the eager twin
    sim_p, st_p = _make(**kw)
    states, _, mets_p = _program_rounds(sim_p, st_p, ids, batches, _rngs())
    _assert_same(st_e, states[-1], mets_e, mets_p)
    assert [key[0] for key in sim_p._programs] == ["round"]
    (prog,) = sim_p._programs.values()
    assert [p for _, p in bodies] == [prog] * R


@pytest.mark.parametrize("kw", [{}, MORE_CASES["faults-h"],
                                CASES["ef-store-chunk-groups"]],
                         ids=["default", "faults-h", "ef-store"])
def test_round_updates_the_ef_buffer_in_place_and_keeps_earlier_states(kw):
    """The input state's EF buffer is updated in place (the program
    adopts it: no copy), so every state of the chain holds it; the other
    tensors of each returned state, and its metrics, are its own: later
    calls leave them as they were. With the EF store the (n, d) block a
    state holds is its own too (the program's block is copied out)."""
    ids, batches = _stage()
    sim, st = _make(**kw)
    ef0 = st.errors
    states, copies, mets = _program_rounds(sim, st, ids, batches, _rngs())
    (prog,) = sim._programs.values()
    for state, copy in zip(states, copies):
        for name, t in _parts(state).items():
            if name == "errors" and not sim.fed.ef_store:
                assert t is ef0
            else:
                assert torch.equal(t, copy[name]), name
                assert all(t.untyped_storage().data_ptr()
                           != u.untyped_storage().data_ptr()
                           for u in (prog.carry[0], prog.carry[4])), name
    for met in mets:
        for key in prog.keys:
            assert (met[key].untyped_storage().data_ptr()
                    != prog.out.untyped_storage().data_ptr()), key
    assert states[0].params.data_ptr() != states[1].params.data_ptr()


def test_one_program_for_r_calls_and_another_after_a_setting_changes():
    """R calls: one program, loaded anew each call. Deterministic
    algorithms on: another (the key holds the settings that pick kernels),
    and back off, the first again. A state with another EF buffer (a
    second chain on the same FedSim) runs through the same program, its
    buffer lent in and updated in place; the first chain's buffer is left
    as it was, and each chain equals its eager twin."""
    ids, batches = _stage()
    one = lambda r: {k: v[r] for k, v in batches.items()}
    sim, st = _make()
    for r in range(3):
        st, _ = sim.round(st, one(r), ids[r])
    assert len(sim._programs) == 1
    first = next(iter(sim._programs.values()))
    torch.use_deterministic_algorithms(True)
    try:
        st, _ = sim.round(st, one(3), ids[3])
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(sim._programs) == 2
    st, _ = sim.round(st, one(4), ids[4])
    assert len(sim._programs) == 2 and first in sim._programs.values()
    # two chains on one FedSim, interleaved, against two eager twins
    sim, a = _make()
    _, b = _make()
    twin_a, ea = _make()
    twin_b, eb = _make()
    bufs = a.errors, b.errors
    progs = set()
    for r in range(3):
        a, _ = sim.round(a, one(r), ids[r])
        before = a.errors.clone()
        b, _ = sim.round(b, one(4 - r), ids[4 - r])
        assert torch.equal(a.errors, before)
        progs.update(map(id, sim._programs.values()))
        with disable_graphs():
            ea, _ = twin_a.round(ea, one(r), ids[r])
            eb, _ = twin_b.round(eb, one(4 - r), ids[4 - r])
    for got, want in ((a, ea), (b, eb)):
        _assert_same(want, got, [], [])
    assert a.errors is bufs[0] and b.errors is bufs[1]
    assert len(sim._programs) == 1 and len(progs) == 1


@pytest.mark.parametrize("kw", list(ASYNC_CASES.values()),
                         ids=list(ASYNC_CASES))
def test_async_steps_are_their_eager_twins_to_the_bit(kw, bodies):
    """The async engine's ``run_rounds`` through its two step programs
    (the dispatch adopting the EF buffer, the flush carrying the server
    state) equals its run under ``disable_graphs()``: the state and every
    flush's metrics, bit for bit; one dispatch and one flush program (a
    partial flush has the full one's shapes), each run once a step, none
    reading the host."""
    ids, batches = _stage()
    sim_e, st_e = _make(**kw)
    with disable_graphs():
        st_e, mets_e = sim_e.run_rounds(st_e, batches, ids, _rngs())
    assert not sim_e._programs and not bodies
    sim_p, st_p = _make(**kw)
    ef0 = st_p.errors
    st_p, mets_p = sim_p.run_rounds(st_p, batches, ids, _rngs())
    _assert_same(st_e, st_p, mets_e, mets_p)
    assert st_p.errors is ef0
    assert sorted(key[0] for key in sim_p._programs) == ["dispatch", "flush"]
    runs = [name for name, _ in bodies]
    assert runs.count("_dispatch_body") == R
    assert runs.count("_flush_body") == len(mets_p)
    assert len({id(p) for _, p in bodies}) == 2
    if "fault" in kw:
        assert sum(float(m["rejected"]) for m in mets_p) > 0


def test_async_ids_are_checked_on_the_host():
    """The engine checks the staged ids on the host (the dispatch programs
    run with the EF kernels' row checks off)."""
    ids, batches = _stage(2)
    sim, st = _make(**ASYNC_CASES["b2"])
    bad = ids.copy()
    bad[1, 1] = bad[1, 0]
    with pytest.raises(ValueError, match="distinct"):
        sim.run_rounds(st, batches, bad)


# -- the mesh's per-round step on 4 gloo ranks ---------------------------------

WORLD, MESH_ROUNDS = 4, 3


def _history(hist):
    return [{k: v for k, v in h.items() if k not in ("round_s", "event_ms")}
            for h in hist]


def per_round_worker(rank, world):
    """On this rank: ``FederatedTrainer(mesh=...).run(rounds=3)`` through
    the per-round program and under ``disable_graphs()`` (the eager
    ``fed_round`` loop), then ``launch/train.py``'s ``train`` (a tiny LM,
    no ``scan_rounds``) both ways; every program step under
    :class:`NoHostReads`. Rank 0 returns the histories, the final states,
    the steps and the programs made."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh
    seen = _guard_steps()
    out = {}
    fed = _fed(world, **SEL, compressor="blocktopk")
    train = TrainConfig(global_batch=world * 2, seq_len=1,
                        remat_policy="none", rounds=MESH_ROUNDS)
    for mode in ("program", "eager"):
        del seen[:]
        tr = FederatedTrainer(fed=fed, train=train, model=TwoLeafModel(),
                              mesh=make_mesh((world,), ("data",), "cpu"),
                              lm_data=Targets(), device="cpu")
        if mode == "eager":
            with disable_graphs():
                hist = tr.run(log=None)
        else:
            hist = tr.run(log=None)
        out[f"trainer-{mode}"] = dict(
            hist=hist, steps=list(seen), programs=len(tr._scan.programs),
            captured=tr._scan.last["captured"],
            state=_host_state(meshmod.gather_fed_state(
                tr._state, tr.model, fed, tr._ctx)))
    ap = ttrain.parser()
    lm_fed = ttrain.build_fed(ap.parse_args(
        ["--dp", str(world), "--compressor", "topk", "--aggregation",
         "sparse", "--mesh-sparse-impl", "kernel", "--fused-ingest",
         "kernel"]), ap)
    lm_train = TrainConfig(global_batch=world, seq_len=16,
                           rounds=MESH_ROUNDS, remat_policy="none")
    for mode in ("program", "eager"):
        del seen[:]
        run = lambda: ttrain.train(ModelConfig(**LM), lm_fed, lm_train,
                                   device="cpu", log=None, keep_params=True)
        if mode == "eager":
            with disable_graphs():
                res = run()
        else:
            res = run()
        out[f"train-{mode}"] = dict(hist=_history(res["history"]),
                                    steps=list(seen), params=res["params"],
                                    finite=res["finite"])
    return out


@pytest.fixture(scope="module")
def per_round():
    return spawn(per_round_worker, WORLD)


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def test_trainer_per_round_step_is_the_eager_loop_to_the_bit(per_round):
    """``FederatedTrainer(mesh=...).run(rounds=3)``: each round through the
    one per-round program (on gloo its staged body, run eagerly: not
    captured), three guarded steps, no host read; the history and the
    gathered state (params, m, v, v̂, every EF row) equal the eager
    ``fed_round`` loop's to the bit."""
    prog, eager = per_round["trainer-program"], per_round["trainer-eager"]
    assert prog["steps"] == [True] * MESH_ROUNDS and prog["programs"] == 1
    assert prog["captured"] is False
    assert eager["steps"] == [] and eager["captured"] is False
    assert prog["hist"] == eager["hist"] and len(prog["hist"]) == MESH_ROUNDS
    assert not _same_state(prog["state"], eager["state"])
    assert set(prog["state"]) == set(FIELDS)


def test_train_per_round_step_is_the_eager_loop_to_the_bit(per_round):
    """``launch/train.py``'s ``train`` without ``scan_rounds`` on a tiny
    LM, 4 clients: each round through the per-round program, guarded, no
    host read; the losses, wire bytes and the final params equal the
    eager loop's to the bit."""
    prog, eager = per_round["train-program"], per_round["train-eager"]
    assert prog["steps"] == [True] * MESH_ROUNDS and eager["steps"] == []
    assert prog["hist"] == eager["hist"] and len(prog["hist"]) == MESH_ROUNDS
    assert prog["finite"] and eager["finite"]
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(_flat(prog["params"]), _flat(eager["params"])))
