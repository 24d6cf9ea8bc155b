"""The two switches of ``repro_torch``, on the CPU.

* ``disable_graphs()`` (``jax.disable_jit()``) covers the multi-round
  drivers too: inside it ``FedSim.run_rounds`` runs R rounds of its eager
  round one after another (the sync path in eight configurations, the EF
  store and the async engine) and ``MeshRounds`` called with R rounds R
  eager ``fed_round``s, building no program, and both equal their
  programs' results to the bit (state and every metric); the input
  state of ``run_rounds`` is left as it was either way.
* ``clear_caches()`` (``jax.clear_caches()``) drops every program that a
  live FedSim, ``MeshRounds`` or serving program cache holds; a new call
  rebuilds one and gives the same results to the bit. The registry is
  weak: a FedSim, a ``MeshRounds`` or a model registered is freed with its
  last reference. (The card test of the memory these programs hold, the
  reserved bytes given back after ``clear_caches()`` +
  ``torch.cuda.empty_cache()``, is
  ``tests/test_torch_serve_program_cuda.py``.)
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import clear_caches, disable_graphs
from repro_torch.core import mesh as meshmod
from repro_torch.launch import serve as tserve
from repro_torch.launch.programs import programs_of
from repro_torch.models.model import Model
from test_torch_mesh_rounds import _bits, _leaves, _one_client
from test_torch_run_rounds import (MORE_CASES, SCAN_CASES, _assert_same,
                                   _make, _rngs, _stage)

torch.set_num_threads(1)

CASES = {name: SCAN_CASES[name] for name in
         ("default", "wire-two-way", "hetero", "sgdm-decay-hetero-chunk")}
CASES.update({name: MORE_CASES[name] for name in
              ("faults-h", "randk", "fused-kernel", "groups")})


@pytest.mark.parametrize("kw", list(CASES.values()), ids=list(CASES))
def test_run_rounds_in_the_switch_is_its_program_to_the_bit(kw):
    """R = 5 rounds inside ``disable_graphs()``: no program, the input
    state as it was, and the state and every round's metrics equal the
    program's (R replays of its staged round) to the bit."""
    ids, batches = _stage()
    sim_e, st_e = _make(**kw)
    errors = st_e.errors.clone()
    with disable_graphs():
        out_e, mets_e = sim_e.run_rounds(st_e, batches, ids, _rngs())
    assert not sim_e._programs
    assert torch.equal(st_e.errors, errors)
    sim_p, st_p = _make(**kw)
    out_p, mets_p = sim_p.run_rounds(st_p, batches, ids, _rngs())
    assert [key[0] for key in sim_p._programs] == ["rounds"]
    _assert_same(out_e, out_p, mets_e, mets_p)


@pytest.mark.parametrize("kw", [dict(ef_store=True),
                                dict(compressor="blocktopk", wire=True,
                                     track_gamma=False, async_buffer=2)],
                         ids=["ef_store", "async"])
def test_the_store_and_async_drivers_in_the_switch_build_no_program(kw):
    """The EF store's loop of rounds and the async engine's dispatches and
    flushes inside ``disable_graphs()``: no program, and the same state and
    metrics as through their programs, to the bit."""
    ids, batches = _stage()
    sim_e, st_e = _make(**kw)
    with disable_graphs():
        out_e, mets_e = sim_e.run_rounds(st_e, batches, ids, _rngs())
    assert not sim_e._programs
    sim_p, st_p = _make(**kw)
    out_p, mets_p = sim_p.run_rounds(st_p, batches, ids, _rngs())
    assert sim_p._programs
    _assert_same(out_e, out_p, mets_e, mets_p)


def test_mesh_rounds_in_the_switch_are_the_program_to_the_bit():
    """``MeshRounds`` called with R = 3 rounds inside ``disable_graphs()``:
    three eager ``fed_round``s (``last`` says so), no program, and the
    same state and (R,) metrics as the program's call, to the bit."""
    fed, model, train, ctx, rnd, init, batches = _one_client()
    eager = meshmod.build_fed_rounds_scan(rnd)
    with disable_graphs():
        st_e, met_e = eager(init(0), batches(0, 3), [0, 1, 2])
    assert not eager.programs and eager.last["program"] is None
    assert eager.last["captured"] is False and eager.last["rounds"] == 3
    prog = meshmod.build_fed_rounds_scan(rnd)
    st_p, met_p = prog(init(0), batches(0, 3), [0, 1, 2])
    assert len(prog.programs) == 1
    assert int(st_e.round) == int(st_p.round) == 3
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in
               zip(_leaves(st_e)[:-1], _leaves(st_p)[:-1]))
    assert set(met_e) == set(met_p)
    for key in met_p:
        assert met_e[key].shape == (3,) and torch.equal(met_e[key],
                                                        met_p[key]), key


def _serve_once(model, params):
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    out = tserve.generate(model, params, prompts, 6, log=None)
    return out["tokens"], out["logits0"]


def test_clear_caches_drops_every_program_and_a_call_rebuilds_it():
    """A FedSim with a round and a run_rounds program, a ``MeshRounds``
    with its program and a model with its serving session: after
    ``clear_caches()`` all three hold none, and the same calls again
    rebuild one each and give the same results to the bit."""
    from repro_torch.configs.registry import get_arch
    ids, batches = _stage()
    sim, st0 = _make(**CASES["fused-kernel"])
    one = {k: v[0] for k, v in batches.items()}

    def fedsim():
        st, met = sim.round(st0._replace(errors=st0.errors.clone()), one,
                            ids[0], _rngs(1)[0])
        out, mets = sim.run_rounds(st0, batches, ids, _rngs())
        return [st.params, met["loss"], out.params, out.errors] + [
            m["loss"] for m in mets]

    fed, mmodel, train, ctx, rnd, init, mbatches = _one_client()
    scan = meshmod.build_fed_rounds_scan(rnd)

    def mesh():
        st, met = scan(init(0), mbatches(0, 2), [0, 1])
        return _leaves(st)[:-1] + [met["loss"]]

    model = Model(get_arch("gemma2-2b").smoke)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    first = (fedsim(), mesh(), _serve_once(model, params))
    assert sorted(key[0] for key in sim._programs) == ["round", "rounds"]
    assert len(scan.programs) == 1 and programs_of(model).live is not None
    clear_caches()
    assert not sim._programs and not scan.programs and scan.last is None
    assert programs_of(model).live is None
    again = (fedsim(), mesh(), _serve_once(model, params))
    assert sorted(key[0] for key in sim._programs) == ["round", "rounds"]
    assert len(scan.programs) == 1 and programs_of(model).live is not None
    for a, b in zip(first[0] + first[1], again[0] + again[1]):
        assert torch.equal(_bits(a.float()), _bits(b.float()))
    assert np.array_equal(first[2][0], again[2][0])
    assert torch.equal(first[2][1], again[2][1])


def test_the_registry_keeps_nothing_alive():
    """A FedSim, a ``MeshRounds`` and a model's serving programs are
    registered for ``clear_caches()`` and freed with their last
    reference."""
    from repro_torch.configs.registry import get_arch
    sim, _ = _make()
    rnd = _one_client()[4]
    scan = meshmod.build_fed_rounds_scan(rnd)
    model = Model(get_arch("xlstm-350m").smoke)
    progs = programs_of(model)
    assert {sim, scan, progs} <= set(repro_torch._CACHES)
    refs = [weakref.ref(o) for o in (sim, scan, progs, model)]
    del sim, scan, progs, model, rnd
    gc.collect()
    assert all(r() is None for r in refs)
