"""The step builders' train step and the LM example's round as the mesh's
per-round program, the reference's jitted ``fed_round``
(``src/repro/launch/steps.py``'s ``build_train_step``,
``examples/train_lm_fedcams.py``): ``launch/steps.py::build_train_step``
returns a ``launch.programs.TrainStep`` over ``core.mesh.
build_fed_rounds_scan(...).round``, and ``examples/train_lm_fedcams_torch.py``
calls that per-round program. On CPU ranks over gloo the program runs its
staged body eagerly on the carry; on the card it is one captured round
(``tests/test_torch_train_step_program_cuda.py``).

* **(a)** ``build_train_step(...).fn`` over 3 rounds on 2 gloo ranks, in
  route z's settings (the xlstm smoke config, remat "full", fedcams top-k
  1/64 over the dense uplink, K = 1) and route o's (the gemma2 smoke
  config, blockwise top-k over the sparse collective with the fused
  ingest through the kernels' twins, K = 2), to the bit its eager twin
  under ``repro_torch.disable_graphs()``: params, m, v, v̂, every EF row,
  the loss and the wire bytes. Every program step runs under
  ``tests/host_reads.py::NoHostReads``: the body reads nothing on the
  host.
* **(b)** The state given is consumed and the carry returned (ROADMAP
  Queue 3 item 40); the eager twin leaves the caller's state as it was,
  as the reference's undonated step does.
* **(c)** The example's ``rank_main`` (``--preset 2m --clients 2 --tp 2``)
  through its program and under ``disable_graphs()``: the losses and the
  final params to the bit.
* **(d)** ``op_analysis`` counts the step's eager round: on ``meta``
  (the dry run) ``analyze`` of ``b.fn`` equals that of ``b.fn.eager``,
  and no program is built.
* **(e)** ``models/stack.py::_remat`` checkpoints without saving the
  generator state (a capture may refuse to read it): the loss and every
  gradient are bitwise what the checkpoint gives with it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from host_reads import NoHostReads
from repro_torch import disable_graphs
from repro_torch.core import mesh as meshmod
from test_torch_mesh import spawn

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "train_lm_fedcams_torch.py")
FIELDS = ("params", "m", "v", "vhat", "errors")
R, SEQ, BATCH = 3, 16, 4


def settings(name: str):
    """Route ``name``'s step settings at smoke size: (arch, FedConfig,
    TrainConfig, a CPU ``KernelImpl`` or None). z: the dry run's CLI at
    ``--local-steps 1`` (fedcams, top-k 1/64 over the dense uplink, remat
    "full"); o: the train CLI's blockwise top-k over the sparse collective
    with the fused ingest, K = 2, remat "none"."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.ops import KernelImpl
    if name == "z":
        from repro_torch.launch import dryrun
        fed, train = dryrun.build_configs(dryrun.parser().parse_args(
            ["--local-steps", "1"]))
        return "xlstm-350m", fed, train, None
    from repro_torch.launch import train as ttrain
    ap = ttrain.parser()
    fed = ttrain.build_fed(ap.parse_args(
        ["--dp", "2", "--compressor", "topk", "--aggregation", "sparse",
         "--mesh-sparse-impl", "kernel", "--fused-ingest", "kernel"]), ap)
    return ("gemma2-2b", fed, TrainConfig(remat_policy="none"),
            KernelImpl(device="cpu"))


def bundle(name: str, mesh):
    """``build_train_step`` for route ``name``'s settings on ``mesh``, its
    TrainConfig at the step's shape, and the vocabulary."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    arch, fed, train, impl = settings(name)
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke)
    shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
    b = steps.build_train_step(spec, shape, mesh, fed, train,
                               kernel_impl=impl)
    tcfg = dataclasses.replace(train, global_batch=BATCH, seq_len=SEQ)
    return b, tcfg, spec.model.vocab_size


def _clone(st) -> dict:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().clone()
    return {f: conv(getattr(st, f)) for f in FIELDS}


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def _leaves(st):
    return [t for f in FIELDS for t in _flat(getattr(st, f))] + [st.round]


def _bits(t):
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8)


def _differs(a: dict, b: dict) -> list:
    return [f for f in FIELDS if not all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(_flat(a[f]),
                                                        _flat(b[f])))]


def _guard_steps():
    """Every ``_RoundsProgram.step`` of this rank under
    :class:`NoHostReads`; returns the list of the steps' ``write``."""
    seen = []
    step = meshmod._RoundsProgram.step

    def guarded(self, write=True):
        seen.append(write)
        with NoHostReads():
            return step(self, write)

    meshmod._RoundsProgram.step = guarded
    return seen


def step_worker(rank, world, names):
    """Each route's settings on this rank of a (2, 1) ("data", "model")
    mesh: R rounds of ``b.fn`` under ``disable_graphs()`` (the twin), then
    R through the program from the same init; rank 0 returns both global
    states, both rounds' metrics, the program's report and whether each
    run left its first input state as it was."""
    from repro_torch.core.mesh import (gather_fed_state, init_fed_state,
                                       shard_batch)
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.launch.mesh import make_mesh
    seen = _guard_steps()
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    out = {}
    for name in names:
        b, tcfg, vocab = bundle(name, mesh)
        data = FederatedLMData(num_clients=b.fed.num_clients,
                               vocab_size=vocab, seed=0)
        batches = [shard_batch(data.mesh_batch(r, b.fed.local_steps, BATCH,
                                               SEQ), b.model, b.fed, tcfg,
                               b.ctx, "cpu") for r in range(R)]
        init = lambda: init_fed_state(b.model, b.fed,
                                      torch.Generator().manual_seed(0),
                                      b.ctx, "cpu")
        gather = lambda st: _clone(gather_fed_state(st, b.model, b.fed,
                                                    b.ctx))
        runs = {}
        for run in ("twin", "program"):
            st0 = init()
            before, ids = _clone(st0), [id(t) for t in _leaves(st0)]
            del seen[:]
            st, mets = st0, []
            with (disable_graphs() if run == "twin" else
                  contextlib.nullcontext()):
                for r in range(R):
                    st, met = b.fn(st, batches[r], r)
                    mets.append({k: v.detach().clone()
                                 for k, v in met.items()})
            last = b.fn.rounds.last
            runs[run] = dict(
                state=gather(st), metrics=mets, steps=list(seen),
                first_kept=not _differs(before, _clone(st0)),
                carry_is_first=[id(t) for t in _leaves(st)] == ids,
                returned_carry=(last["program"] is not None
                                and st is last["program"].carry),
                captured=last["captured"],
                programs=len(b.fn.rounds.programs),
                kind=type(b.fn).__name__)
        out[name] = runs
    return out


@pytest.fixture(scope="module")
def steps_run():
    return spawn(step_worker, 2, ["z", "o"])


@pytest.mark.parametrize("name", ["z", "o"])
def test_the_train_step_program_equals_its_eager_twin(steps_run, name):
    """(a) R rounds of ``build_train_step(...).fn``, a ``TrainStep``,
    through its program (on gloo the staged body, run eagerly: not
    captured, one program, R guarded steps, none a warm-up, none reading
    the host) equal R rounds of its eager twin under ``disable_graphs()``
    to the bit: the gathered params, m, v, v̂ and EF rows, and every
    round's loss and wire bytes."""
    twin, prog = steps_run[name]["twin"], steps_run[name]["program"]
    assert prog["kind"] == "TrainStep"
    assert prog["captured"] is False and prog["programs"] == 1
    assert prog["steps"] == [True] * R and twin["steps"] == []
    assert not _differs(twin["state"], prog["state"]), \
        _differs(twin["state"], prog["state"])
    for r in range(R):
        assert sorted(prog["metrics"][r]) == sorted(twin["metrics"][r])
        assert {"loss", "wire_up_bytes"} <= set(prog["metrics"][r])
        for key, v in prog["metrics"][r].items():
            assert v.device.type == "cpu" and v.shape == ()
            assert torch.equal(_bits(v), _bits(twin["metrics"][r][key])), \
                (name, r, key)
    assert float(prog["metrics"][0]["wire_up_bytes"]) > 0


@pytest.mark.parametrize("name", ["z", "o"])
def test_the_program_consumes_the_state_it_is_given(steps_run, name):
    """(b) ROADMAP Queue 3 item 40: the program adopts the first state
    given as its carry, writes each round into it and returns it (the
    returned state's tensors are the first input's: that state now holds
    round R's values); its eager twin, as the reference's undonated
    step, leaves the caller's state as it was and returns new tensors."""
    twin, prog = steps_run[name]["twin"], steps_run[name]["program"]
    assert prog["returned_carry"] and prog["carry_is_first"]
    assert not prog["first_kept"]
    assert twin["first_kept"] and not twin["carry_is_first"]


def _load_example():
    spec = importlib.util.spec_from_file_location("train_lm_fedcams_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_worker(rank, world, tmp):
    """The example's ``rank_main`` on this rank, through its program and
    then under ``disable_graphs()``, each writing its checkpoint (the
    gathered params) to its own directory; ``MeshRounds.round`` spied:
    its calls and whether the latest built a program."""
    ex = _load_example()
    calls = []
    saved = meshmod.MeshRounds.round

    def spy(self, *a):
        out = saved(self, *a)
        calls.append(self.last["program"] is not None)
        return out

    meshmod.MeshRounds.round = spy
    out = {}
    try:
        for run in ("program", "twin"):
            args = ex.parser().parse_args(
                ["--preset", "2m", "--clients", "2", "--tp", "2",
                 "--rounds", str(R), "--seq-len", "32", "--device", "cpu",
                 "--checkpoint", os.path.join(tmp, run)])
            del calls[:]
            with (disable_graphs() if run == "twin" else
                  contextlib.nullcontext()):
                losses = ex.rank_main(args, device="cpu")
            out[run] = dict(losses=losses, calls=list(calls))
    finally:
        meshmod.MeshRounds.round = saved
    return out


def test_the_lm_example_runs_its_program_bitwise_its_twin(tmp_path):
    """(c) ``examples/train_lm_fedcams_torch.py``'s ``rank_main`` at
    ``--preset 2m --clients 2 --tp 2`` (4 gloo ranks), 3 rounds: each
    round one call of ``MeshRounds.round`` through its program; under
    ``disable_graphs()`` the same calls run the eager round; the losses
    and the saved params (every leaf) equal to the bit."""
    res = spawn(example_worker, 4, str(tmp_path))
    prog, twin = res["program"], res["twin"]
    assert prog["calls"] == [True] * R and twin["calls"] == [False] * R
    assert len(prog["losses"]) == R
    assert np.array(prog["losses"], np.float64).tobytes() == \
        np.array(twin["losses"], np.float64).tobytes()
    with np.load(tmp_path / "program" / "arrays.npz") as a, \
            np.load(tmp_path / "twin" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 0
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def test_op_analysis_counts_the_eager_round():
    """(d) On a (1, 1) mesh of the fake process group, in route z's and
    route o's settings: ``analyze(b.fn, *b.abstract_args)`` on ``meta``
    equals ``analyze(b.fn.eager, ...)`` (ops, FLOPs, bytes, rw bytes,
    collective and launch counts, the memory record); counting builds no
    program."""
    code = f"""
    import json, sys
    sys.path.insert(0, {SRC!r})
    sys.path.insert(0, {os.path.dirname(__file__)!r})
    import dataclasses
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.mesh import make_mesh, start_fake_world
    from test_torch_train_step_program import bundle
    start_fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    out = {{}}
    for name in ("z", "o"):
        b, _, _ = bundle(name, mesh)
        meta = [dataclasses.asdict(oa.analyze(f, *b.abstract_args))
                for f in (b.fn, b.fn.eager)]
        out[name] = dict(meta=meta, programs=len(b.fn.rounds.programs))
    print(json.dumps(out))
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name, r in out.items():
        got, want = r["meta"]
        assert got == want, name
        assert want["ops"] > 0 and want["flops"] > 0
        assert sum(want["launch_count"].values()) > 0, name
        assert r["programs"] == 0, name


# -- the remat repair ------------------------------------------------------------


def _loss_and_grads(arch: str, policy: str):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import ParallelContext
    model = Model(get_arch(arch).smoke)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, size=(2, SEQ + 1)).astype(np.int32))
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss(params, batch, ParallelContext(),
                         remat_policy=policy)
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "gemma2-2b"])
def test_remat_without_the_generator_state_changes_no_number(
        monkeypatch, arch, policy):
    """(e) Every checkpoint ``_remat`` makes passes
    ``preserve_rng_state=False``; the loss and every gradient of the smoke
    config's ``Model.loss`` under the policy are bitwise what the same
    checkpoints give with ``preserve_rng_state=True`` (the default the
    port used before): no block draws a random number."""
    from repro_torch.models import stack
    kwargs = []
    real = stack.ckpt.checkpoint

    def spy(fn, *a, **kw):
        kwargs.append(dict(kw))
        return real(fn, *a, **kw)

    monkeypatch.setattr(stack.ckpt, "checkpoint", spy)
    got = _loss_and_grads(arch, policy)
    assert kwargs and all(kw["preserve_rng_state"] is False and
                          kw["use_reentrant"] is False for kw in kwargs)
    monkeypatch.setattr(stack.ckpt, "checkpoint", lambda fn, *a, **kw: real(
        fn, *a, **dict(kw, preserve_rng_state=True)))
    want = _loss_and_grads(arch, policy)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), i
