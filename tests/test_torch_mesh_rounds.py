"""The mesh's multi-round program (``repro_torch.core.mesh.
build_fed_rounds_scan``), the port's counterpart of the reference's
``lax.scan`` of ``fed_round`` inside ``shard_map``: R rounds staged on the
host up front (``MeshRound.stage_inputs``, the prelude the eager round runs
at R = 1), then one body run round after round on the state's own tensors,
reading its round's inputs at a round counter on the device. On CUDA +
NCCL one round is captured into a CUDA graph and replayed
(``tests/test_torch_mesh_rounds_cuda.py``); here, on CPU ranks over gloo,
the same body runs eagerly.

* **(a) R = 4 rounds of the program equal 4 × ``fed_round`` to the bit**
  (params, m, v, v̂, every EF row, every metric) on 8 gloo ranks over a
  grid of configurations, each program step (the body and its write into
  the carry) under a ``TorchDispatchMode`` (``tests/host_reads.py``) that
  refuses every host read
  (``aten::_local_scalar_dense``, ``is_nonzero``, ``nonzero``, a copy to
  another device): dense; blocktopk fused through the kernels' twins and
  two-pass; two aggregation groups; partial participation; a crash trace
  with corruption and a norm clip; heterogeneous step counts with a
  decaying η_l; randk; a sharded server state; within-client data
  parallelism. The model has two leaves inserted out of sorted order.
* **(b)** ``FederatedTrainer(mesh=...).run(scan_rounds=3)`` over 4 rounds
  (chunks of 3 and 1) makes one program and gives the loop's history and
  state, to the bit.
* **(c)** Donation: the state returned is the program's carry, the input
  state's own tensors; another state passed in is copied into the carry.
* **(d)** A host read planted in the body is caught.
* **(e)** Against the reference: the port's ``FederatedTrainer(mesh=...)
  .run(scan_rounds=3)`` against the JAX trainer's (``lax.scan`` inside
  ``shard_map``) in the four configurations of
  ``tests/test_scan_driver.py::test_trainer_scan_rounds_mesh_backend``, on
  its tiny dense LM, from params staged with numpy into the JAX trainer
  and converted by ``convert.model_params_from_jax``; the heterogeneous
  step counts are the reference's draws, patched into the port's (ROADMAP
  Queue 3 item 13). Tolerances are stated at the assert.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from host_reads import NoHostReads
from repro_torch import disable_graphs
from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core import mesh as meshmod
from repro_torch.kernels.ops import KernelImpl
from repro_torch.models.params import ParamDef
from repro_torch.sharding.rules import ParallelContext
from test_torch_mesh import spawn

torch.set_num_threads(1)

FIELDS = ("params", "m", "v", "vhat", "errors")
M, D, DB, BC, K, R = 8, 2176, 24, 2, 2, 4
SEL = dict(algorithm="fedcams", aggregation="sparse")

class TwoLeafModel:
    """``loss = 0.5·Σ(w − t)² + 0.5·Σ(b − t[:, :DB])²`` over the batch
    rows: a (D,) leaf of two 2048-blocks and a small (DB,) one, inserted
    out of sorted order (the program pairs leaves by path)."""

    tp = 1

    def defs(self):
        return {"w": ParamDef((D,), dtype="float32"),
                "b": ParamDef((DB,), dtype="float32")}

    def loss(self, p, b, ctx, remat_policy="none", chunk=0):
        t = b["t"]
        dw = p["w"][None, :] - t
        db = p["b"][None, :] - t[:, :DB]
        return 0.5 * (dw * dw).sum() + 0.5 * (db * db).sum(), ()

    def train_batch_defs(self, global_batch, seq_len):
        return {"t": ParamDef((global_batch, D))}


class Targets:
    """``lm_data``: round r's (K, GB, D) targets, drawn from r."""

    def mesh_batch(self, r, local_steps, global_batch, seq_len):
        rng = np.random.default_rng(2000 + r)
        t = rng.normal(size=(local_steps, global_batch, D))
        return {"t": (np.round(t * 4.0) / 4.0).astype(np.float32)}


def _fed(m: int = M, **kw) -> FedConfig:
    base = dict(compress_ratio=1 / 8, local_steps=K, num_clients=m,
                eta=0.25, eta_l=0.0625, client_axes=("data",))
    base.update(kw)
    return FedConfig(**base)


#: name → (FedConfig kwargs, mesh shape, axes, kernel-routed)
GRID = {
    "dense": (dict(algorithm="fedams", compressor="none"), (M,), ("data",),
              False),
    "fused-kernel": (dict(SEL, compressor="blocktopk",
                          mesh_sparse_impl="kernel", fused_ingest="kernel",
                          track_gamma=False), (M,), ("data",), True),
    "two-pass": (dict(SEL, compressor="blocktopk", fused_ingest="off"),
                 (M,), ("data",), False),
    "groups-2": (dict(SEL, compressor="blocktopk", agg_groups=2,
                      client_axes=("cgroup", "data")), (2, M // 2),
                 ("cgroup", "data"), False),
    "partial": (dict(SEL, compressor="blocktopk", participating=5), (M,),
                ("data",), False),
    "crash-corrupt-clip": (dict(SEL, compressor="blocktopk",
                                track_gamma=False, fault=FaultConfig(
                                    crash_trace=((1, 0, 2), (6, 1, 3)),
                                    corrupt_prob=0.4, corrupt_mode="bitflip",
                                    max_update_norm=6.0)),
                           (M,), ("data",), False),
    "hetero-decay": (dict(SEL, compressor="blocktopk", local_steps=3,
                          local_steps_min=1, eta_l_decay=0.9), (M,),
                     ("data",), False),
    "randk": (dict(algorithm="fedcams", compressor="randk",
                   aggregation="dense"), (M,), ("data",), False),
    "shard": (dict(SEL, compressor="blocktopk", shard_server_state=True,
                   state_shards=M), (M,), ("data",), False),
    # 4 clients on ("pod",), each two data-parallel ranks
    "data-parallel": (dict(SEL, compressor="blocktopk", num_clients=4,
                           client_axes=("pod",)), (4, 2), ("pod", "data"),
                      False),
}


def _host_state(st) -> dict:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().clone()
    return {f: conv(getattr(st, f)) for f in FIELDS}


def _setup(name):
    from repro_torch.launch.mesh import make_mesh
    kw, shape, axes, kernel = GRID[name]
    kw = dict(kw)
    fed = _fed(kw.pop("num_clients", M), **kw)
    m = fed.num_clients
    mesh = make_mesh(shape, axes, "cpu")
    dp = (dict(zip(axes, shape)).get("data", 1)
          if "data" not in fed.client_axes else 1)
    ctx = ParallelContext(client_axes=fed.client_axes, num_clients=m,
                          data_axis="data" if dp > 1 else None, dp=dp,
                          mesh=mesh)
    train = TrainConfig(global_batch=M * BC, seq_len=1, remat_policy="none")
    model = TwoLeafModel()
    rnd = meshmod.build_fed_round(
        model, fed, train, ctx,
        kernel_impl=KernelImpl(device="cpu") if kernel else None)
    return fed, model, train, ctx, rnd


def _guarded(step, seen: list):
    """``_RoundsProgram.step`` (the round body and its write into the
    carry) under :class:`NoHostReads`, each call's ``write`` appended to
    ``seen``."""

    def guarded(self, write=True):
        seen.append(write)
        with NoHostReads():
            return step(self, write)

    return guarded


@pytest.fixture
def guarded_steps(monkeypatch):
    """Every program step guarded; yields the list of guarded steps."""
    seen = []
    monkeypatch.setattr(meshmod._RoundsProgram, "step",
                        _guarded(meshmod._RoundsProgram.step, seen))
    return seen


def _guard_steps():
    """The same guard in a spawned rank; returns the list of steps."""
    seen = []
    meshmod._RoundsProgram.step = _guarded(meshmod._RoundsProgram.step, seen)
    return seen


def grid_worker(rank, world, names):
    """Each case on this rank: R rounds of ``fed_round`` (the loop), then
    from the same init one call of the program (its steps guarded); rank 0
    returns both global states, both metrics and the steps' count."""
    seen = _guard_steps()
    data = Targets()
    out = {}
    for name in names:
        fed, model, train, ctx, rnd = _setup(name)
        init = lambda: meshmod.init_fed_state(
            model, fed, torch.Generator().manual_seed(0), ctx, "cpu")
        raws = [data.mesh_batch(r, fed.local_steps, M * BC, 1)
                for r in range(R)]
        state, loop = init(), []
        for r, raw in enumerate(raws):
            state, met = rnd(state, meshmod.shard_batch(
                raw, model, fed, train, ctx, "cpu"), r)
            loop.append({k: v.clone() for k, v in met.items()})
        loop_state = meshmod.gather_fed_state(state, model, fed, ctx)
        scan = meshmod.build_fed_rounds_scan(rnd)
        staged = {"t": np.stack([raw["t"] for raw in raws])}
        del seen[:]
        pstate, stacked = scan(init(), meshmod.shard_batch(
            staged, model, fed, train, ctx, "cpu", staged=True),
            torch.arange(R, dtype=torch.int32))
        prog_state = meshmod.gather_fed_state(pstate, model, fed, ctx)
        out[name] = dict(loop=_host_state(loop_state),
                         prog=_host_state(prog_state), loop_met=loop,
                         prog_met=stacked, steps=list(seen),
                         captured=scan.last["captured"])
    out["trainer"] = trainer_run(world)
    return out


def trainer_run(world):
    """(b): ``FederatedTrainer(mesh=...)`` twice from one config: the loop,
    and ``scan_rounds=3`` over 4 rounds (chunks of 3 and 1)."""
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), "cpu")
    fed = _fed(world, **SEL, compressor="blocktopk")
    train = TrainConfig(global_batch=world * BC, seq_len=1,
                        remat_policy="none", rounds=4)
    kw = dict(fed=fed, train=train, model=TwoLeafModel(), mesh=mesh,
              lm_data=Targets(), device="cpu")
    loop = FederatedTrainer(**kw)
    with disable_graphs():      # the eager loop of fed_round
        hist_loop = loop.run(log=None)
    staged = FederatedTrainer(**kw)
    carries = []
    saved = meshmod.MeshRounds.__call__

    def spy(self, state, batches, seeds):
        out = saved(self, state, batches, seeds)
        carries.append((len(seeds), self.last["program"], out[0]))
        return out

    meshmod.MeshRounds.__call__ = spy
    try:
        hist_staged = staged.run(scan_rounds=3, log=None)
    finally:
        meshmod.MeshRounds.__call__ = saved
    gather = lambda t: _host_state(meshmod.gather_fed_state(
        t._state, t.model, fed, t._ctx))
    return dict(loop=hist_loop, staged=hist_staged,
                chunks=[c[0] for c in carries],
                programs=len(staged._scan.programs),
                one_program=carries[0][1] is carries[1][1],
                one_carry=carries[0][2] is carries[1][2] is staged._state,
                loop_state=gather(loop), staged_state=gather(staged))


@pytest.fixture(scope="module")
def grid():
    return spawn(grid_worker, M, list(GRID))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_state(a, b) -> list:
    return [f for f in FIELDS if not all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(_flat(a[f]),
                                                        _flat(b[f])))]


@pytest.mark.parametrize("name", list(GRID))
def test_program_equals_the_loop_bitwise(grid, name):
    """(a) R = 4 rounds of the program from the init equal 4 ×
    ``fed_round`` from it to the bit: params, m, v, v̂, all EF rows
    (gathered) and every metric of every round (compared as int32 bit
    patterns). On gloo the program runs the staged body eagerly
    (``captured`` false), R guarded steps, none a warm-up, and no step
    read the host."""
    case = grid[name]
    assert case["captured"] is False
    assert case["steps"] == [True] * R
    assert not _same_state(case["loop"], case["prog"]), \
        (name, _same_state(case["loop"], case["prog"]))
    assert sorted(case["prog_met"]) == sorted(case["loop_met"][0])
    for key, col in case["prog_met"].items():
        assert col.shape == (R,) and col.device.type == "cpu"
        for r in range(R):
            assert torch.equal(_bits(col[r]),
                               _bits(case["loop_met"][r][key].reshape(()))), \
                (name, key, r)
    if name == "crash-corrupt-clip":
        assert float(case["prog_met"]["rejected"].sum()) > 0
        assert float(case["prog_met"]["survivors"].min()) < M


def test_chunks_reuse_one_program_and_give_the_loop(grid):
    """(b) ``scan_rounds=3`` over 4 rounds: chunks of 3 and 1 through one
    program (its capacity 3 covers the chunk of 1), whose carry is the
    trainer's state after each; the history (loss, wire bytes, round) and
    the final state equal the loop's to the bit."""
    tr = grid["trainer"]
    assert tr["chunks"] == [3, 1]
    assert tr["programs"] == 1 and tr["one_program"] and tr["one_carry"]
    assert tr["loop"] == tr["staged"] and len(tr["loop"]) == 4
    assert not _same_state(tr["loop_state"], tr["staged_state"])


# -- donation and the planted host read: one process, no mesh ---------------


def _one_client():
    fed = _fed(1, **SEL, compressor="blocktopk", client_axes=())
    ctx = ParallelContext()
    train = TrainConfig(global_batch=BC, seq_len=1, remat_policy="none")
    model = TwoLeafModel()
    rnd = meshmod.build_fed_round(model, fed, train, ctx)
    init = lambda seed: meshmod.init_fed_state(
        model, fed, torch.Generator().manual_seed(seed), ctx, "cpu")
    data = Targets()
    batches = lambda r0, n: meshmod.shard_batch(
        {"t": np.stack([data.mesh_batch(r, K, BC, 1)["t"]
                        for r in range(r0, r0 + n)])},
        model, fed, train, ctx, "cpu", staged=True)
    return fed, model, train, ctx, rnd, init, batches


def _leaves(st):
    return [t for f in FIELDS for t in _flat(getattr(st, f))] + [st.round]


def test_the_returned_state_is_the_carry(guarded_steps):
    """(c) The first call adopts the input state's tensors as the carry
    and returns them (no second copy of the state: the input is
    consumed); the returned state passed back is the carry, with nothing
    copied; another state passed in is copied into the carry, which the
    call returns, and the rounds from it equal the loop's from it."""
    fed, model, train, ctx, rnd, init, batches = _one_client()
    scan = meshmod.build_fed_rounds_scan(rnd)
    st0 = init(0)
    ids = [id(t) for t in _leaves(st0)]
    st1, _ = scan(st0, batches(0, 2), [0, 1])
    assert [id(t) for t in _leaves(st1)] == ids
    assert int(st1.round) == 2
    st2, _ = scan(st1, batches(2, 2), [2, 3])
    assert st2 is st1 and int(st2.round) == 4
    other = init(1)
    st3, met = scan(other, batches(0, 2), [0, 1])
    assert [id(t) for t in _leaves(st3)] == ids
    assert all(a is not b for a, b in zip(_leaves(st3), _leaves(other)))
    want, losses = init(1), []
    for r in range(2):
        want, m = rnd(want, {"t": batches(r, 1)["t"][0]}, r)
        losses.append(m["loss"])
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in
               zip(_leaves(st3)[:-1], _leaves(want)[:-1]))
    assert torch.equal(met["loss"], torch.stack(losses))
    assert len(scan.programs) == 1 and guarded_steps == [True] * 6


def test_a_planted_host_read_is_caught(guarded_steps):
    """(d) A body that reads a value on the host after the round (here
    ``float(loss)``, what a logging line would do) fails under the guard
    the grid runs in, naming the op."""
    fed, model, train, ctx, rnd, init, batches = _one_client()
    body = rnd.body

    def leaky(state, batch, inp):
        new, met = body(state, batch, inp)
        float(met["loss"])
        return new, met

    rnd.body = leaky
    scan = meshmod.build_fed_rounds_scan(rnd)
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        scan(init(0), batches(0, 2), [0, 1])


def test_the_choice_is_made_from_device_and_backend():
    """Capture only on CUDA with NCCL, or on CUDA with no mesh; on the CPU
    never."""
    ctx = ParallelContext()
    assert meshmod.captures_rounds("cpu", ctx) is False
    assert meshmod.captures_rounds("cuda", ctx) is True


# -- against the reference's scan ----------------------------------------------

#: tests/test_scan_driver.py::test_trainer_scan_rounds_mesh_backend's cases
JAX_CASES = {"sgd": {}, "sgdm": {"local_opt": "sgdm"},
             "prox": {"local_opt": "prox"},
             "decay-hetero": {"eta_l_decay": 0.9, "local_steps_min": 1}}
LM = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
LM_FED = dict(algorithm="fedams", num_clients=1, local_steps=2,
              client_axes=(), eta=0.3, eta_l=0.05)
LM_TRAIN = dict(global_batch=4, seq_len=16, rounds=5, remat_policy="none",
                log_every=100)


def _staged_jax_params(model):
    """The model's params drawn with numpy from a seed, as JAX arrays (the
    draw of ``tests/test_torch_lm_train.py``): the JAX init keys its
    leaves by Python's salted ``hash()``, a new draw in every process
    (ROADMAP Queue 3 item 3), so every run compares the same rounds."""
    import jax
    import jax.numpy as jnp

    from repro.models import params as jparams
    flat, td = jax.tree_util.tree_flatten(model.defs(),
                                          is_leaf=jparams.is_def)
    leaves = []
    for i, d in enumerate(flat):
        if d.init in ("zeros", "ones"):
            a = (np.zeros if d.init == "zeros" else np.ones)(d.shape, d.dtype)
        else:
            a = (np.random.default_rng((0, i)).standard_normal(d.shape)
                 * d.scale).astype(d.dtype)
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(td, leaves)


def _jax_run(fed_kw):
    """The reference's mesh trainer with ``scan_rounds=3`` (its test's
    configuration) from a staged init: the init, the history, the final
    state, and the step counts its rounds draw (``hetero_step_counts`` of
    ``fold_in(PRNGKey(0), seed)``, the mesh round's key)."""
    import jax

    from repro.configs.base import FedConfig as JFed
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import TrainConfig as JTrain
    from repro.core.api import FederatedTrainer as JTrainer
    from repro.core.local import hetero_step_counts
    from repro.data.synthetic import FederatedLMData
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    fed = JFed(**LM_FED, **fed_kw)
    tr = JTrainer(fed=fed, train=JTrain(**LM_TRAIN),
                  model=Model(JModelConfig(**LM), tp=1),
                  mesh=make_mesh((1, 1), ("data", "model")))
    tr.lm_data = FederatedLMData(num_clients=1, vocab_size=64)
    tr._state = tr._state._replace(params=_staged_jax_params(tr.model))
    init = jax.tree.map(np.asarray, tr._state.params)
    hist = tr.run(scan_rounds=3, log=None)
    ks = [None if fed.local_steps_min == 0 else int(np.asarray(
        hetero_step_counts(fed, jax.random.fold_in(jax.random.PRNGKey(0), r),
                           1))[0]) for r in range(LM_TRAIN["rounds"])]
    final = {f: jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                             getattr(tr._state, f))
             for f in ("params", "m", "v", "vhat")}
    return init, [h["loss"] for h in hist], final, ks


def port_lm_worker(rank, world, cases):
    """The port's mesh trainer on one gloo rank, each case from the JAX
    init with the JAX step counts patched in, ``scan_rounds=3``, every
    program step under :class:`NoHostReads`."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import model_params_from_jax
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    out = {}
    seen = _guard_steps()
    saved = meshmod.hetero_step_counts
    for name, (fed_kw, init, ks) in cases.items():
        del seen[:]
        tr = FederatedTrainer(
            fed=FedConfig(**LM_FED, **fed_kw), train=TrainConfig(**LM_TRAIN),
            model=Model(ModelConfig(**LM), tp=1),
            mesh=make_mesh((1, 1), ("data", "model"), "cpu"),
            lm_data=FederatedLMData(num_clients=1, vocab_size=64),
            device="cpu")
        tr._state = tr._state._replace(
            params=model_params_from_jax(init, "cpu"))
        draws = iter(ks)
        if ks[0] is not None:
            meshmod.hetero_step_counts = lambda fed, gen, count: \
                torch.full((count,), next(draws), dtype=torch.int64)
        try:
            hist = tr.run(scan_rounds=3, log=None)
        finally:
            meshmod.hetero_step_counts = saved
        out[name] = dict(
            loss=[h["loss"] for h in hist],
            state={f: _host_state(tr._state)[f] for f in FIELDS[:4]},
            programs=len(tr._scan.programs), steps=list(seen))
    return out


@pytest.fixture(scope="module")
def jax_vs_port_lm():
    jx = {name: _jax_run(kw) for name, kw in JAX_CASES.items()}
    cases = {name: (JAX_CASES[name], jx[name][0], jx[name][3])
             for name in JAX_CASES}
    return jx, spawn(port_lm_worker, 1, cases)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_scan_rounds_track_the_reference_scan(jax_vs_port_lm, name):
    """(e) 5 rounds in chunks of 3 and 2 through one program on each side,
    from the same init: the losses within 1e-6 relative every round (two
    fp32 transformers summing in their own orders); at the end the params
    within 1e-5 of each leaf's largest value, as
    ``tests/test_torch_mesh.py`` holds the mesh's params after R rounds
    from the JAX init; m, v, v̂ within 1e-4 of each leaf's largest value,
    as ``tests/test_torch_lm_train.py`` holds the LM round's: the local
    deltas differ in the last bits of the params they are taken from, and
    m and v carry that at the deltas' scale."""
    jx, port = jax_vs_port_lm
    _, jloss, jfinal, _ = jx[name]
    got = port[name]
    assert got["programs"] == 1
    assert got["steps"] == [True] * LM_TRAIN["rounds"]   # none read the host
    assert len(got["loss"]) == len(jloss) == LM_TRAIN["rounds"]
    for r, (a, b) in enumerate(zip(got["loss"], jloss)):
        assert a == pytest.approx(b, rel=1e-6), (name, r, a, b)
    for f in ("params", "m", "v", "vhat"):
        want = {"/".join(p): a for p, a in _paths(jfinal[f])}
        have = {"/".join(p): t.numpy() for p, t in _paths(got["state"][f])}
        assert sorted(want) == sorted(have), f
        tol = 1e-5 if f == "params" else 1e-4
        for key, a in want.items():
            np.testing.assert_allclose(
                have[key], a, rtol=0, atol=tol * np.abs(a).max(),
                err_msg=f"{name} {f} {key}")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# -- the zoo through the program -------------------------------------------------

ZOO = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
       "recurrentgemma-2b", "xlstm-350m")


def zoo_worker(rank, world):
    """Each zoo smoke config through ``launch/train.py``'s ``train``, the
    loop and then ``scan_rounds=3``, on one gloo rank (the train CLI's
    fedcams, blockwise top-k 1/64 over the sparse collective, the kernels'
    twins), every program step under :class:`NoHostReads`."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as ttrain
    seen = _guard_steps()
    ap = ttrain.parser()
    fed = ttrain.build_fed(ap.parse_args(
        ["--dp", "1", "--compressor", "topk", "--aggregation", "sparse",
         "--mesh-sparse-impl", "kernel", "--fused-ingest", "kernel"]), ap)
    train = TrainConfig(global_batch=2, seq_len=16, rounds=3,
                        remat_policy="none")
    key = lambda out: [(h["round"], h["loss"], h["wire_up_bytes"])
                       for h in out["history"]]
    res = {}
    for arch in ZOO:
        cfg = get_arch(arch).smoke
        del seen[:]
        with disable_graphs():      # the eager loop of fed_round
            loop = ttrain.train(cfg, fed, train, device="cpu", log=None)
        staged = ttrain.train(cfg, fed, train, device="cpu", scan_rounds=3,
                              log=None)
        res[arch] = dict(loop=key(loop), staged=key(staged),
                         steps=list(seen), finite=staged["finite"])
    return res


@pytest.fixture(scope="module")
def zoo():
    return spawn(zoo_worker, 1)


@pytest.mark.parametrize("arch", ZOO)
def test_the_zoo_runs_through_the_program(zoo, arch):
    """The five model families' smoke configs (attention, MoE, MLA + MTP,
    RG-LRU, xLSTM): 3 rounds as one program call give the loop's losses
    and wire bytes to the bit, and no step of the program reads the host
    (the dispatch mode over the whole round: the model's forward and
    backward, the kernels' twins, the collectives)."""
    r = zoo[arch]
    assert r["steps"] == [True] * 3
    assert r["staged"] == r["loop"] and len(r["loop"]) == 3 and r["finite"]


@pytest.mark.parametrize("vocab", [256_000, 50_304])
def test_lm_data_draws_the_reference_tokens_at_published_vocabularies(vocab):
    """The port's ``FederatedLMData`` searches each draw in a client's
    cumulative sum made once (numpy's ``Generator.choice`` with ``p``
    makes it every call): the same tokens as the reference's at gemma2's
    and xlstm's vocabularies, bitwise."""
    from repro.data.synthetic import FederatedLMData as JaxLMData
    from repro_torch.data.synthetic import FederatedLMData
    a = FederatedLMData(num_clients=2, vocab_size=vocab, seed=3)
    b = JaxLMData(num_clients=2, vocab_size=vocab, seed=3)
    for got, want in ((a.mesh_batch(1, 2, 4, 32), b.mesh_batch(1, 2, 4, 32)),
                      (a.client_batch(1, 7, 3, 16),
                       b.client_batch(1, 7, 3, 16))):
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
