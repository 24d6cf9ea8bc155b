"""The port's mesh backend (``repro_torch.core.mesh``) on CPU ranks over
gloo, against the JAX mesh and against the port's own FedSim.

Each grid is one spawn of its ranks (``spawn``): every case of the grid
runs inside the same processes, one ``DeviceMesh`` per case, and rank 0
returns the global state after every round (``gather_fed_state``).

* **Against the JAX mesh** (``tests/mesh_parity_harness.py``'s
  ``ParityModel``, D, M, K, R, η, η_l, targets and ``CASES``, imported,
  not edited): the JAX side runs in a ``run_forced_devices`` subprocess on
  8 forced host devices and writes its own init and every round's state;
  the port starts from that init on 8 ranks. The cases whose reference
  parity test passes here: dense, topk, blocktopk, packedsign and
  blocktopk_fused (full participation: JAX's participation draw is all
  ones, so there is nothing to patch). Tolerances, each stated at its
  assert: EF rows (the per-round selection, see the harness docstring)
  and ``wire_up_bytes`` bitwise on the Selection cases, each round
  restarted from the JAX state before it; m, v and v̂ within one rounding
  a round (ROADMAP Queue 3 item 1: the jitted JAX server step contracts
  into FMAs), params within the bound its reciprocal square root needs;
  per-round loss within 1e-6 relative.
* **Against the port's FedSim, bitwise** on the Selection paths at fp32
  and bf16 state: topk and blocktopk, fused and two-pass (plain and
  kernel-routed, the kernels' twins on the CPU); hierarchical at
  ``agg_groups`` 2 and 4 against ``server_aggregate_sparse_grouped``;
  n < m with the participation mask patched; a crash trace; corruption
  with a norm clip against ``FedSim._fault_round`` on the mesh's own
  draws; within-client data parallelism. Dense and packedsign within a stated tolerance (the all-reduce
  order is free).
* The refusals, with the reference's messages, and ``ParallelContext``'s
  collectives on 4 ranks against numpy.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mesh_parity_harness import (BC, CASES, D, ETA, ETA_L, K, M, R, RATIO,
                                 _round_targets, _sim_batches)
from repro_torch.comm.faults import (FaultConfig, FaultPlan,
                                     mesh_corruption_plan, mesh_fault_mask)
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import mesh_state_from_jax
from repro_torch.core import mesh as meshmod
from repro_torch.core.sim import FedSim
from repro_torch.kernels.ops import KernelImpl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import ParamDef
from repro_torch.sharding.rules import ParallelContext

FIELDS = ("params", "m", "v", "vhat", "errors")


# -- the model and data the mesh tests share ---------------------------------


class ParityModel:
    """The harness's single-leaf model in torch: ``loss = 0.5·Σ(w − t)²``
    over B = 2 rows, whose gradient ``(w − t₀) + (w − t₁)`` has no
    reassociation freedom (see ``tests/mesh_parity_harness.py``)."""

    tp = 1

    def __init__(self, d: int = D):
        self.d = d

    def defs(self):
        return {"w": ParamDef((self.d,), dtype="float32")}

    def loss(self, p, b, ctx, remat_policy="none", chunk=0):
        diff = p["w"][None, :] - b["t"]
        return 0.5 * (diff * diff).sum(), ()

    def train_batch_defs(self, global_batch, seq_len):
        return {"t": ParamDef((global_batch, self.d))}


class TargetData:
    """``lm_data`` for the trainer: round r's (K, GB, D) targets."""

    def __init__(self, m: int, d: int = D):
        self.m, self.d = m, d

    def mesh_batch(self, r, local_steps, global_batch, seq_len):
        rng = np.random.default_rng(1000 + r)
        t = rng.normal(size=(local_steps, global_batch, self.d))
        return {"t": (np.round(t * 4.0) / 4.0).astype(np.float32)}


def train_cfg(m: int = M) -> TrainConfig:
    return TrainConfig(global_batch=m * BC, seq_len=1, remat_policy="none")


def common(m: int = M, **kw) -> dict:
    base = dict(compress_ratio=RATIO, local_steps=K, num_clients=m, eta=ETA,
                eta_l=ETA_L)
    base.update(kw)
    return base


# -- spawning ranks -----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 600):
    """Run ``fn(rank, world, *args)`` on ``world`` CPU ranks over gloo and
    return rank 0's result. Any rank's failure fails the call."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(_entry, args=(world, _free_port(), fn, args,
                                               out),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.time() + timeout
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} ranks still running "
                                   f"after {timeout} s")
        return torch.load(out, weights_only=False)


# -- rank-side: one case of a grid -------------------------------------------


def _numpy_state(st) -> dict:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy().copy()
    return {f: conv(getattr(st, f)) for f in FIELDS}


def run_case(spec: dict) -> list:
    """One mesh run on the ranks of the world: ``spec`` holds ``fed`` (a
    FedConfig), ``shape``/``axes`` of the mesh, ``init`` (a global state
    in the JAX layout, or None for ``init_fed_state`` at seed 0),
    ``starts`` (a global state in the JAX layout to restart each round
    from, or None to run on), ``masks`` (per-round participation masks
    patched in, or None), ``kernel`` (hand the round a CPU
    ``KernelImpl``) and ``targets``. Returns, per round, the global state
    as numpy and the metrics."""
    fed = spec["fed"]
    m = fed.num_clients
    mesh = make_mesh(spec["shape"], spec["axes"], "cpu")
    # "data" outside the client axes: within-client data parallelism
    dp = (dict(zip(spec["axes"], spec["shape"])).get("data", 1)
          if "data" not in fed.client_axes else 1)
    ctx = ParallelContext(client_axes=fed.client_axes, num_clients=m,
                          data_axis="data" if dp > 1 else None, dp=dp,
                          mesh=mesh)
    model = ParityModel(spec.get("d", D))
    train = train_cfg(m)
    ki = KernelImpl(device="cpu") if spec.get("kernel") else None
    rnd = meshmod.build_fed_round(model, fed, train, ctx, kernel_impl=ki)
    if spec.get("init") is not None:
        state = meshmod.shard_fed_state(mesh_state_from_jax(spec["init"]),
                                        model, fed, ctx, "cpu")
    else:
        state = meshmod.init_fed_state(model, fed,
                                       torch.Generator().manual_seed(0), ctx,
                                       "cpu")
    masks = spec.get("masks")
    saved = meshmod.participation_mask
    rows = []
    try:
        for r, t in enumerate(spec["targets"]):
            if masks is not None:
                meshmod.participation_mask = (
                    lambda g, mm, n, mk=masks[r]: torch.tensor(mk))
            if spec.get("starts") is not None:
                state = meshmod.shard_fed_state(
                    mesh_state_from_jax(spec["starts"][r]), model, fed, ctx,
                    "cpu")
            batch = meshmod.shard_batch({"t": t}, model, fed, train, ctx,
                                        "cpu")
            state, met = rnd(state, batch, r)
            full = meshmod.gather_fed_state(state, model, fed, ctx)
            rows.append(dict(_numpy_state(full),
                             **{k: float(v) for k, v in met.items()}))
    finally:
        meshmod.participation_mask = saved
    return rows


def grid_worker(rank, world, specs):
    return {name: run_case(spec) for name, spec in specs.items()}


def trainer_worker(rank, world, path):
    """``FederatedTrainer(mesh=...)`` twice on the same config: a loop of
    rounds and staged rounds (``scan_rounds=3``); the first saves."""
    from repro_torch.convert import mesh_state_to_jax
    from repro_torch.core.api import FederatedTrainer
    mesh = make_mesh((world,), ("data",), "cpu")
    fed = FedConfig(client_axes=("data",), compressor="blocktopk",
                    **common(world, **SEL))
    train = dataclasses.replace(train_cfg(world), rounds=4)
    kw = dict(fed=fed, train=train, model=ParityModel(), mesh=mesh,
              lm_data=TargetData(world), device="cpu")
    loop = FederatedTrainer(**kw)
    hist_loop = loop.run(log=None)
    staged = FederatedTrainer(**kw)
    hist_staged = staged.run(scan_rounds=3, log=None)
    loop.save(path)
    same = meshmod.gather_fed_state(staged._state, ParityModel(), fed,
                                    loop._ctx)
    return dict(loop=hist_loop, staged=hist_staged,
                state=mesh_state_to_jax(meshmod.gather_fed_state(
                    loop._state, ParityModel(), fed, loop._ctx)),
                staged_state=mesh_state_to_jax(same))


# -- against the JAX mesh ------------------------------------------------------

JAX_CASES = ("dense", "topk", "blocktopk", "packedsign", "blocktopk_fused")

_JAX_SIDE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from mesh_parity_harness import (BC, CASES, ETA, ETA_L, K, M, R, RATIO,
                                 ParityModel, _round_targets)
from repro import compat
from repro.configs.base import FedConfig, TrainConfig
from repro.core.mesh import (build_fed_round, fed_batch_defs, fed_state_defs,
                             init_fed_state)
from repro.launch.mesh import make_mesh
from repro.models import params as pdefs
from repro.sharding.rules import ParallelContext

out = {}
model = ParityModel()
train = TrainConfig(global_batch=M * BC, seq_len=1, remat_policy="none")
mesh = make_mesh((M,), ("data",))
ctx = ParallelContext(client_axes=("data",), num_clients=M)
for name in %(names)r:
    fed = FedConfig(client_axes=("data",), compress_ratio=RATIO,
                    local_steps=K, num_clients=M, eta=ETA, eta_l=ETA_L,
                    **CASES[name])
    sdefs = fed_state_defs(model, fed)
    ssp = jax.tree.map(lambda d: d.spec, sdefs, is_leaf=pdefs.is_def)
    bsp = jax.tree.map(lambda d: d.spec, fed_batch_defs(model, fed, train),
                       is_leaf=pdefs.is_def)
    rnd = jax.jit(compat.shard_map(
        build_fed_round(model, fed, train, ctx), mesh=mesh,
        in_specs=(ssp, bsp, P()),
        out_specs=(ssp, {"loss": P(), "wire_up_bytes": P()})))
    state = init_fed_state(model, fed, jax.random.PRNGKey(0))
    out[name + "/init"] = np.asarray(state.params["w"])
    for r in range(R):
        state, met = rnd(state, {"t": jnp.asarray(_round_targets(r))},
                         jnp.int32(r))
        for f in ("params", "m", "v", "vhat", "errors"):
            out[f"{name}/{r}/{f}"] = np.asarray(
                getattr(state, f)["w"]).astype(np.float32)
        out[f"{name}/{r}/loss"] = np.float32(met["loss"])
        out[f"{name}/{r}/wire_up_bytes"] = np.float32(met["wire_up_bytes"])
np.savez(%(path)r, **out)
print("ok")
"""


def _jax_state(jx, name, r):
    """The JAX mesh's global state after round r (r = -1: its init)."""
    if r < 0:
        z = {"w": np.zeros(D, np.float32)}
        return dict(params={"w": jx[f"{name}/init"]}, m=z, v=z, vhat=z,
                    errors={"w": np.zeros((M, D), np.float32)},
                    round=np.int32(0))
    get = lambda f: {"w": jx[f"{name}/{r}/{f}"]}
    return dict(params=get("params"), m=get("m"), v=get("v"),
                vhat=get("vhat"), errors=get("errors"), round=np.int32(r + 1))


@pytest.fixture(scope="module")
def jax_vs_port():
    """Both sides of the JAX comparison: the JAX mesh in a forced-devices
    subprocess (its own init and every round's state, written out), then
    the port's mesh on M CPU ranks, every case in one spawn, twice: each
    round restarted from the JAX state before it (``staged``), and R
    rounds run on from the JAX init (``free``)."""
    from conftest import run_forced_devices
    # the reference's init keys leaves by Python's salted hash() (ROADMAP
    # Queue 3 item 3): a fixed hash seed makes its init, and so this run,
    # the same every time
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "jax_mesh.npz")
            run_forced_devices(_JAX_SIDE % {"names": JAX_CASES,
                                            "path": path},
                               devices=M, timeout=900)
            jx = dict(np.load(path))
    finally:
        if saved is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = saved
    targets = [_round_targets(r) for r in range(R)]
    specs = {}
    for name in JAX_CASES:
        fed = FedConfig(client_axes=("data",), **common(), **CASES[name])
        base = dict(fed=fed, shape=(M,), axes=("data",), targets=targets)
        specs[name + "/staged"] = dict(
            base, starts=[_jax_state(jx, name, r - 1) for r in range(R)])
        specs[name + "/free"] = dict(base, init=_jax_state(jx, name, -1))
    return jx, spawn(grid_worker, M, specs)


def _spacing(*arrays):
    """One rounding at the largest magnitude among ``arrays``, elementwise
    (an operand's, the result's or the step's)."""
    mag = np.max(np.abs(np.stack([a.astype(np.float32) for a in arrays])),
                 axis=0)
    return np.spacing(mag)


@pytest.mark.parametrize("name", JAX_CASES)
def test_port_mesh_matches_the_jax_mesh(jax_vs_port, name):
    """The port's mesh against the JAX mesh on the harness's grid.

    Each round restarted from the JAX state before it (the stages):
    * EF rows bitwise on the Selection cases (topk, blocktopk,
      blocktopk_fused): the residual is the total with exactly the selected
      coordinates zeroed, so equal rows are equal selections (the harness
      docstring's argument); dense carries no EF (zeros, bitwise).
      packedsign's rows within 2 roundings of the round's largest EF
      value: the port sums ``‖tot‖₁`` by ``ref.sign_scale``'s trees, JAX by
      ``jnp.mean``, a few ulp apart, and the residual carries that.
    * ``wire_up_bytes`` bitwise.
    * m, v, v̂ within one rounding at the largest of the old value, the
      new one and the step, on the Selection cases: the jitted JAX step
      contracts ``β·m + (1−β)·Δ`` into an FMA (ROADMAP Queue 3 item 1).
      params within 8 such roundings: the jitted ``η·m/√v̂`` is not
      correctly rounded on XLA:CPU (measured up to 6 over 9 of the
      reference's inits, which differ per process unless the hash seed is
      fixed, as here). dense and packedsign, whose aggregate is summed in
      another order (the all-reduce; the scale), within 1e-5 of the
      largest value.
    * loss within 1e-6 relative (the Σ of the loss runs in another order).

    R rounds run on from the JAX init: loss within 1e-6 relative every
    round, params within 1e-5 of the largest value at the end.
    """
    jx, port = jax_vs_port
    for r, row in enumerate(port[name + "/staged"]):
        jv = lambda f: jx[f"{name}/{r}/{f}"]
        prev = _jax_state(jx, name, r - 1)
        assert row["wire_up_bytes"] == float(jv("wire_up_bytes")), r
        assert row["loss"] == pytest.approx(float(jv("loss")), rel=1e-6), r
        err = row["errors"]["w"]
        if name == "packedsign":
            np.testing.assert_allclose(
                err, jv("errors"), rtol=0,
                atol=2 * np.spacing(np.abs(jv("errors")).max()))
        else:
            assert np.array_equal(err, jv("errors")), (name, r)
        for f in ("params", "m", "v", "vhat"):
            got, want, old = row[f]["w"], jv(f), prev[f]["w"]
            if name in ("dense", "packedsign"):
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                    err_msg=f"{name} {f} round {r}")
                continue
            k = 8 if f == "params" else 1
            bad = np.abs(got - want) > k * _spacing(want, old, want - old)
            assert not bad.any(), (name, f, r, int(bad.sum()))
    for r, row in enumerate(port[name + "/free"]):
        assert row["loss"] == pytest.approx(
            float(jx[f"{name}/{r}/loss"]), rel=1e-6), (name, r)
    want = jx[f"{name}/{R - 1}/params"]
    np.testing.assert_allclose(port[name + "/free"][-1]["params"]["w"], want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


# -- against the port's FedSim ------------------------------------------------

SEL = dict(algorithm="fedcams", aggregation="sparse")


def _fedsim_grid():
    """name → (mesh FedConfig kwargs, FedSim FedConfig kwargs, mesh
    shape/axes, extras). FedSim takes blocktopk where the mesh takes topk
    (the mesh's documented remap)."""
    g = {}
    for comp in ("topk", "blocktopk"):
        for sd in ("float32", "bfloat16"):
            for fused in ("jnp", "off"):
                g[f"{comp}-{sd}-{fused}"] = (
                    dict(SEL, compressor=comp, server_state_dtype=sd,
                         fused_ingest=fused, track_gamma=fused == "off"),
                    dict(compressor="blocktopk", server_state_dtype=sd,
                         track_gamma=fused == "off",
                         fused_ingest="jnp" if fused == "jnp" else "auto"),
                    {})
    g["blocktopk-kernel-fused"] = (
        dict(SEL, compressor="blocktopk", mesh_sparse_impl="kernel",
             fused_ingest="kernel", track_gamma=False),
        dict(compressor="blocktopk", fused_ingest="kernel",
             track_gamma=False), dict(kernel=True))
    g["blocktopk-kernel-twopass"] = (
        dict(SEL, compressor="blocktopk", mesh_sparse_impl="kernel",
             fused_ingest="off"),
        dict(compressor="blocktopk"), dict(kernel=True))
    for groups in (2, 4):
        g[f"hier-{groups}"] = (
            dict(SEL, compressor="blocktopk", agg_groups=groups),
            dict(compressor="blocktopk", agg_groups=groups),
            dict(shape=(groups, M // groups), axes=("cgroup", "data")))
    # 4 clients on ("pod",), each two data-parallel ranks holding the same
    # rows: the data all-reduce / dp is then the one-shard gradient exactly
    g["data-parallel"] = (
        dict(SEL, compressor="blocktopk", num_clients=4,
             client_axes=("pod",)),
        dict(compressor="blocktopk", num_clients=4),
        dict(shape=(4, 2), axes=("pod", "data"), dp=2))
    g["partial"] = (
        dict(SEL, compressor="blocktopk", participating=5),
        dict(compressor="blocktopk", participating=5),
        dict(masks=True))
    g["crash-trace"] = (
        dict(SEL, compressor="blocktopk", track_gamma=False,
             fault=FaultConfig(crash_trace=((1, 0, 2), (6, 1, 3)))),
        dict(compressor="blocktopk", track_gamma=False,
             fault=FaultConfig(crash_trace=((1, 0, 2), (6, 1, 3)))), {})
    corrupt = FaultConfig(corrupt_prob=0.4, corrupt_mode="bitflip",
                          max_update_norm=6.0)
    g["corrupt-clip"] = (
        dict(SEL, compressor="blocktopk", track_gamma=False, fault=corrupt),
        dict(compressor="blocktopk", track_gamma=False, fault=corrupt), {})
    g["dense"] = (dict(algorithm="fedams", compressor="none"),
                  dict(algorithm="fedams", compressor="none"), {})
    g["packedsign"] = (dict(SEL, compressor="packedsign"),
                       dict(compressor="packedsign"), {})
    return g


FEDSIM_GRID = _fedsim_grid()
#: the partial-participation case's cohorts: 5 of 8, patched into the mesh
#: and handed to FedSim as its (sorted) client ids
PARTIAL = [(0, 2, 3, 5, 6), (1, 2, 4, 6, 7), (0, 1, 3, 4, 7)]


def _dp_targets(r):
    """Round r's (K, 8·BC, D) targets with the rows of data rank 1 of each
    client a copy of data rank 0's (the harness's targets, first half)."""
    t = _round_targets(r)[:, :4 * BC].reshape(K, 4, 1, BC, D)
    return np.concatenate([t, t], axis=2).reshape(K, 8 * BC, D)


def _mask(ids):
    m = np.zeros(M, np.float32)
    m[list(ids)] = 1.0
    return m.tolist()


@pytest.fixture(scope="module")
def mesh_vs_fedsim():
    targets = [_round_targets(r) for r in range(R)]
    specs = {}
    for name, (mkw, _, extra) in FEDSIM_GRID.items():
        axes = extra.get("axes", ("data",))
        mkw = dict(mkw)
        fed = FedConfig(**common(mkw.pop("num_clients", M),
                                 client_axes=mkw.pop("client_axes", axes)),
                        **mkw)
        specs[name] = dict(
            fed=fed, shape=extra.get("shape", (M,)), axes=axes,
            targets=[_dp_targets(r) for r in range(R)] if extra.get("dp")
            else targets, kernel=extra.get("kernel", False),
            masks=[_mask(ids) for ids in PARTIAL] if extra.get("masks")
            else None)
    return spawn(grid_worker, M, specs)


def _fault_plan_patch(sim, fcfg):
    """FedSim's planner replaced by the mesh's own draws for round r
    (seed r): the same survivors, flags, xor masks and cuts."""

    def plan(ids, r, timing=None):
        alive = mesh_fault_mask(fcfg, r, M, r).numpy()
        pl = mesh_corruption_plan(fcfg, r, M)
        fp = FaultPlan(
            survivors=alive,
            corrupt=pl.corrupt.numpy(),
            xor_bits=pl.xor_bits.numpy().view(np.uint32),
            trunc_keep=pl.trunc_keep.numpy())
        info = {"survivors": float(alive.sum()),
                "crashed": float(M - alive.sum()), "deadline_cut": 0.0}
        return fp, info

    sim.faults.plan = plan


def _run_fedsim(name):
    _, skw, extra = FEDSIM_GRID[name]
    skw = dict(skw)
    fed = FedConfig(client_axes=(), **common(skw.pop("num_clients", M)),
                    **skw)
    model = ParityModel()
    sim = FedSim(lambda p, b: model.loss(p, b, None), fed, device="cpu")
    init = meshmod.init_fed_state(model, fed, torch.Generator().manual_seed(0),
                                  ParallelContext(), "cpu")
    st = sim.init({"w": init.params["w"].clone()})
    if fed.fault is not None:
        _fault_plan_patch(sim, fed.fault)
    rows = []
    for r in range(R):
        ids = (np.array(PARTIAL[r]) if extra.get("masks")
               else np.arange(fed.num_clients))
        b = _sim_batches(_round_targets(r))[ids]
        st, met = sim.round(st, {"t": b}, ids)
        rows.append(dict(params=st.params.numpy().copy(),
                         m=st.opt.m.float().numpy().copy(),
                         v=st.opt.v.float().numpy().copy(),
                         vhat=st.opt.vhat.float().numpy().copy(),
                         errors=st.errors.numpy().copy(),
                         **{k: float(v) for k, v in met.items()}))
    return sim, rows


@pytest.mark.parametrize("name", [n for n in FEDSIM_GRID
                                  if n not in ("dense", "packedsign")])
def test_mesh_equals_fedsim_bitwise_on_selection_paths(mesh_vs_fedsim, name):
    """R rounds of the one-leaf model from one init: params, m, v, v̂ and
    all EF rows equal FedSim's to the bit every round, and so does the
    loss where both average the same clients (every case but the partial
    one: there the mesh's non-participants train too and enter its loss,
    as in JAX). The data-parallel case (``"data"`` outside the client
    axes, two ranks a client on the same rows) holds the layout — the
    batch cut, the data all-reduce / dp, the loss's pmean over data — to
    FedSim's one-shard client; the all-reduce's arithmetic is held by
    ``test_parallel_context_collectives_against_numpy``. Under faults the mesh's ``rejected`` equals FedSim's and
    its ``survivors`` (delivered) equal FedSim's survivors (delivered and
    valid) plus the rejected."""
    sim, srows = _run_fedsim(name)
    mrows = mesh_vs_fedsim[name]
    if name.startswith(("topk-", "blocktopk-")) and "off" not in name \
            and "twopass" not in name:
        assert sim._fused != "off"
    rejected = 0.0
    for r, (mr, sr) in enumerate(zip(mrows, srows)):
        for f in FIELDS:
            assert np.array_equal(mr[f]["w"], sr[f]), (name, f, r)
        if name != "partial":
            assert mr["loss"] == sr["loss"], (name, r)
        if "fault" in FEDSIM_GRID[name][0]:
            assert mr["rejected"] == sr["rejected"], (name, r)
            assert mr["survivors"] == sr["survivors"] + sr["rejected"]
            rejected += mr["rejected"]
    if name == "corrupt-clip":
        assert rejected > 0


@pytest.mark.parametrize("name", ["dense", "packedsign"])
def test_mesh_tracks_fedsim_on_dense_and_packedsign(mesh_vs_fedsim, name):
    """The dense psum (an all-reduce, order free) and the packed-sign
    gather (scales × signs summed over the gathered rows) against FedSim's
    mean of hats: EF rows bitwise (the hats are the same products: the
    scale is ``ref.sign_scale`` on both sides); params, m, v, v̂ within
    1e-6 of the largest value; loss bitwise (both average the clients'
    losses in client order)."""
    _, srows = _run_fedsim(name)
    for r, (mr, sr) in enumerate(zip(mesh_vs_fedsim[name], srows)):
        assert np.array_equal(mr["errors"]["w"], sr["errors"]), (name, r)
        assert mr["loss"] == sr["loss"], (name, r)
        for f in ("params", "m", "v", "vhat"):
            np.testing.assert_allclose(mr[f]["w"], sr[f], rtol=0,
                                       atol=1e-6 * np.abs(sr[f]).max(),
                                       err_msg=f"{name} {f} round {r}")


# -- refusals -------------------------------------------------------------------


def _build(**kw):
    fed = FedConfig(**common(kw.pop("num_clients", M)), **kw)
    ctx = ParallelContext(client_axes=fed.client_axes, num_clients=M)
    return meshmod.build_fed_round(ParityModel(), fed, train_cfg(), ctx)


@pytest.mark.parametrize("kw,err,match", [
    (dict(ef_store=True), ValueError, "ef_store is FedSim-only"),
    (dict(deadline_s=1.0, wire=True, track_gamma=False), ValueError,
     "deadline_s is FedSim wire-mode only"),
    (dict(SEL, compressor="packedsign", track_gamma=False,
          fault=FaultConfig(corrupt_prob=0.1)), ValueError,
     "corruption/validation on the mesh needs"),
    (dict(compressor="blocktopk", agg_groups=2), ValueError,
     "the two-level collective only exists"),
    (dict(SEL, compressor="blocktopk", agg_groups=2), ValueError,
     "needs >= 2 client axes"),
    (dict(SEL, compressor="blocktopk", agg_groups=4, participating=4,
          client_axes=("cgroup", "data"), num_clients=6), ValueError,
     "must divide the client-axis size"),
])
def test_refusals_carry_the_reference_messages(kw, err, match):
    with pytest.raises(err, match=match):
        _build(**kw)


def test_int8_state_and_tp_are_refused():
    """int8 server state has no mesh form; a model built at one tp on a
    context whose model axis has another is refused (the model axis runs:
    ``tests/test_torch_tp.py``)."""
    with pytest.raises(ValueError, match="simulation-only"):
        meshmod.fed_state_defs(ParityModel(),
                               FedConfig(server_state_dtype="int8"))
    fed = FedConfig(**common())
    with pytest.raises(ValueError, match="built for tp=1 but the "
                                         "context's model axis has tp=2"):
        meshmod.build_fed_round(ParityModel(), fed, train_cfg(),
                                ParallelContext(tp=2))
    wide = ParityModel()
    wide.tp = 2
    with pytest.raises(ValueError, match="built for tp=2"):
        meshmod.build_fed_round(wide, fed, train_cfg(), ParallelContext())


# -- ParallelContext -------------------------------------------------------------


def _x(rank):
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * rank


def context_worker(rank, world):
    """Every collective on a (2, 2) ("cgroup", "data") mesh."""
    mesh = make_mesh((2, 2), ("cgroup", "data"), "cpu")
    ctx = ParallelContext(client_axes=("cgroup", "data"), num_clients=4,
                          data_axis="data", dp=2, seq_axis="cgroup",
                          mesh=mesh)
    x = _x(rank)
    out = dict(
        client_index=ctx.client_index(),
        clients=ctx.all_gather_clients(x[None], axis=0),
        clients_dim1=ctx.all_gather_clients(x, axis=1),
        members=ctx.all_gather_members(x[None], axis=0),
        partials=ctx.all_gather_group_partials(x[None], axis=0),
        psum=ctx.psum_clients(x), pmean=ctx.pmean_clients(x),
        psum_data=ctx.psum_data(x), pmean_data=ctx.pmean_data(x),
        psum_seq=ctx.psum_seq(x), pmax_seq=ctx.pmax_seq(-x),
        seq_index=ctx.seq_index(),
        data_major=ctx.gather_axes(("data", "cgroup"), x[None]))
    tp = ParallelContext(model_axis="data", tp=2, mesh=mesh)
    w = torch.full((2, 3), float(rank + 1))
    xg = x.clone().requires_grad_(True)
    (tp.tp_copy(xg) * w).sum().backward()
    out.update(model_index=tp.model_index(), psum_model=tp.psum_model(x),
               pmax_model=tp.pmax_model(x),
               gather_model=tp.all_gather_model(x, axis=-1),
               tp_copy_fwd=tp.tp_copy(x), tp_copy_grad=xg.grad)
    # every rank's view, for the per-rank checks
    views = [None] * world
    dist.all_gather_object(views, out)
    return views


def test_parallel_context_collectives_against_numpy():
    """4 ranks on a (2, 2) ("cgroup", "data") mesh; rank r sits at
    (r // 2, r % 2) and holds x_r. Gathers are tiled in client-major order
    over the axes named (first most significant), the members' gather and
    the group partials' are the two single-axis cases, and tp_copy's
    backward sums the gradient over the model axis."""
    views = spawn(context_worker, 4)
    xs = np.stack([_x(r).numpy() for r in range(4)])
    for r, v in enumerate(views):
        g, d = divmod(r, 2)
        assert v["client_index"] == r
        np.testing.assert_array_equal(v["clients"], xs)
        np.testing.assert_array_equal(v["clients_dim1"],
                                      np.concatenate(list(xs), axis=1))
        np.testing.assert_array_equal(v["members"], xs[[2 * g, 2 * g + 1]])
        np.testing.assert_array_equal(v["partials"], xs[[d, 2 + d]])
        np.testing.assert_array_equal(v["data_major"], xs[[0, 2, 1, 3]])
        np.testing.assert_array_equal(v["psum"], xs.sum(0))
        np.testing.assert_array_equal(v["pmean"], xs.sum(0) / 4)
        pair = xs[[2 * g, 2 * g + 1]]
        np.testing.assert_array_equal(v["psum_data"], pair.sum(0))
        np.testing.assert_array_equal(v["pmean_data"], pair.sum(0) / 2)
        col = xs[[d, 2 + d]]
        np.testing.assert_array_equal(v["psum_seq"], col.sum(0))
        np.testing.assert_array_equal(v["pmax_seq"], (-col).max(0))
        assert v["seq_index"] == g and v["model_index"] == d
        np.testing.assert_array_equal(v["psum_model"], pair.sum(0))
        np.testing.assert_array_equal(v["pmax_model"], pair.max(0))
        np.testing.assert_array_equal(v["gather_model"],
                                      np.concatenate(list(pair), axis=-1))
        np.testing.assert_array_equal(v["tp_copy_fwd"], xs[r])
        # d/dx Σ w_r·x over the model pair: w of both ranks, summed
        np.testing.assert_array_equal(v["tp_copy_grad"],
                                      np.full((2, 3), float(2 * g + 1
                                                            + 2 * g + 2)))


def test_parallel_context_without_a_mesh_is_the_identity():
    ctx = ParallelContext(client_axes=("data",), num_clients=1,
                          model_axis="model", data_axis="data")
    x = torch.randn(3, 4)
    for fn in (ctx.psum_clients, ctx.all_gather_clients, ctx.psum_model,
               ctx.pmax_model, ctx.psum_data, ctx.pmean_data, ctx.tp_copy,
               ctx.psum_seq):
        assert torch.equal(fn(x), x)
    assert ctx.client_index() == 0 and ctx.model_index() == 0
    assert torch.equal(ctx.pmean_clients(x), x / 1)
