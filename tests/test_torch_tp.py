"""The model axis (tp > 1) and sequence-sharded decode in the port, on 4
CPU gloo ranks (spawned once per grid), against tp = 1 and against the JAX
package's ``shard_map`` at the same tp with ``check_vma=True`` (4 forced
host devices; ``check_vma=False`` transposes psum to psum and its manual-TP
gradients come out wrong by factors of tp, ``tests/test_sharding.py``).

Params are staged with numpy from a seed, leaf by leaf in ravel order (the
JAX init draws anew in every process), at their global shapes; each rank
keeps its shards (``models.params.shard_params``) and the gathered
gradients (``gather_params``) are compared. Each tolerance is stated where
it is set.

* Loss, metrics and every gathered gradient at tp = 2 and 4 against tp = 1
  and against JAX, on the gemma2-2b, qwen2-moe, deepseek-v3, recurrentgemma
  and xlstm smoke configs: every replicated leaf included (norms, the
  router, MLA's down projections, the mLSTM's q/k/gates, the sLSTM core,
  replicated kv heads), each the same on every model rank. A replicated
  leaf's gradient off by tp or 1/tp would show a misplaced marker
  (``models.layers``' rule).
* Prefill and decode at tp = 2 against tp = 1 (logits and greedy tokens),
  ``tests/test_sharding.py::test_tp_serving_prefill_decode`` on the port.
* Sequence-sharded decode over 4 ranks against the unsharded decode
  (``::test_seq_sharded_decode_matches_unsharded``): softmax attention with
  a windowed layer left whole, and MLA's latent cache.
* MoE at tp > 1 with padded experts: a pad expert is never selected
  (``tests/test_moe.py::test_padded_experts_never_selected`` at tp = 2).
* The mesh round at dp 2 × tp 2: fedcams with blockwise top-k over the
  sparse collective against the JAX mesh at dp 2 × tp 2 (the same
  model-local block layouts), and a dense FedAMS round against dp 2 ×
  tp 1 on the same init (a blockwise top-k selects from each rank's
  model-local leaf, so only a dense round is layout-free).
* ``rs_ag``: the same sums as ``psum``; ``convert.model_params_*`` at
  tp = 2.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import FedConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.models.params import leaves_with_paths, tree_map
from test_torch_mesh import spawn

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
         "recurrentgemma-2b", "xlstm-350m")
DECODERS = ARCHS
WORLD = 4
B, S = 2, 32
FIELDS = ("params", "m", "v", "vhat", "errors")


def staged(defs, seed=0):
    """Numpy params of ``defs`` at their global shapes: leaf i of the
    ravel order from ``np.random.default_rng((seed, i))`` (the draw the
    JAX side makes)."""
    out = {}
    for i, (path, d) in enumerate(leaves_with_paths(defs)):
        if d.init in ("zeros", "ones"):
            a = (np.zeros if d.init == "zeros" else np.ones)(d.shape, d.dtype)
        else:
            a = (np.random.default_rng((seed, i)).standard_normal(d.shape)
                 * d.scale).astype(d.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _tokens(cfg, seed=5, n=S):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, n)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _ctx(tp, world=WORLD, **kw):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import ParallelContext
    mesh = make_mesh((world // tp, tp), ("data", "model"), "cpu")
    return ParallelContext(model_axis="model", tp=tp, mesh=mesh, **kw)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _np(tree):
    return {"/".join(p): t.detach().float().numpy().copy()
            for p, t in leaves_with_paths(tree)}


def _replicas_same(trees, defs, ctx) -> bool:
    """Whether each leaf of ``trees`` that no dim shards (``defs``' specs)
    is the same to the bit on every rank of the model axis."""
    same = True
    for tree in trees:
        for (_, t), (_, d) in zip(leaves_with_paths(tree),
                                  leaves_with_paths(defs)):
            if all(sp is None for sp in d.dim_specs):
                every = ctx.all_gather_model(t.reshape(1, -1), axis=0)
                same &= bool((every == every[:1]).all())
    return same


# -- rank-side grids -----------------------------------------------------------


def grad_worker(rank, world):
    """Each arch's loss and gradient at tp = 1 (on its own) and at tp = 2
    and 4 (every rank; the gradients gathered). Also whether each
    replicated leaf's gradient is the same on every rank of the model
    axis."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import gather_params, shard_params
    from repro_torch.sharding.rules import ParallelContext
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).smoke
        batch = {k: torch.from_numpy(v) for k, v in _tokens(cfg).items()}
        res = {}
        for tp in (1, 2, 4):
            model = Model(cfg, tp=tp)
            ctx = _ctx(tp) if tp > 1 else ParallelContext()
            full = _t(staged(model.defs()))
            local = (shard_params(full, model.defs(), ctx) if tp > 1
                     else full)
            local = tree_map(lambda t: t.requires_grad_(True), local)
            loss, met = model.loss(local, batch, ctx, remat_policy="none",
                                   chunk=8)
            loss.backward()
            grads = tree_map(lambda t: t.grad if t.grad is not None
                             else torch.zeros_like(t), local)
            same = True
            if tp > 1:
                same = _replicas_same([grads], model.defs(), ctx)
                grads = gather_params(grads, model.defs(), ctx)
            res[tp] = {"loss": float(loss), "same": same,
                       "metrics": {k: float(v) for k, v in met.items()},
                       "grads": _np(grads)}
        out[arch] = res
    return out


def serve_worker(rank, world):
    """Each decoder's prefill (12 tokens) and 6 greedy decode steps at
    tp = 2 (logits gathered over the model axis) and at tp = 1."""
    from repro_torch.models.model import Model, greedy_sample
    from repro_torch.models.params import shard_params
    from repro_torch.sharding.rules import ParallelContext
    out = {}
    for arch in DECODERS:
        cfg = get_arch(arch).smoke
        prompts = torch.from_numpy(_tokens(cfg, 9, 12)["tokens"])
        res = {}
        for tp in (1, 2):
            model = Model(cfg, tp=tp)
            ctx = _ctx(tp) if tp > 1 else ParallelContext()
            full = _t(staged(model.defs(), 1))
            p = shard_params(full, model.defs(), ctx) if tp > 1 else full
            with torch.no_grad():
                lg, caches = model.prefill(p, prompts, ctx, max_len=20)
                logits = [ctx.all_gather_model(lg, -1)]
                tok = greedy_sample(lg, ctx)[:, None]
                toks = [tok[:, 0]]
                for i in range(6):
                    lg, caches = model.decode_step(p, tok, caches, 12 + i,
                                                   ctx, max_len=20)
                    logits.append(ctx.all_gather_model(lg, -1))
                    tok = greedy_sample(lg, ctx)[:, None]
                    toks.append(tok[:, 0])
            res[tp] = {"logits": torch.stack(logits, 1).numpy(),
                       "tokens": torch.stack(toks, 1).numpy()}
        out[arch] = res
    return out


SEQ_CASES = {
    # tests/test_sharding.py's dense case
    "dense": dict(name="t", family="dense", num_layers=2, d_model=32,
                  num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                  dtype="float32"),
}


def _seq_cfg(name):
    from repro_torch.configs.base import ModelConfig
    if name in SEQ_CASES:
        return ModelConfig(**SEQ_CASES[name])
    return get_arch(name).smoke


def seq_worker(rank, world):
    """Each case decoded token by token from an empty cache, unsharded
    and with the cache's slots split over the 4 ranks of ``"data"``
    (``seq_axis="data"``: ``seq_shards`` is 4); gemma2's windowed layer
    (window 16 < 24) keeps its ring whole."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ParallelContext
    mesh = make_mesh((world,), ("data",), "cpu")
    seq = ParallelContext(seq_axis="data", mesh=mesh)
    # 2 shards over "data" of a (2, 2) mesh whose "model" dim the context
    # does not use: its ranks repeat the work, and the cache's kv heads
    # (specced "model") stay whole
    mesh2 = make_mesh((2, world // 2), ("data", "model"), "cpu")
    seq2 = ParallelContext(seq_axis="data", mesh=mesh2)
    assert (seq.seq_shards, seq2.seq_shards) == (world, 2)
    out = {}
    for name in ("dense", "gemma2-2b", "deepseek-v3-671b"):
        cfg = _seq_cfg(name)
        model = Model(cfg)
        p = _t(staged(model.defs(), 2))
        toks = torch.from_numpy(_tokens(cfg, 3, 20)["tokens"])
        res = {}
        for tag, ctx in (("ref", ParallelContext()), ("seq", seq),
                         ("seq2", seq2)):
            caches = model.init_cache(B, 24, seq_sharded=tag != "ref",
                                      device="cpu", ctx=ctx)
            if tag == "seq":   # the last full-length layer's (G, B, C, ...)
                res["local_k"] = [t for pth, t in leaves_with_paths(caches)
                                  if pth[-1] in ("k", "c_kv")][-1].shape
            logits = []
            with torch.no_grad():
                for i in range(20):
                    lg, caches = model.decode_step(p, toks[:, i:i + 1], caches,
                                                   i, ctx, max_len=24)
                    logits.append(lg)
            res[tag] = torch.stack(logits, 1).numpy()
        out[name] = res
    return out


def moe_pad_worker(rank, world):
    """qwen2-moe's smoke config cut to 3 experts at tp = 2 (padded to 4:
    one pad expert, on rank 1): the dispatch of every layer's tokens never
    selects it, its router prob is 0, and rank 1's slots of it carry zero
    weight."""
    from repro_torch.configs.base import mreplace
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model
    from repro_torch.models.params import shard_params
    base = get_arch("qwen2-moe-a2.7b").smoke
    cfg = mreplace(base, moe=dataclasses.replace(base.moe, num_experts=3))
    model = Model(cfg, tp=2)
    ctx = _ctx(2)
    p = shard_params(_t(staged(model.defs(), 4)), model.defs(), ctx)
    mlp = tree_map(lambda t: t[0], p["stack"]["groups"])["l0"]["mlp"]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(64, cfg.d_model)).astype(np.float32))
    probs = moe_mod.router_probs(mlp, x, cfg.moe, "float32")
    E_loc = mlp["w_up"].shape[0]
    r = moe_mod.dispatch(probs, cfg.moe, ctx.model_index() * E_loc, E_loc)
    return {"E": probs.shape[1], "E_loc": E_loc,
            "top_idx_max": int(r.top_idx.max()),
            "pad_prob_max": float(probs[:, 3].max()),
            "rank1_pad_weight": float(ctx.all_gather_model(
                r.w_tok[None], 0)[1, 1].abs().max())}


def round_worker(rank, world, arch, tp, fed_kw, start):
    """One mesh round of ``arch``'s smoke config at dp ``world // tp`` ×
    tp from the global state ``start`` (the JAX layout), on the plain and
    on the kernel-routed path (the kernels' twins); rank 0 returns the
    gathered state and the metrics of both."""
    from repro_torch.convert import mesh_state_from_jax
    from repro_torch.core import mesh as meshmod
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.kernels.ops import KernelImpl
    from repro_torch.models.model import Model
    dp = world // tp
    model = Model(get_arch(arch).smoke, tp=tp)
    train = TrainConfig(global_batch=2 * dp, seq_len=16, remat_policy="none")
    ctx = _ctx(tp, world, client_axes=("data",), num_clients=dp)
    data = FederatedLMData(num_clients=dp, vocab_size=model.cfg.vocab_size,
                           seed=0)
    out = {}
    for impl in ("jnp", "kernel"):
        kw = dict(fed_kw)
        if kw.get("aggregation") == "sparse":
            kw.update(mesh_sparse_impl=impl, fused_ingest="kernel"
                      if impl == "kernel" else "auto")
        elif impl == "kernel":
            continue
        fed = FedConfig(num_clients=dp, client_axes=("data",), **kw)
        rnd = meshmod.build_fed_round(model, fed, train, ctx,
                                      kernel_impl=KernelImpl(device="cpu"))
        state = meshmod.shard_fed_state(mesh_state_from_jax(start), model,
                                        fed, ctx, "cpu")
        batch = meshmod.shard_batch(data.mesh_batch(0, 2, 2 * dp, 16), model,
                                    fed, train, ctx, "cpu")
        state, met = rnd(state, batch, 0)
        same = _replicas_same(
            [state.params, state.m, state.v, state.vhat,
             tree_map(lambda e: e[0], state.errors)], model.defs(), ctx)
        full = meshmod.gather_fed_state(state, model, fed, ctx)
        out[impl] = dict({f: _np(getattr(full, f)) for f in FIELDS},
                         **{k: float(v) for k, v in met.items()},
                         replicas_same=same)
    return out


def rs_ag_worker(rank, world):
    """``psum_model`` over tp = 2 and 4 with ``tp_collective="rs_ag"``
    (dim 0 split over the axis) against ``"psum"``, fp32 and bf16, and
    its backward the identity."""
    out = []
    for tp in (2, 4):
        g = torch.Generator().manual_seed(rank)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(8, 5, generator=g).to(dt).requires_grad_(True)
            a = _ctx(tp).psum_model(x)
            b = _ctx(tp, tp_collective="rs_ag").psum_model(x)
            b.sum().backward()
            out.append((torch.equal(a, b), torch.equal(
                x.grad, torch.ones_like(x))))
    return out


def convert_worker(rank, world):
    """``convert.model_params_from_jax``/``model_params_to_jax`` at tp = 2
    on the xlstm smoke config: this rank's shards of a global numpy tree,
    and the global tree back (collective)."""
    from repro_torch.convert import model_params_from_jax, model_params_to_jax
    from repro_torch.models.model import Model
    from repro_torch.models.params import shard_params
    model = Model(get_arch("xlstm-350m").smoke, tp=2)
    ctx = _ctx(2)
    full = staged(model.defs(), 6)
    local = model_params_from_jax(full, "cpu", model.defs(), ctx)
    want = shard_params(_t(full), model.defs(), ctx)
    back = model_params_to_jax(local, model.defs(), ctx)
    return {"shards": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(local), leaves_with_paths(want))),
            "back": all(np.array_equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(back), leaves_with_paths(full))),
            "w_v": tuple(local["stack"]["groups"]["l0"]["mix"]["w_v"].shape)}


# -- fixtures: one spawn per grid ----------------------------------------------


@pytest.fixture(scope="module")
def grads():
    return spawn(grad_worker, WORLD, timeout=900)


_JAX_GRADS = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, Mesh
from repro import compat
from repro.configs.registry import get_arch
from repro.models.model import Model
from repro.models import params as pdefs
from repro.sharding.rules import ParallelContext
from test_torch_tp import ARCHS, staged, _tokens
out = {}
for arch in ARCHS:
    cfg = get_arch(arch).smoke
    b = {k: jnp.asarray(v) for k, v in _tokens(cfg).items()}
    for tp in (2, 4):
        model = Model(cfg, tp=tp)
        ctx = ParallelContext(model_axis="model", tp=tp)
        mesh = Mesh(np.array(jax.devices()[:tp]), ("model",))
        pspec = jax.tree.map(lambda d: d.spec, model.defs(),
                             is_leaf=pdefs.is_def)

        def f(p, b):
            (loss, met), g = jax.value_and_grad(
                lambda pp: model.loss(pp, b, ctx, remat_policy="none",
                                      chunk=8), has_aux=True)(p)
            return loss, met, g

        fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(pspec, P()),
                                      out_specs=(P(), P(), pspec),
                                      check_vma=True))
        p = jax.tree.map(jnp.asarray, staged(model.defs()))
        loss, met, g = fn(p, b)
        out[f"{arch}/{tp}/loss"] = np.float32(loss)
        for k, v in met.items():
            out[f"{arch}/{tp}/metric/{k}"] = np.float32(v)
        flat, _ = jax.tree_util.tree_flatten_with_path(g)
        for path, leaf in flat:
            key = "/".join(q.key for q in path)
            out[f"{arch}/{tp}/grad/{key}"] = np.asarray(leaf)
np.savez(%(path)r, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_grads():
    from conftest import run_forced_devices
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax_tp_grads.npz")
        run_forced_devices(_JAX_GRADS % dict(path=path), devices=WORLD,
                           timeout=900)
        return dict(np.load(path))


@pytest.fixture(scope="module")
def served():
    return spawn(serve_worker, WORLD, timeout=900)


@pytest.fixture(scope="module")
def seq_decoded():
    return spawn(seq_worker, WORLD, timeout=900)


# -- gradients -------------------------------------------------------------------


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


#: the loss within 2e-6 relative and every gradient leaf within 2e-5 of
#: its largest |∂| (1e-4 on xlstm: ``test_torch_models.py``'s bounds
#: against JAX), tp > 1 against tp = 1: the sharded matmuls sum their
#: halves in another order, and the model axis's all-reduce adds the
#: partials of the replicated weights
GRAD_TOL = {"xlstm-350m": 1e-4}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_gradients_equal_tp1(grads, arch, tp):
    one, many = grads[arch][1], grads[arch][tp]
    assert many["loss"] == pytest.approx(one["loss"], rel=2e-6)
    assert sorted(many["metrics"]) == sorted(one["metrics"])
    for k, v in one["metrics"].items():
        assert many["metrics"][k] == pytest.approx(v, rel=2e-6, abs=1e-12), k
    assert many["same"], "a replicated leaf's gradient differs across ranks"
    assert sorted(many["grads"]) == sorted(one["grads"])
    for path, g in one["grads"].items():
        _close(many["grads"][path], g, GRAD_TOL.get(arch, 2e-5),
               f"{arch} tp={tp} {path}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_gradients_match_jax_shard_map(grads, jax_grads, arch, tp):
    """The port at tp against ``jax.grad`` inside JAX's ``shard_map`` at
    the same tp (``check_vma=True``), the same tolerances as against
    tp = 1."""
    mine = grads[arch][tp]
    assert mine["loss"] == pytest.approx(
        float(jax_grads[f"{arch}/{tp}/loss"]), rel=2e-6)
    for k, v in mine["metrics"].items():
        assert v == pytest.approx(float(jax_grads[f"{arch}/{tp}/metric/{k}"]),
                                  rel=2e-6, abs=1e-12), k
    pre = f"{arch}/{tp}/grad/"
    want = {k[len(pre):]: v for k, v in jax_grads.items()
            if k.startswith(pre)}
    assert sorted(want) == sorted(mine["grads"])
    for path, w in want.items():
        _close(mine["grads"][path], w, GRAD_TOL.get(arch, 2e-5),
               f"{arch} tp={tp} {path}")


# -- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODERS)
def test_tp2_prefill_and_decode_equal_tp1(served, arch):
    """Logits within 1e-5 of the largest |logit| at every step, and the
    same greedy tokens (the vocab-sharded argmax)."""
    one, two = served[arch][1], served[arch][2]
    _close(two["logits"], one["logits"], 1e-5, arch)
    assert np.array_equal(two["tokens"], one["tokens"])


@pytest.mark.parametrize("name", ["dense", "gemma2-2b", "deepseek-v3-671b"])
def test_seq_sharded_decode_equals_unsharded(seq_decoded, name):
    """20 decode steps into a cache of 24 slots, 6 a rank (and 12 a rank
    over the "data" dim of a (2, 2) mesh): within 1e-5 of the largest
    |logit| (the log-sum-exp combine reassociates the
    softmax's sums; the reference's own check holds 1e-3)."""
    res = seq_decoded[name]
    assert res["local_k"][2] == 24 // WORLD
    _close(res["seq"], res["ref"], 1e-5, name)
    _close(res["seq2"], res["ref"], 1e-5, f"{name} over 2 of a (2, 2) mesh")


def test_padded_experts_are_never_selected_at_tp2():
    got = spawn(moe_pad_worker, WORLD, timeout=600)
    assert (got["E"], got["E_loc"]) == (4, 2)
    assert got["top_idx_max"] < 3 and got["pad_prob_max"] == 0.0
    assert got["rank1_pad_weight"] == 0.0


def test_convert_carries_model_shards_at_tp2():
    got = spawn(convert_worker, WORLD, timeout=600)
    assert got["shards"] and got["back"]
    assert got["w_v"] == (1, 128, 4, 32)     # (G, d, heads, dh / tp)


def test_rs_ag_sums_are_the_psums():
    assert all(a and b for a, b in spawn(rs_ag_worker, WORLD, timeout=600))


# -- the mesh round at dp 2 x tp 2 ----------------------------------------------

FED_SPARSE = dict(algorithm="fedcams", compressor="topk",
                  compress_ratio=1 / 64, aggregation="sparse", local_steps=2,
                  eta=0.5, eta_l=0.05)
FED_DENSE = dict(algorithm="fedams", compressor="none", local_steps=2,
                 eta=0.5, eta_l=0.05)


def _start(arch, tp, m=2):
    """The global state in the JAX layout from the staged params."""
    from repro_torch.models.model import Model
    p = staged(Model(get_arch(arch).smoke, tp=tp).defs(), 3)
    z = lambda a: np.zeros_like(a, dtype=np.float32)
    return {"params": p, "m": tree_map(z, p), "v": tree_map(z, p),
            "vhat": tree_map(z, p), "round": np.int32(0),
            "errors": tree_map(lambda a: np.zeros((m,) + a.shape,
                                                  np.float32), p)}


_JAX_ROUND = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import FedConfig, TrainConfig
from repro.configs.registry import get_arch
from repro.core.mesh import (FedMeshState, build_fed_round, fed_batch_defs,
                             fed_state_defs, mesh_metric_specs)
from repro.data.synthetic import FederatedLMData
from repro.launch.mesh import make_mesh
from repro.models import params as pdefs
from repro.models.model import Model
from repro.sharding.rules import ParallelContext
from test_torch_tp import FED_SPARSE, _start
out = {}
for arch in %(archs)r:
    fed = FedConfig(num_clients=2, client_axes=("data",),
                    mesh_sparse_impl="jnp", **FED_SPARSE)
    train = TrainConfig(global_batch=4, seq_len=16, remat_policy="none")
    model = Model(get_arch(arch).smoke, tp=2)
    ctx = ParallelContext(model_axis="model", tp=2, client_axes=("data",),
                          num_clients=2)
    mesh = make_mesh((2, 2), ("data", "model"))
    spec = lambda defs: jax.tree.map(lambda d: d.spec, defs,
                                     is_leaf=pdefs.is_def)
    step = jax.jit(compat.shard_map(
        build_fed_round(model, fed, train, ctx), mesh=mesh,
        in_specs=(spec(fed_state_defs(model, fed)),
                  spec(fed_batch_defs(model, fed, train)), P()),
        out_specs=(spec(fed_state_defs(model, fed)), mesh_metric_specs(fed)),
        check_vma=True))
    st = _start(arch, 2)
    state = FedMeshState(**jax.tree.map(jnp.asarray, st))
    raw = FederatedLMData(num_clients=2, vocab_size=model.cfg.vocab_size,
                          seed=0).mesh_batch(0, 2, 4, 16)
    state, met = step(state, {k: jnp.asarray(v) for k, v in raw.items()},
                      jnp.int32(0))
    for f in ("params", "m", "v", "vhat", "errors"):
        flat, _ = jax.tree_util.tree_flatten_with_path(getattr(state, f))
        for path, leaf in flat:
            key = "/".join(q.key for q in path)
            out[f"{arch}/{f}/{key}"] = np.asarray(leaf).astype(np.float32)
    out[f"{arch}/loss"] = np.float32(met["loss"])
    out[f"{arch}/wire_up_bytes"] = np.float32(met["wire_up_bytes"])
np.savez(%(path)r, **out)
print("ok")
"""

ROUND_ARCHS = ("gemma2-2b", "xlstm-350m")


@pytest.fixture(scope="module")
def jax_round():
    from conftest import run_forced_devices
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax_tp_round.npz")
        run_forced_devices(_JAX_ROUND % dict(path=path, archs=ROUND_ARCHS),
                           devices=WORLD, timeout=900)
        return dict(np.load(path))


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_dp2_tp2_sparse_round_matches_the_jax_mesh(jax_round, arch):
    """fedcams, blockwise top-k 1/64 over the sparse collective, one round
    at dp 2 × tp 2 from the same staged state: each rank selects from its
    model-local leaves in both packages. ``wire_up_bytes`` bitwise (the
    local total × tp); the loss within 1e-5 relative; params within 2e-6 of
    each leaf's largest |value| and the EF rows and m, v, v̂ within 1e-4
    (``test_torch_lm_train.py``'s bounds). The kernel-routed round (the
    kernels' twins) is the plain one to the bit. Every leaf of the state
    that the model axis does not shard is the same on every model rank."""
    got = spawn(round_worker, WORLD, arch, 2, FED_SPARSE, _start(arch, 2),
                timeout=900)
    row = got["jnp"]
    assert row["replicas_same"] and got["kernel"]["replicas_same"]
    assert row["wire_up_bytes"] == float(jax_round[f"{arch}/wire_up_bytes"])
    assert row["loss"] == pytest.approx(float(jax_round[f"{arch}/loss"]),
                                        rel=1e-5)
    for f in FIELDS:
        pre = f"{arch}/{f}/"
        want = {k[len(pre):]: v for k, v in jax_round.items()
                if k.startswith(pre)}
        assert sorted(want) == sorted(row[f]), f
        for path, w in want.items():
            _close(row[f][path], w, 2e-6 if f == "params" else 1e-4,
                   f"{arch} {f} {path}")
    for f in FIELDS:
        for path, a in row[f].items():
            assert np.array_equal(a, got["kernel"][f][path]), (f, path)
    assert got["kernel"]["loss"] == row["loss"]


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2-moe-a2.7b"])
def test_dp2_tp2_dense_round_equals_dp2_tp1(arch):
    """FedAMS with a dense uplink, one round from the same staged state at
    dp 2 × tp 2 (4 ranks) and dp 2 × tp 1 (2 ranks): the loss within 1e-5
    relative, every gathered leaf of the params within 1e-5 of its largest
    |value| and of m, v, v̂ within 1e-4 (the two layouts sum their
    matmuls and gradients in their own orders, and FedAMS's first step
    moves a coordinate by η·m/√v̂, which carries the local delta's
    relative rounding whatever its size: measured ≤ 2.8e-6 on xlstm's w_i
    and 2.3e-6 on qwen2-moe's bk; ``test_torch_lm_train.py`` holds
    qwen2-moe's params to the JAX mesh within 1e-5 too). At tp 2 every
    replicated leaf of the state is the same on every model rank."""
    two = spawn(round_worker, WORLD, arch, 2, FED_DENSE, _start(arch, 2),
                timeout=900)["jnp"]
    one = spawn(round_worker, 2, arch, 1, FED_DENSE, _start(arch, 1),
                timeout=900)["jnp"]
    assert two["replicas_same"]
    assert two["loss"] == pytest.approx(one["loss"], rel=1e-5)
    for f in FIELDS:
        assert sorted(two[f]) == sorted(one[f])
        for path, w in one[f].items():
            _close(two[f][path], w, 1e-5 if f == "params" else 1e-4,
                   f"{arch} {f} {path}")


# -- the trainer and the example at tp = 2 ---------------------------------------


def tp_trainer_worker(rank, world, path):
    """``FederatedTrainer(mesh=...)`` on a (2, 2) ("data", "model") mesh
    with the xlstm smoke model at tp = 2 and ``TrainConfig.tp_collective
    = "rs_ag"``: 3 rounds, then ``save`` (the global state, gathered over
    both axes)."""
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    model = Model(get_arch("xlstm-350m").smoke, tp=2)
    fed = FedConfig(num_clients=2, client_axes=("data",), **FED_SPARSE)
    tr = FederatedTrainer(
        fed=fed, train=TrainConfig(global_batch=4, seq_len=16, rounds=3,
                                   remat_policy="none", tp_collective="rs_ag"),
        model=model, mesh=make_mesh((2, 2), ("data", "model"), "cpu"),
        lm_data=FederatedLMData(num_clients=2, vocab_size=512, seed=0),
        device="cpu")
    tr.run(log=None)
    tr.save(path)
    return {"history": tr.history, "tp_collective": tr._ctx.tp_collective,
            "w_v": tuple(tr.params["stack"]["groups"]["l0"]["mix"]["w_v"]
                         .shape),
            "finite": all(bool(torch.isfinite(t).all())
                          for t in tree_leaves(tr.params))}


def test_mesh_trainer_runs_at_tp2(tmp_path):
    """The trainer at dp 2 × tp 2: its context takes the train config's
    model-axis collective, each rank holds its model shards, the history
    has a finite loss a round, and the checkpoint is the global
    state in the JAX package's layout (the EF rows (m, ...) at global
    shapes)."""
    from repro_torch.checkpoint import load_pytree
    path = str(tmp_path / "ckpt")
    out = spawn(tp_trainer_worker, WORLD, path, timeout=600)
    assert [h["round"] for h in out["history"]] == [0, 1, 2]
    assert out["tp_collective"] == "rs_ag"
    assert all(np.isfinite(h["loss"]) for h in out["history"]) and \
        out["finite"]
    assert out["w_v"] == (1, 128, 4, 32)
    ckpts = sorted(os.listdir(tmp_path))
    assert ckpts, ckpts
    like = _start("xlstm-350m", 2)
    tree, _ = load_pytree(os.path.join(tmp_path, ckpts[-1]), like)
    assert tree["errors"]["stack"]["groups"]["l0"]["mix"]["w_v"].shape == (
        2, 1, 128, 4, 64)


def test_train_lm_example_twin_runs_at_tp2_on_the_cpu():
    """``examples/train_lm_fedcams_torch.py`` (default ``--tp 2``) on 2
    clients: the reference's lines, a falling loss, and neither jax nor
    repro loaded."""
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    code = ("import runpy, sys\n"
            "sys.argv = ['train_lm_fedcams_torch.py', '--preset', '2m', "
            "'--rounds', '11', '--clients', '2', '--seq-len', '32', "
            "'--device', 'cpu']\n"
            "runpy.run_path("
            f"{os.path.join(root, 'examples', 'train_lm_fedcams_torch.py')!r}"
            ", run_name='__main__')\n"
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert lines[0].startswith("model=lm-2m params=") and lines[0].endswith(
        "clients=2 tp=2 compressor=topk r=0.015625"), lines[0]
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("round")]
    assert len(losses) == 2 and losses[-1] < losses[0], out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_state_shard_dims_on_the_zoo_equal_the_reference(arch):
    """ROADMAP Queue 3 item 11, rechecked with the model axis named: on
    every leaf of the zoo's smoke configs at tp 1, 2 and 4 the port's
    ``state_shard_dim`` picks the reference's dim: a dim sharded over
    ``"model"`` never hosts a ZeRO shard, and the sLSTM's spec-less ``r``
    (``spec=()``, stacked to ``(None,)``) offers its group dim alone, which
    at one group does not split. A leaf with ``spec=None`` (ConvMixer's)
    still offers every dim: item 11 stays for it."""
    import jax
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import mesh as jmesh
    from repro.models import params as jparams
    from repro.models.model import Model as JaxModel
    from repro_torch.core import mesh as tmesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import ParamDef
    for tp in (1, 2, 4):
        jd = dict(leaves_with_paths(jax.tree.map(
            lambda d: d, JaxModel(jax_arch(arch).smoke, tp=tp).defs(),
            is_leaf=jparams.is_def)))
        for path, d in leaves_with_paths(Model(get_arch(arch).smoke,
                                               tp=tp).defs()):
            for shards in (2, 4):
                assert tmesh.state_shard_dim(d, shards) == \
                    jmesh.state_shard_dim(jd[path], shards), (tp, path)
    assert tmesh.state_shard_dim(ParamDef((4, 8)), 2) == 0
    assert tmesh.state_shard_dim(ParamDef((4, 8), spec=()), 2) is None
    assert jmesh.state_shard_dim(jparams.ParamDef((4, 8), jparams.P()),
                                 2) is None
