"""``launch/op_analysis.py`` (the port's counterpart of
``repro.launch.hlo_analysis``) and ``launch/roofline.py``.

* The charging conventions on hand-built op sequences: a matmul, a slice
  write, ``index_add_``, a reduction, views, an empty allocation, an
  elementwise op, a collective and a kernel launch on ``meta``, and the
  memory record.
* FLOPs against ``hlo_analysis.analyze`` of the jitted JAX functions at
  tp 1 on the gemma2-2b, qwen2-moe, deepseek-v3, xlstm and recurrentgemma
  smoke configs (batch 2 × 64, q-chunk 32): prefill and decode equal
  exactly; the gradient (loss + backward against ``jax.grad``) equal but
  for two named gaps (ROADMAP Queue 3 item 30), each held to its
  formula: the sLSTM's first recurrent step (JAX's scan also contracts
  the gradient into the zero initial state, 2·B·4·d·dh FLOPs a layer;
  torch skips it, the state needing no gradient), and under remat
  ``"full"`` the MoE shared experts' down projection (2·T·d_ff_shared·d
  a layer: XLA drops its dead recompute, ``torch.utils.checkpoint``
  recomputes the group whole).
* Rank 0 of a (2, 2) ``("data", "model")`` mesh (the port on the fake
  process group, JAX on 4 forced host devices, one subprocess each):
  train, prefill and decode FLOPs and collective bytes by kind against
  JAX's per-device ``analyze``. Serving steps equal exactly; train steps
  equal in FLOPs but for the sLSTM gap above (K = 2 local steps), and
  their collectives differ as Queue 3 item 31 records (held here).
* The sLSTM's trip count: ``analyze``'s extrapolation from 4 and 5 steps
  equals a full trace to the integer at S = 16, 32 and 64, alone and
  inside the xlstm smoke model's gradient, the memory record's peak
  included (its live-bytes curve extrapolated), and inside a train round
  (ROADMAP Queue 3 item 35).
* The memory record is a plain run's: a recorder (a dispatch mode) and a
  meta tensor make autograd write out of place where a plain run writes
  in place (the engine's gradient sums, ``gather``'s and indexing's
  backward), and the record counts those writes in place, as many as a
  profiled plain run makes on the zoo's smoke gradients (Queue 3 item
  35: route z's 13.19 GB over-count on the card).
* The bytes of the sLSTM's and the chunkwise mLSTM's forward and backward
  are affine in the sequence (their loops step over one ``unbind`` /
  ``split``: ROADMAP Queue 3 item 32).
* The roofline copy: ``_mk_roofline`` and ``model_flops_for`` equal the
  reference's given the same ``BackendSpec`` values.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import forced_devices_json
from repro.configs.registry import get_arch as jax_arch
from repro.launch import hlo_analysis
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import params as jparams
from repro.models.model import Model as JaxModel
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.registry import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_analysis as oa
from repro_torch.launch import roofline as troofline
from repro_torch.models import params as pdefs
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.model import Model
from repro_torch.sharding.rules import ParallelContext

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b", "xlstm-350m",
         "recurrentgemma-2b")
B, S, CHUNK = 2, 64, 32


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- conventions -------------------------------------------------------------


def test_matmul_charges_flops_and_operands_plus_output():
    a, b = _meta((8, 16)), _meta((16, 4))
    rec = oa.measure(torch.mm, a, b)
    assert rec.ops == 1
    assert rec.flops == 2 * 8 * 4 * 16
    assert rec.bytes == rec.rw_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    bias = _meta((4,))
    rec = oa.measure(lambda x, w, c: torch.addmm(c, x, w), a, b, bias)
    assert rec.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4   # no bias


def test_slice_write_charges_the_update():
    cache, x = _meta((2, 100, 8)), _meta((2, 1, 8))

    def write(c, x):
        c[:, 7:8] = x
        return c

    rec = oa.measure(write, cache, x)
    assert rec.ops == 2                       # slice (a view) + copy_
    assert rec.bytes == 2 * 8 * 4
    assert rec.rw_bytes == 2 * 2 * 8 * 4


def test_index_add_charges_the_source():
    out, src = _meta((50, 8)), _meta((6, 8))
    idx = torch.empty(6, dtype=torch.int64, device="meta")
    rec = oa.measure(lambda o, i, s: o.index_add_(0, i, s), out, idx, src)
    assert rec.bytes == 6 * 8 * 4 and rec.rw_bytes == 2 * 6 * 8 * 4


def test_reduction_charges_input_and_output():
    x = _meta((8, 32))
    rec = oa.measure(lambda t: t.sum(dim=1), x)
    assert rec.bytes == rec.rw_bytes == (8 * 32 + 8) * 4
    rec = oa.measure(lambda t: t.amax(dim=-1), x)
    assert rec.bytes == (8 * 32 + 8) * 4


def test_views_and_empty_allocations_are_free():
    x = _meta((4, 6, 8))

    def views(t):
        return (t.view(24, 8), t.transpose(0, 1), t[:, 2], t.expand(2, 4, 6, 8),
                t.permute(2, 0, 1), t.detach(), torch.empty_like(t))

    rec = oa.measure(views, x)
    assert rec.ops == 7
    assert rec.bytes == rec.rw_bytes == rec.flops == 0


def test_elementwise_charges_output_and_rw_its_operands():
    a, b = _meta((10, 10)), _meta((10, 10))
    rec = oa.measure(torch.add, a, b)
    assert rec.bytes == 400 and rec.rw_bytes == 1200 and rec.flops == 0


def test_memory_record():
    x = _meta((256,))

    def step(t):
        a = t * 2          # 1 KB, freed before the end
        b = a + 1          # 1 KB, the output
        del a
        return b

    rec = oa.measure(step, x)
    mem = rec.memory
    assert mem["argument_size"] == 1024 and mem["output_size"] == 1024
    assert mem["temp_size"] == 2048 and mem["generated_code_size"] is None

    # a gradient summed over two uses: the plain run adds the second 1 KB
    # term into the first (the engine's in-place sum); the record's peak
    # is the loss, its cotangent and the two terms, not a third sum
    def grad(t):
        t = t.detach().requires_grad_(True)
        return torch.autograd.grad((t * 2).sum() + (t * 3).sum(), t)

    rec = oa._measure(grad, (x,), 0)
    assert rec.in_place == {"add": 1}
    assert rec.cost.memory["temp_size"] == 2 * 1024 + 2 * 4
    assert rec.cost.memory["output_size"] == 1024


def test_collectives_on_meta_are_charged_and_move_nothing():
    """A context over the fake process group charges its collectives by
    the reference's kind names; the payload is the output's bytes."""
    code = f"""
    import sys, json
    sys.path.insert(0, {SRC!r})
    import torch
    from repro_torch.launch.mesh import start_fake_world, make_mesh
    from repro_torch.launch import op_analysis as oa
    from repro_torch.sharding.rules import ParallelContext
    start_fake_world(4)
    ctx = ParallelContext(model_axis="model", tp=2, client_axes=("data",),
                          num_clients=2, tp_collective="rs_ag",
                          mesh=make_mesh((2, 2), ("data", "model"), "cpu"))
    x = torch.empty((4, 8), device="meta")
    rec = oa.OpCost()
    with rec:
        ctx.psum_clients(x)
        g = ctx.all_gather_clients(x)
        ctx.psum_model(x)
        ctx.broadcast_model(x)
    print(json.dumps([rec.cost.coll_bytes, rec.cost.coll_count,
                      list(g.shape)]))
    """
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    got, counts, shape = json.loads(out.stdout.strip().splitlines()[-1])
    assert shape == [8, 8]
    # psum_clients 128 B; the rs_ag psum_model reduce-scatters its 128 B
    # input and all-gathers 2 × 64 B back; the client gather 2 × 128 B
    assert got == {"all-reduce": 128, "all-gather": 256 + 128,
                   "reduce-scatter": 128, "broadcast": 128}
    assert counts == {"all-reduce": 1, "all-gather": 2, "reduce-scatter": 1,
                      "broadcast": 1}


def test_kernel_launch_on_meta_is_charged_not_launched():
    from repro_torch.kernels import ops
    x = _meta((3, 4096))
    err = _meta((5, 4096))
    rows = torch.empty(3, dtype=torch.int64, device="meta")
    ops.reset_launches()
    rec = oa.OpCost()
    with rec:
        vals, idx = ops.topk_ef_sparse(x, err, rows, k=32, block=2048)
        ops.fedams_update(*(_meta((4096,)) for _ in range(5)), eta=0.1,
                          beta1=0.9, beta2=0.99, eps=1e-3)
    assert tuple(vals.shape) == (3, 2, 32) and vals.is_meta
    assert rec.cost.launch_count == {"topk_ef_sparse": 1,
                                     "fedams_update": 1}
    assert rec.cost.launch_bytes == {"topk_ef_sparse": 3 * 3 * 4096 * 4
                                + 2 * 3 * 2 * 32 * 4,
                                "fedams_update": 9 * 4096 * 4}
    assert not any(ops.launches.values())


# -- FLOPs against hlo_analysis at tp 1 ----------------------------------------


def _jax_flops(fn, *args) -> float:
    return hlo_analysis.analyze(jax.jit(fn).lower(*args).compile()
                                .as_text()).flops


def _slstm_gap(cfg) -> int:
    """JAX's scan contracts the gradient into the zero initial state of
    every sLSTM layer: 2·B·4·d·dh FLOPs a layer that torch skips."""
    n = sum(k == "slstm" for k in cfg.layer_kinds)
    return n * 2 * B * 4 * cfg.d_model * (cfg.d_model // cfg.num_heads)


def _shared_down_gap(cfg) -> int:
    """Under remat "full", XLA drops the dead recompute of each MoE
    layer's shared-expert down projection; torch recomputes it."""
    if cfg.moe is None or not cfg.moe.num_shared_experts:
        return 0
    mo = cfg.moe
    dfs = mo.d_ff_shared or mo.num_shared_experts * mo.d_ff_expert
    n = sum(k == "attn" for k in cfg.layer_kinds)
    return n * 2 * B * S * dfs * cfg.d_model


@pytest.fixture(scope="module")
def tp1_flops():
    """(JAX, port) FLOPs of prefill, decode and the gradient at remat
    "none" and "full", per arch."""
    out = {}
    for arch in ARCHS:
        jm, tm = JaxModel(jax_arch(arch).smoke), Model(get_arch(arch).smoke)
        jp = jparams.abstract_params(jm.defs())
        tp = pdefs.tree_map(lambda d: _meta(d.shape, getattr(torch, d.dtype)),
                            tm.defs())
        jtok = jax.ShapeDtypeStruct((B, S), jnp.int32)
        ttok = _meta((B, S), torch.int32)
        jc = jparams.abstract_params(jm.cache_defs(B, S))
        tc = pdefs.tree_map(lambda d: _meta(d.shape, getattr(torch, d.dtype)),
                            tm.cache_defs(B, S))
        r = {
            "prefill": (
                _jax_flops(lambda p, t: jm.prefill(p, t, JaxCtx(), max_len=S,
                                                   chunk=CHUNK), jp, jtok),
                oa.analyze(lambda p, t: tm.prefill(
                    p, t, ParallelContext(), max_len=S, chunk=CHUNK), tp,
                    ttok).flops),
            "decode": (
                _jax_flops(lambda p, t, c: jm.decode_step(
                    p, t, c, S - 1, JaxCtx(), max_len=S), jp,
                    jax.ShapeDtypeStruct((B, 1), jnp.int32), jc),
                oa.analyze(lambda p, t, c: tm.decode_step(
                    p, t, c, S - 1, ParallelContext(), max_len=S), tp,
                    _meta((B, 1), torch.int32), tc).flops),
        }
        for remat in ("none", "full"):
            jb = {"tokens": jtok, "labels": jtok}

            def jgrad(p, b, remat=remat):
                return jax.grad(lambda q: jm.loss(
                    q, b, JaxCtx(), remat_policy=remat, chunk=CHUNK)[0])(p)

            def tgrad(p, b, remat=remat):
                leaves = [t.requires_grad_(True) for t in
                          pdefs.tree_leaves(p)]
                loss, _ = tm.loss(p, b, ParallelContext(),
                                  remat_policy=remat, chunk=CHUNK)
                return torch.autograd.grad(loss, leaves)

            r[f"grad_{remat}"] = (
                _jax_flops(jgrad, jp, jb),
                oa.analyze(tgrad, tp, {"tokens": ttok, "labels": ttok}).flops)
        out[arch] = r
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_flops_equal_hlo_analysis_at_tp1(tp1_flops, arch):
    for kind in ("prefill", "decode"):
        want, got = tp1_flops[arch][kind]
        assert got == want, (kind, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_flops_equal_hlo_analysis_but_the_named_gaps(tp1_flops,
                                                              arch):
    cfg = get_arch(arch).smoke
    want, got = tp1_flops[arch]["grad_none"]
    assert got == want - _slstm_gap(cfg), (got, want)
    want, got = tp1_flops[arch]["grad_full"]
    assert got == want - _slstm_gap(cfg) + _shared_down_gap(cfg), (got, want)


def test_the_named_gaps_are_not_empty():
    """Each gap's formula is exercised: xlstm has an sLSTM layer, qwen2-moe
    and deepseek-v3 have shared experts."""
    assert _slstm_gap(get_arch("xlstm-350m").smoke) == 65536
    assert _shared_down_gap(get_arch("qwen2-moe-a2.7b").smoke) == 8388608
    assert _shared_down_gap(get_arch("deepseek-v3-671b").smoke) == 4194304


# -- rank 0 of a (2, 2) mesh against JAX's per-device program ------------------

_GRID = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
from {pkg}.configs.registry import get_arch
from {pkg}.configs.base import FedConfig, TrainConfig, ShapeConfig
from {pkg}.launch import steps
{setup}
fed = FedConfig(algorithm="fedcams", compressor="topk", compress_ratio=1/64,
                aggregation="dense", local_steps=2)
train = TrainConfig(remat_policy="none")
shapes = [ShapeConfig("train_4k", 64, 4, "train"),
          ShapeConfig("prefill_32k", 64, 4, "prefill"),
          ShapeConfig("decode_32k", 64, 4, "decode"),
          ShapeConfig("long_500k", 64, 1, "decode")]
out = {{}}
for a in {archs!r}:
    spec = get_arch(a)
    spec = dataclasses.replace(spec, model=spec.smoke)
    for sh in shapes:
        b = steps.build_step(spec, sh, mesh, fed, train, chunk=32)
        c = {cost}
        out[a + "/" + sh.name] = {{"flops": c.flops,
                                   "coll": c.coll_bytes}}
print(json.dumps(out))
"""

_JAX = dict(pkg="repro", setup="from repro.launch.hlo_analysis import "
            "analyze\nfrom repro.launch.mesh import make_mesh\nmesh = "
            "make_mesh((2, 2), ('data', 'model'))",
            cost="analyze(b.lower().compile().as_text())")
_PORT = dict(pkg="repro_torch", setup="from repro_torch.launch.mesh import "
             "start_fake_world, make_mesh\nfrom repro_torch.launch import "
             "op_analysis\nstart_fake_world(4)\nmesh = make_mesh((2, 2), "
             "('data', 'model'), 'cpu')",
             cost="op_analysis.analyze(b.fn, *b.abstract_args)")

#: ROADMAP Queue 3 item 31: the train round's collectives at (2, 2), K = 2,
#: batch 4 × 64, remat "none" — (JAX all-reduce bytes; the port's
#: all-reduce, broadcast and all-gather bytes)
TRAIN_COLLECTIVES = {
    "gemma2-2b": (2823684, 2037252, 2560, 8),
    "qwen2-moe-a2.7b": (3755012, 2706436, 6656, 8),
    "deepseek-v3-671b": (6836100, 5789448, 289728, 0),
    "xlstm-350m": (2571268, 3235844, 598016, 8),
    "recurrentgemma-2b": (2498308, 2105092, 35328, 8),
}


@pytest.fixture(scope="module")
def mesh_costs():
    jx = forced_devices_json(textwrap.dedent(_GRID.format(
        src=SRC, archs=ARCHS, **_JAX)), devices=4, timeout=900)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_GRID.format(
        src=SRC, archs=ARCHS, **_PORT))], capture_output=True, text=True,
        timeout=900, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    return jx, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k", "long_500k"))
def test_mesh_serving_costs_equal_hlo_analysis(mesh_costs, arch, shape):
    jx, port = mesh_costs
    j, p = jx[f"{arch}/{shape}"], port[f"{arch}/{shape}"]
    assert p["flops"] == j["flops"]
    assert p["coll"] == {k: int(v) for k, v in j["coll"].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_costs_against_hlo_analysis(mesh_costs, arch):
    """FLOPs equal but for the sLSTM gap (K = 2 steps); the collectives
    are Queue 3 item 31's: the port all-reduces a replicated activation's
    gradient once per branch entry (``tp_copy``) where JAX's transpose
    psums each model-sharded consumer's partial (q, k, v; gate, up)
    apart, broadcasts replicated leaves' deltas over the model axis
    (``sync_model_replicas``; JAX's copies agree by construction), and
    gathers the clients' losses where JAX all-reduces their mean."""
    jx, port = mesh_costs
    j, p = jx[f"{arch}/train_4k"], port[f"{arch}/train_4k"]
    assert p["flops"] == j["flops"] - 2 * _slstm_gap(get_arch(arch).smoke)
    jar, par, pbc, pag = TRAIN_COLLECTIVES[arch]
    assert j["coll"] == {"all-reduce": jar}
    want = {"all-reduce": par, "broadcast": pbc}
    if pag:
        want["all-gather"] = pag
    assert p["coll"] == want
    if arch == "gemma2-2b":
        # 2 layers × (q, k, v → 2 extra; gate, up → 1 extra) × K = 2, each
        # a (2 × 64, 128) fp32 activation gradient; JAX's 4-byte loss
        # all-reduce against the port's 4-byte model-axis loss psum
        assert jar - par == 2 * 3 * 2 * (2 * 64 * 128 * 4)


# -- the sLSTM's trip count ---------------------------------------------------


def _full_trace(fn, *args):
    rec = oa.measure(fn, *args)
    return (rec.ops, rec.flops, rec.bytes, rec.rw_bytes, rec.coll_bytes,
            rec.memory["argument_size"], rec.memory["output_size"],
            rec.memory["temp_size"])


def _counted(fn, *args):
    c = oa.analyze(fn, *args)
    return (c.ops, c.flops, c.bytes, c.rw_bytes, c.coll_bytes,
            c.memory["argument_size"], c.memory["output_size"],
            c.memory["temp_size"])


@pytest.mark.parametrize("seq", (16, 32, 64))
def test_slstm_trip_count_equals_a_full_trace(seq):
    cfg = get_arch("xlstm-350m").smoke
    defs = xlstm_mod.slstm_defs(cfg.d_model, cfg.num_heads, cfg.xlstm)
    p = pdefs.tree_map(lambda d: _meta(d.shape), defs)
    x = _meta((2, seq, cfg.d_model))

    def fwd_bwd(p, x):
        leaves = [t.requires_grad_(True) for t in pdefs.tree_leaves(p)]
        out = xlstm_mod.slstm_train(p, x, cfg.num_heads, ParallelContext(),
                                    "float32")
        return torch.autograd.grad(out.sum(), leaves)

    def prefill(p, x):
        return xlstm_mod.slstm_train(p, x, cfg.num_heads, ParallelContext(),
                                     "float32", return_state=True)

    for fn in (fwd_bwd, prefill):
        assert _counted(fn, p, x) == _full_trace(fn, p, x)


@pytest.mark.parametrize("seq", (16, 32, 64))
def test_xlstm_gradient_trip_count_equals_a_full_trace(seq):
    model = Model(get_arch("xlstm-350m").smoke)
    p = pdefs.tree_map(lambda d: _meta(d.shape, getattr(torch, d.dtype)),
                       model.defs())
    tok = _meta((2, seq), torch.int32)

    def grad(p, b):
        leaves = [t.requires_grad_(True) for t in pdefs.tree_leaves(p)]
        loss, _ = model.loss(p, b, ParallelContext(), remat_policy="full",
                             chunk=8)
        return torch.autograd.grad(loss, leaves)

    batch = {"tokens": tok, "labels": tok}
    assert _counted(grad, p, batch) == _full_trace(grad, p, batch)


def test_train_round_memory_extrapolates_to_a_full_trace():
    """The xlstm smoke config's train round (``steps.build_step``: K = 2
    local steps, each with its sLSTM loop, remat "full" and "none") on a
    (1, 1) mesh of the fake process group: ``analyze``'s memory record
    and counts equal a full trace's at S = 48."""
    code = f"""
    import dataclasses, json, sys
    sys.path.insert(0, {SRC!r})
    from repro_torch.configs.base import FedConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import op_analysis as oa, steps
    from repro_torch.launch.mesh import make_mesh, start_fake_world
    start_fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    fed = FedConfig(algorithm="fedcams", compressor="topk",
                    compress_ratio=1/64, aggregation="dense", local_steps=2)
    spec = get_arch("xlstm-350m")
    spec = dataclasses.replace(spec, model=spec.smoke)
    out = []
    for remat in ("full", "none"):
        b = steps.build_step(spec, ShapeConfig("train_4k", 48, 4, "train"),
                             mesh, fed, TrainConfig(remat_policy=remat),
                             chunk=8)
        a, m = oa.analyze(b.fn, *b.abstract_args), oa.measure(
            b.fn, *b.abstract_args)
        out.append([[c.ops, c.flops, c.bytes, c.rw_bytes, c.coll_bytes,
                     c.memory] for c in (a, m)])
    print(json.dumps(out))
    """
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    for counted, full in json.loads(out.stdout.strip().splitlines()[-1]):
        assert counted == full


# -- the memory record is a plain run's ---------------------------------------

R, V = 8, 1000


def _accumulate(x):
    """x used twice: the engine sums its two (R, V) gradient terms."""
    return torch.autograd.grad((x * 2).sum() + (x * 3).sum(), x)


def _gather(x):
    idx = torch.zeros((R, 1), dtype=torch.int64, device=x.device)
    return torch.autograd.grad(x.gather(1, idx).sum(), x)


def _index(x):
    idx = torch.arange(3, device=x.device)
    return torch.autograd.grad(x[idx].sum(), x)


#: case -> (the step, the op a plain run writes in place, the twin a
#: recorder dispatches, the peak a plain run holds above its argument: the
#: loss and its cotangent (4 bytes each), the int64 indices and the (R, V)
#: fp32 gradients)
IN_PLACE = {
    "accumulate": (_accumulate, "aten::add_", "add", 2 * R * V * 4 + 8),
    "gather": (_gather, "aten::scatter_add_", "scatter_add",
               R * V * 4 + 8 + R * 8),
    "index": (_index, "aten::_index_put_impl_", "index_put",
              R * V * 4 + 8 + 3 * 8),
}


@pytest.mark.parametrize("case", sorted(IN_PLACE))
def test_the_recorder_makes_autograd_write_out_of_place_and_reckons_it_in_place(
        case):
    """Route z's over-count (Queue 3 item 35): ``at::isTensorSubclassLike``
    holds while any dispatch mode is active and for every meta tensor, and
    then autograd takes its composite-compliant branch, out of place,
    where a plain run writes in place. A profiled plain run on real CPU
    tensors shows the in-place op in its backward and not its twin; the
    recorder sees the twin; its memory record holds what the plain run
    holds (on real tensors and on meta alike), one (R, V) gradient fewer
    than the recorded run allocates. At route z's shape the twin is ``gather``'s
    backward over the (16, 4,096, 50,304) fp32 logits: 13.19 GB."""
    from torch.profiler import ProfilerActivity, profile

    fn, plain_op, twin, held = IN_PLACE[case]
    x = torch.randn(R, V, generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(x.requires_grad_(True))

    def in_backward(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if "Backward" in e.name or "evaluate_function" in e.name:
                return True
        return False

    names = {e.name for e in prof.events() if in_backward(e)}
    assert plain_op in names and f"aten::{twin}" not in names

    class Names(oa.OpCost):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen = getattr(self, "seen", set()) | {
                func.overloadpacket.__name__}
            return super().__torch_dispatch__(func, types, args, kwargs)

    for t in (x.detach(), _meta((R, V))):
        rec = Names()
        with rec:
            rec.add_arguments((t,))
            rec.close(fn(t.requires_grad_(True)))
        assert twin in rec.seen and rec.in_place == {twin: 1}
        assert rec.cost.memory["temp_size"] == held


@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_writes_reckoned_are_a_plain_runs(arch):
    """On each smoke config's loss + gradient (real CPU tensors, remat
    "full"), the writes the record counts in place are, op by op, the
    in-place writes a profiled plain run makes where the recorder's run
    makes their twins: the engine's ``add_`` into a gradient it holds the
    last reference to (never into a view: a view keeps its base), and
    ``gather``'s and indexing's backward."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_arch(arch).smoke
    model = Model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}

    def grad(p, b):
        p = pdefs.tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss, _ = model.loss(p, b, ParallelContext(), remat_policy="full",
                             chunk=CHUNK)
        return torch.autograd.grad(loss, pdefs.tree_leaves(p))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        grad(params, batch)
    #: (plain op, its parent) -> the twin the recorder dispatches
    twins = {("aten::add_", "evaluate_function"): "add",
             ("aten::scatter_add_", "aten::gather_backward"): "scatter_add",
             ("aten::_index_put_impl_", "IndexBackward0"): "index_put"}
    plain = {}
    for e in prof.events():
        parent = e.cpu_parent.name if e.cpu_parent is not None else ""
        for (name, under), twin in twins.items():
            if e.name == name and under in parent:
                plain[twin] = plain.get(twin, 0) + 1
    rec = oa._measure(grad, (params, batch), 0)
    assert rec.in_place == plain and plain["add"] > 0


#: (layer, sequence lengths): the sLSTM at S, 2S, 4S; the chunkwise mLSTM
#: at chunk 16 over 4, 8 and 16 chunks
AFFINE = {"slstm": (128, 256, 512), "mlstm_chunkwise": (64, 128, 256)}


@pytest.mark.parametrize("layer", sorted(AFFINE))
def test_forward_and_backward_bytes_are_affine_in_the_sequence(layer):
    """A sequential loop's forward and backward move bytes linear in S: a
    full trace's bytes at S, 2S and 4S satisfy ``b(4S) - b(2S) == 2 · (b(2S)
    - b(S))`` exactly (smoke widths, batch 2, fp32, the gradient of every
    parameter). The loops step over one ``unbind`` / ``split`` of their
    inputs; indexing a step (``pre[:, i]``) or slicing a chunk makes the
    backward write each step's gradient into a zero-filled copy of the
    whole tensor, and the sLSTM's bytes then read 1,727,347,712 against
    922,041,344."""
    cfg = get_arch("xlstm-350m").smoke
    ctx = ParallelContext()
    if layer == "slstm":
        defs = xlstm_mod.slstm_defs(cfg.d_model, cfg.num_heads, cfg.xlstm)
        run = lambda p, x: xlstm_mod.slstm_train(p, x, cfg.num_heads, ctx,
                                                 "float32")
    else:
        defs = xlstm_mod.mlstm_defs(cfg.d_model, cfg.num_heads, cfg.xlstm)
        run = lambda p, x: xlstm_mod.mlstm_train_chunkwise(
            p, x, cfg.num_heads, ctx, "float32", chunk=16)

    def fwd_bwd(p, x):
        leaves = [t.requires_grad_(True) for t in pdefs.tree_leaves(p)]
        return torch.autograd.grad(run(p, x).sum(), leaves)

    b = []
    for seq in AFFINE[layer]:
        p = pdefs.tree_map(lambda d: _meta(d.shape), defs)
        b.append(oa.measure(fwd_bwd, p, _meta((2, seq, cfg.d_model))).bytes)
    assert b[2] - b[1] == 2 * (b[1] - b[0]), b


def test_real_tensors_run_every_step():
    """On real tensors the loop is not capped, recorder or not."""
    cfg = get_arch("xlstm-350m").smoke
    defs = xlstm_mod.slstm_defs(cfg.d_model, cfg.num_heads, cfg.xlstm)
    g = torch.Generator().manual_seed(0)
    p = pdefs.init_params(defs, g)
    x = torch.randn(1, 6, cfg.d_model, generator=g)
    want = xlstm_mod.slstm_train(p, x, cfg.num_heads, ParallelContext(),
                                 "float32")
    with oa.OpCost(max_trips=2):
        got = xlstm_mod.slstm_train(p, x, cfg.num_heads, ParallelContext(),
                                    "float32")
    assert torch.equal(got, want)


# -- the roofline copy ----------------------------------------------------------


def test_roofline_equals_the_reference_on_the_same_constants():
    spec = tmesh.backend_spec()
    assert (spec.name, spec.peak_flops_bf16, spec.hbm_bw,
            spec.ici_bw_per_link) == ("h100_sxm", 989e12, 3.35e12, 450e9)
    jspec = jmesh.BackendSpec(spec.name, spec.peak_flops_bf16, spec.hbm_bw,
                              spec.ici_bw_per_link)
    rng = np.random.default_rng(0)
    for _ in range(20):
        flops, hbm, coll = (float(v) for v in rng.uniform(0, 1e15, 3))
        chips = int(rng.integers(1, 513))
        mf = float(rng.uniform(0, 1e18))
        got = troofline._mk_roofline(flops, hbm, coll, chips=chips,
                                     model_flops=mf, spec=spec).to_dict()
        want = jroofline._mk_roofline(flops, hbm, coll, chips=chips,
                                      model_flops=mf, spec=jspec).to_dict()
        assert got == want
    for arch in ARCHS:
        for kind, steps in (("train", 4), ("prefill", 1), ("decode", 1)):
            assert troofline.model_flops_for(
                get_arch(arch).model, kind, 4096.0, steps) == \
                jroofline.model_flops_for(jax_arch(arch).model, kind, 4096.0,
                                          steps)


def test_roofline_from_cost_reads_the_cost_record():
    cost = oa.StepCost(flops=989e12, bytes=3.35e12,
                       coll_bytes={"all-reduce": 225e9, "all-gather": 450e9},
                       coll_count={"all-reduce": 1, "all-gather": 1})
    rl = troofline.roofline_from_cost(cost, chips=1, model_flops=989e12)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(2.0)
    assert rl.dominant == "collective" and rl.useful_ratio == 1.0
    stats = troofline.CollectiveStats({"all-reduce": 10, "broadcast": 3})
    assert stats.weighted_bytes == 23.0
    assert dataclasses.is_dataclass(rl)
