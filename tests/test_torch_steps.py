"""``launch/steps.py`` against ``repro.launch.steps``.

* The resolution helpers over all 10 archs × the 4 ``INPUT_SHAPES`` ×
  meshes (16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 4):
  ``resolve_fed`` (client axes, m, state shards), the fields of
  ``train_ctx`` and of ``serve_ctx`` with and without the sequence axis,
  ``serve_batch_axes``, ``remap_defs`` of the decode caches,
  ``variant_for_shape`` and ``shape_allowed``. The JAX side takes a
  stand-in mesh (``axis_names``, ``devices.shape``: no devices); the port
  runs in one subprocess on ``DeviceMesh``es over the fake process group.
* The abstract arguments: every leaf of each bundle's ``abstract_args``
  (rank 0's local shapes, on ``meta``) against the JAX bundle's
  per-device shard shape, smoke configs at mesh (2, 2), JAX on 4 forced
  host devices.
* Sequence-sharded decode: ``build_decode_step`` at
  ``ShapeConfig("long_500k", 64, 1, "decode")`` on the gemma2-2b smoke
  config in fp32, two gloo CPU ranks of a (2, 1) mesh against JAX's
  ``build_decode_step`` on a (2, 1) mesh of forced host devices, from the
  same staged params and cache: four steps whose slots cross from one
  rank's block to the other's, logits within 1e-5 (fp32; the blocks'
  log-sum-exp combine reorders the sums).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import forced_devices_json, run_forced_devices
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as jax_arch
from repro.launch import steps as jsteps
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import steps as tsteps
from repro_torch.models import params as pdefs
from repro_torch.models.model import Model
from test_torch_mesh import spawn
from test_torch_tp import staged

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
SMOKE = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b", "xlstm-350m",
         "recurrentgemma-2b", "hubert-xlarge")
SEQ_TOL = 1e-5


def _stand_in(shape, axes):
    return SimpleNamespace(axis_names=axes,
                           devices=SimpleNamespace(shape=shape))


_CTX_FIELDS = ("model_axis", "tp", "data_axis", "dp", "client_axes",
               "num_clients", "seq_axis", "seq_shards", "tp_collective")


def _jax_helpers():
    out = {}
    for mname, (shape, axes) in MESHES.items():
        mesh = _stand_in(shape, axes)
        for arch in ARCH_IDS:
            spec = jax_arch(arch)
            fed = jsteps.resolve_fed(spec, JaxFedConfig(), mesh)
            out[f"{mname}/{arch}"] = {
                "fed": [list(fed.client_axes), fed.num_clients,
                        fed.state_shards],
                "train": [_norm(getattr(jsteps.train_ctx(fed, mesh, tc), f))
                          for tc in ("psum", "rs_ag") for f in _CTX_FIELDS],
                "serve": [_norm(getattr(jsteps.serve_ctx(mesh,
                                                         seq_sharded=s), f))
                          for s in (False, True) for f in _CTX_FIELDS],
                "batch_axes": list(jsteps.serve_batch_axes(mesh)),
            }
    return out


def _norm(v):
    return list(v) if isinstance(v, tuple) else v


_PORT_HELPERS = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, start_fake_world
FIELDS = {fields!r}
norm = lambda v: list(v) if isinstance(v, tuple) else v
out = {{}}
for mname, (shape, axes) in {meshes!r}.items():
    world = 1
    for s in shape:
        world *= s
    start_fake_world(world)
    mesh = make_mesh(shape, axes, "cpu")
    assert steps.mesh_axis_sizes(mesh) == dict(zip(axes, shape))
    for arch in ARCH_IDS:
        spec = get_arch(arch)
        fed = steps.resolve_fed(spec, FedConfig(), mesh)
        out[mname + "/" + arch] = {{
            "fed": [list(fed.client_axes), fed.num_clients,
                    fed.state_shards],
            "train": [norm(getattr(steps.train_ctx(fed, mesh, tc), f))
                      for tc in ("psum", "rs_ag") for f in FIELDS],
            "serve": [norm(getattr(steps.serve_ctx(mesh, seq_sharded=s), f))
                      for s in (False, True) for f in FIELDS],
            "batch_axes": list(steps.serve_batch_axes(mesh)),
        }}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def helpers():
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _PORT_HELPERS.format(src=SRC, fields=_CTX_FIELDS, meshes=MESHES))],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    return _jax_helpers(), json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", MESHES)
def test_resolution_helpers_match_the_reference(helpers, mesh):
    want, got = helpers
    for arch in ARCH_IDS:
        assert got[f"{mesh}/{arch}"] == want[f"{mesh}/{arch}"], arch


@pytest.mark.parametrize("shape", INPUT_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_policy_matches_the_reference(arch, shape):
    spec, jspec = get_arch(arch), jax_arch(arch)
    sh, jsh = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    assert tsteps.shape_allowed(spec, sh) == jsteps.shape_allowed(jspec, jsh)
    got, want = (tsteps.variant_for_shape(spec, sh),
                 jsteps.variant_for_shape(jspec, jsh))
    assert (got.attn_pattern, got.layer_windows) == (want.attn_pattern,
                                                     want.layer_windows)
    if sh.kind != "decode" or not spec.has_decode:
        return
    # the decode caches' specs, batch dim remapped onto ("pod", "data")
    for tp in (1, 16):
        cd = Model(got, tp=tp).cache_defs(sh.global_batch, sh.seq_len)
        jcd = JaxModel(want, tp=tp).cache_defs(jsh.global_batch,
                                               jsh.seq_len)
        m = {"data": ("pod", "data")}
        got_specs = [(p, d.shape, tuple(d.spec)) for p, d in
                     pdefs.leaves_with_paths(tsteps.remap_defs(cd, m))]
        import jax
        from repro.models.params import is_def
        want_specs = [(tuple(k.key for k in path), d.shape, tuple(d.spec))
                      for path, d in jax.tree_util.tree_flatten_with_path(
                          jsteps.remap_defs(jcd, m), is_leaf=is_def)[0]]
        assert got_specs == want_specs


# -- abstract arguments ----------------------------------------------------------

_SHAPES = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
from {pkg}.configs.base import FedConfig, TrainConfig, ShapeConfig
from {pkg}.configs.registry import get_arch
from {pkg}.launch import steps
{setup}
fed = FedConfig(algorithm="fedcams", compressor="topk", compress_ratio=1/64,
                aggregation="dense", local_steps=2)
shapes = [ShapeConfig("train_4k", 64, 4, "train"),
          ShapeConfig("prefill_32k", 64, 4, "prefill"),
          ShapeConfig("decode_32k", 64, 4, "decode"),
          ShapeConfig("long_500k", 64, 2, "decode")]
out = {{}}
for a in {archs!r}:
    spec = get_arch(a)
    spec = dataclasses.replace(spec, model=spec.smoke)
    for sh in shapes:
        ok, _ = steps.shape_allowed(spec, sh)
        if not ok:
            continue
        b = steps.build_step(spec, sh, mesh, fed, TrainConfig(), chunk=32)
        out[a + "/" + sh.name] = leaves(b.abstract_args)
print(json.dumps(out))
"""

_JAX_SETUP = """
import jax
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"))

def key(k):
    for f in ("key", "name", "idx"):
        if hasattr(k, f):
            return str(getattr(k, f))

def leaves(args):
    flat = jax.tree_util.tree_flatten_with_path(args)[0]
    return [["/".join(key(k) for k in path), list(
        x.sharding.shard_shape(x.shape) if getattr(x, "sharding", None)
        else x.shape)] for path, x in flat]
"""

_PORT_SETUP = """
import torch
from repro_torch.launch.mesh import make_mesh, start_fake_world
start_fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")

def leaves(x, path=()):
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in leaves(x[k], path + (k,))]
    if hasattr(x, "_fields"):
        return [l for k in x._fields for l in leaves(getattr(x, k),
                                                       path + (k,))]
    if isinstance(x, (tuple, list)):
        return [l for i, v in enumerate(x) for l in leaves(v, path + (str(i),))]
    assert not isinstance(x, torch.Tensor) or x.is_meta or x.dim() == 0
    return [["/".join(path), list(getattr(x, "shape", ()))]]
"""


def test_abstract_args_are_the_reference_per_device_shards():
    jx = forced_devices_json(textwrap.dedent(_SHAPES.format(
        src=SRC, pkg="repro", setup=_JAX_SETUP, archs=SMOKE)), devices=4,
        timeout=600)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _SHAPES.format(src=SRC, pkg="repro_torch", setup=_PORT_SETUP,
                       archs=SMOKE))], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    port = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(port) == sorted(jx) and len(port) == 5 * 4 + 2
    for case in jx:
        assert port[case] == jx[case], case


# -- sequence-sharded decode against JAX ------------------------------------------

SEQ_SHAPE = ("long_500k", 64, 1, "decode")
SEQ_POS = (30, 31, 32, 33)       # the slots cross from rank 0's to rank 1's


def _seq_inputs():
    """Staged fp32 params (tp 1: whole on every rank), a random global
    cache and the tokens, as numpy."""
    spec = get_arch("gemma2-2b")
    model = Model(spec.smoke)
    params = staged(model.defs(), 4)
    cdefs = model.cache_defs(1, 64, seq_sharded=True)
    cache = staged(cdefs, 5)
    toks = np.random.default_rng(6).integers(
        0, spec.smoke.vocab_size, size=(1, len(SEQ_POS))).astype(np.int32)
    return params, cache, toks


def _seq_rank(rank, world, inputs):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models.params import take_shard, tree_map
    params, cache, toks = inputs
    spec = get_arch("gemma2-2b")
    spec = dataclasses.replace(spec, model=spec.smoke)
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    b = build_decode_step(spec, ShapeConfig(*SEQ_SHAPE), mesh)
    assert b.ctx.seq_shards == 2 and b.description.endswith("(seq-sharded "
                                                            "cache)")
    cdefs = b.model.cache_defs(1, 64, seq_sharded=True)
    caches = tree_map(lambda a, d: take_shard(torch.from_numpy(a), d,
                                              b.ctx).contiguous(),
                      cache, cdefs)
    # the abstract cache is this rank's block
    assert [tuple(t.shape) for t in pdefs.tree_leaves(b.abstract_args[2])] \
        == [tuple(t.shape) for t in pdefs.tree_leaves(caches)]
    p = tree_map(torch.from_numpy, params)
    logits = []
    with torch.no_grad():
        for i, pos in enumerate(SEQ_POS):
            lg, caches = b.fn(p, torch.from_numpy(toks[:, i:i + 1]), caches,
                              pos)
            logits.append(lg.numpy())
    return np.stack(logits)


_JAX_SEQ = """
import dataclasses, sys
import numpy as np
sys.path.insert(0, {src!r})
import jax
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_arch
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_decode_step
d = dict(np.load({path!r}, allow_pickle=True))
params, cache, toks = d["params"].item(), d["cache"].item(), d["toks"]
spec = get_arch("gemma2-2b")
spec = dataclasses.replace(spec, model=spec.smoke)
b = build_decode_step(spec, ShapeConfig(*{shape!r}),
                      make_mesh((2, 1), ("data", "model")))
out = []
for i, pos in enumerate({pos!r}):
    lg, cache = b.fn(params, toks[:, i:i + 1], cache, np.int32(pos))
    out.append(np.asarray(lg))
np.save({out!r}, np.stack(out))
"""


def test_seq_sharded_decode_bundle_matches_the_reference():
    inputs = _seq_inputs()
    got = spawn(_seq_rank, 2, inputs, timeout=600)
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npy")
        np.savez(path, params=np.array(inputs[0], dtype=object),
                 cache=np.array(inputs[1], dtype=object), toks=inputs[2])
        run_forced_devices(textwrap.dedent(_JAX_SEQ.format(
            src=SRC, path=path, shape=SEQ_SHAPE, pos=SEQ_POS, out=out)),
            devices=2, timeout=600)
        want = np.load(out)
    assert got.shape == want.shape == (len(SEQ_POS), 1, 512)
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= SEQ_TOL, err
