"""Flat-vector layout, weight conversion, and the paper models: the port
against the JAX package on the same (converted) params and batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import server_opt as jso
from repro.models import convmixer as jcm
from repro.models import params as jp
from repro_torch.convert import (flat_from_jax, params_from_jax,
                                 server_state_from_jax)
from repro_torch.models import convmixer as tcm
from repro_torch.models import params as tp

torch.set_num_threads(1)

SMALL_CM = dict(dim=32, depth=2, kernel=5, patch=2, num_classes=10, image=16)
MLP = dict(in_dim=32, hidden=64, depth=2, num_classes=10)


def _defs(model):
    if model == "convmixer":
        return (jcm.convmixer_defs(jcm.ConvMixerConfig(**SMALL_CM)),
                tcm.convmixer_defs(tcm.ConvMixerConfig(**SMALL_CM)))
    return (jcm.mlp_defs(jcm.MLPConfig(**MLP)),
            tcm.mlp_defs(tcm.MLPConfig(**MLP)))


@pytest.mark.parametrize("model", ["mlp", "convmixer"])
def test_ravel_order_and_convert_match_ravel_pytree(model):
    jdefs, tdefs = _defs(model)
    p = jax.device_get(jp.init_params(jdefs, jax.random.PRNGKey(3)))
    jflat, _ = ravel_pytree(p)
    tparams = params_from_jax(p)
    flat, unravel = tp.ravel(tparams)
    np.testing.assert_array_equal(np.asarray(jflat), flat.numpy())
    np.testing.assert_array_equal(np.asarray(jflat),
                                  flat_from_jax(p).numpy())
    assert flat.numel() == jp.count_params(jdefs) == tp.count_params(tdefs)
    # unravel returns views in the JAX shapes, in the same tree
    back = unravel(flat)
    jleaves = jax.tree_util.tree_flatten_with_path(p)[0]
    for (path, leaf) in jleaves:
        node = back
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    flat[0] = 123.0   # views write through
    first_path = next(iter(tp.leaves_with_paths(back)))[0]
    node = back
    for key in first_path:
        node = node[key]
    assert node.reshape(-1)[0] == 123.0


def test_convmixer_256_8_layout():
    """The slice's model: d = 704,266, keys in ravel order."""
    defs = tcm.convmixer_defs(tcm.ConvMixerConfig())
    assert tp.count_params(defs) == 704266
    order = [p for p, _ in tp.leaves_with_paths(defs)]
    assert [p[0] for p in order[:6]] == ["block0"] * 6
    assert [p[1] for p in order[:6]] == ["dw", "dw_b", "dw_s", "pw", "pw_b",
                                         "pw_s"]
    assert [p[0] for p in order[-4:]] == ["head", "head_b", "patch_b",
                                          "patch_w"]


def test_init_params_draws_from_the_generator():
    defs = tcm.mlp_defs(tcm.MLPConfig(**MLP))
    a = tp.init_params(defs, torch.Generator().manual_seed(0))
    b = tp.init_params(defs, torch.Generator().manual_seed(0))
    c = tp.init_params(defs, torch.Generator().manual_seed(1))
    assert torch.equal(tp.ravel(a)[0], tp.ravel(b)[0])
    assert not torch.equal(tp.ravel(a)[0], tp.ravel(c)[0])
    assert float(a["b0"].abs().sum()) == 0.0
    assert abs(float(a["w0"].std()) - 32 ** -0.5) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_server_state_from_jax(dtype):
    x = jnp.asarray(np.random.default_rng(0).normal(size=700), jnp.float32)
    st = jax.device_get(jso.init_server_state(x, dtype, 256))
    st = st._replace(t=np.int32(5))
    ts = server_state_from_jax(st)
    assert int(ts.t) == 5
    np.testing.assert_array_equal(ts.m.numpy(), np.asarray(st.m))
    if dtype == "int8":
        assert ts.v.q.dtype == torch.int8 and ts.v.q.shape == (768,)
        np.testing.assert_array_equal(ts.vhat.scale.numpy(),
                                      np.asarray(st.vhat.scale))
    else:
        assert ts.v.dtype == getattr(torch, dtype)
        assert ts.v.shape == (700,)


def _batch(model, seed):
    r = np.random.default_rng(seed)
    shape = (6, 16, 16, 3) if model == "convmixer" else (6, 32)
    return {"x": r.normal(size=shape).astype(np.float32),
            "y": r.integers(0, 10, size=6).astype(np.int32)}


@pytest.mark.parametrize("model", ["mlp", "convmixer"])
def test_model_loss_and_grads_match_jax(model):
    """Same converted params, same batch: loss and gradient (on the flat
    vector, in ravel order) within rtol 1e-5."""
    jdefs, _ = _defs(model)
    if model == "convmixer":
        jc, tc = (jcm.ConvMixerConfig(**SMALL_CM),
                  tcm.ConvMixerConfig(**SMALL_CM))
        jloss = lambda p, b: jcm.convmixer_loss(p, b, jc)
        tloss = lambda p, b: tcm.convmixer_loss(p, b, tc)
    else:
        jc, tc = jcm.MLPConfig(**MLP), tcm.MLPConfig(**MLP)
        jloss = lambda p, b: jcm.mlp_loss(p, b, jc)
        tloss = lambda p, b: tcm.mlp_loss(p, b, tc)
    p = jp.init_params(jdefs, jax.random.PRNGKey(1))
    # nonzero biases and scales so every leaf's gradient path is exercised
    p = jax.tree.map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size)
                                                  ).reshape(a.shape), p)
    b = _batch(model, 2)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        p, jax.tree.map(jnp.asarray, b))
    jgflat, _ = ravel_pytree(jg)

    flat, unravel = tp.ravel(params_from_jax(jax.device_get(p)))
    flat.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tl, taux = tloss(unravel(flat), tb)
    (tg,) = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(taux["acc"]) == float(jaux["acc"])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jgflat), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgflat).max()))
