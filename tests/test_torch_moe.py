"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU at small sizes.

Parameters and inputs are drawn from a numpy seed and handed to both
packages. Each tolerance is stated where it is set:

* the five tests of ``tests/test_moe.py``, mirrored on the port under the
  same names;
* ``router_probs``, ``moe_ffn`` (its output and aux loss) and
  ``moe_ffn_dense_ref`` against the JAX functions at capacity factors
  0.25, 1.25 and 16 (drops, a few drops, none), with fp32 activations on
  fp32 or bf16 weights and bf16 on bf16;
* the dispatch, fed the JAX router's probs, bitwise the reference's
  (``gates``, ``top_idx``, ``C``, ``w_tok``, ``tok_idx``, ``valid``), also on
  a crafted probs matrix full of tied gates;
* the gradient of ``sum(out) + aux`` for the router, the experts and the
  shared FFN against ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import MoEConfig as JaxMoE
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import model_params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.params import init_params, leaves_with_paths
from repro_torch.sharding.rules import ParallelContext

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()


# -- tests/test_moe.py on the port -------------------------------------------


def _setup(E=4, k=2, d=32, dff=64, shared=1, cf=8.0, seed=0):
    mo = MoEConfig(num_experts=E, top_k=k, num_shared_experts=shared,
                   d_ff_expert=dff, d_ff_shared=dff, capacity_factor=cf)
    params = init_params(tmoe.moe_defs(d, mo, tp=1),
                         torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(2, 8, d)).astype(np.float32))
    return mo, params, x


def test_gather_dispatch_matches_dense_at_high_capacity():
    """With capacity >= tokens, no drops: gather dispatch == dense ref."""
    mo, params, x = _setup(cf=16.0)
    out, aux = tmoe.moe_ffn(params, x, mo, CTX, dtype="float32")
    ref = tmoe.moe_ffn_dense_ref(params, x, mo, CTX, dtype="float32")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_capacity_drops_reduce_output_not_nan():
    mo, params, x = _setup(cf=0.25)
    out, aux = tmoe.moe_ffn(params, x, mo, CTX, dtype="float32")
    assert bool(torch.isfinite(out).all())


def test_padded_experts_never_selected():
    """qwen2-moe style: experts padded to a tp multiple get -1e30
    logits."""
    mo = MoEConfig(num_experts=3, top_k=2, d_ff_expert=16)
    params = init_params(tmoe.moe_defs(16, mo, tp=4),
                         torch.Generator().manual_seed(0))
    assert params["w_up"].shape[0] == 4  # padded
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(12, 16)).astype(np.float32))
    probs = tmoe.router_probs(params, x, mo, "float32")
    assert float(probs[:, 3:].max()) == 0.0


def test_aux_loss_prefers_balance():
    """Uniform router => aux ≈ weight; collapsed router => larger."""
    mo, params, x = _setup(E=4, k=1, shared=0)
    _, aux_u = tmoe.moe_ffn(params, x, mo, CTX, dtype="float32")
    # collapse: bias router to expert 0
    p2 = dict(params)
    p2["router"] = params["router"] * 0.0 + torch.eye(32, 4) * 100.0
    _, aux_c = tmoe.moe_ffn(p2, x, mo, CTX, dtype="float32")
    assert float(aux_c) > float(aux_u)


def test_gates_renormalized():
    mo, params, x = _setup()
    xf = x.reshape(-1, x.shape[-1])
    probs = tmoe.router_probs(params, xf, mo, "float32")
    gates = tmoe.dispatch(probs, mo).gates
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)


# -- against the JAX package -------------------------------------------------

#: (activation dtype, the ``dtype`` the weights are cast to): the smoke
#: configs' fp32, fp32 activations on bf16 weights (JAX promotes the
#: einsums to fp32), and the full configs' bf16 on bf16
DTYPES = [("float32", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "bfloat16")]
#: |port − JAX| ≤ tol · max|JAX|, by the dtype the matmuls compute in (the
#: activations'): fp32 matmuls differ only in summation order (measured
#: 1.4e-7); in bf16 each einsum, the activation and the scatter-add round
#: to 8 bits (a bf16 ulp is 2^-8 of the value) in each package's own way
#: (measured 3.2e-3)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(E=6, k=2, d=32, dff=48, shared=2, cf=1.25, tp=1, seed=0):
    """The same MoE block for both packages: configs, params drawn from a
    numpy seed in the JAX defs' shapes and scales, JAX's and the port's."""
    kw = dict(num_experts=E, top_k=k, num_shared_experts=shared,
              d_ff_expert=dff, d_ff_shared=2 * dff, capacity_factor=cf)
    jmo, tmo = JaxMoE(**kw), MoEConfig(**kw)
    r = np.random.default_rng(seed)
    flat, td = jax.tree_util.tree_flatten(jmoe.moe_defs(d, jmo, tp),
                                          is_leaf=jparams.is_def)
    leaves = [(r.normal(size=dd.shape) * dd.scale).astype(np.float32)
              for dd in flat]
    tree = jax.tree_util.tree_unflatten(td, leaves)
    jp = jax.tree.map(jnp.asarray, tree)
    return jmo, tmo, jp, model_params_from_jax(tree, "cpu")


def _x(xdt, T=48, d=32, seed=1):
    x = np.random.default_rng(seed).normal(size=(2, T // 2, d)).astype(
        np.float32)
    return (jnp.asarray(x).astype(xdt),
            torch.from_numpy(x).to(getattr(torch, xdt)))


def close(got, want, rel, what=""):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * np.abs(want).max() + 1e-30, (what, err,
                                                      np.abs(want).max())


@pytest.mark.parametrize("xdt,dtype", DTYPES)
def test_router_probs_match_jax(xdt, dtype):
    """The fp32 probs within 1e-6 of the largest (fp32 softmax of logits
    that are exact but for the matmul's summation order; at bf16 on bf16
    the logits round to bf16 first, alike in both packages), with padded
    experts at exactly 0."""
    jmo, tmo, jp, tp = _pair(E=5, tp=4)
    jx, tx = _x(xdt)
    want = jmoe.router_probs(jp, jx.reshape(-1, 32), jmo, dtype)
    got = tmoe.router_probs(tp, tx.reshape(-1, 32), tmo, dtype)
    assert got.dtype == torch.float32 and got.shape == (48, 8)
    close(got, want, 1e-6 if (xdt, dtype) != ("bfloat16", "bfloat16")
          else 2e-6)
    assert float(got[:, 5:].max()) == 0.0


@pytest.mark.parametrize("xdt,dtype", DTYPES)
@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
def test_moe_ffn_matches_jax(cf, xdt, dtype):
    """``moe_ffn``'s output within ``TOL`` of the largest |value| and its
    aux loss within 1e-6 relative, at 48 tokens on 6 experts, top 2 (C =
    4, 20 and 48 slots an expert), with 2 shared experts."""
    jmo, tmo, jp, tp = _pair(cf=cf)
    jx, tx = _x(xdt)
    jout, jaux = jmoe.moe_ffn(jp, jx, jmo, JCTX, dtype=dtype)
    with torch.no_grad():
        out, aux = tmoe.moe_ffn(tp, tx, tmo, CTX, dtype=dtype)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    close(out, jout, TOL[xdt], f"out cf={cf}")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("xdt,dtype", DTYPES)
def test_moe_ffn_dense_ref_matches_jax(xdt, dtype):
    jmo, tmo, jp, tp = _pair()
    jx, tx = _x(xdt)
    want = jmoe.moe_ffn_dense_ref(jp, jx, jmo, JCTX, dtype=dtype)
    with torch.no_grad():
        got = tmoe.moe_ffn_dense_ref(tp, tx, tmo, CTX, dtype=dtype)
    assert got.dtype == tx.dtype
    close(got, want, TOL[xdt])


def _reference_dispatch(probs, mo):
    """``repro/models/moe.py:70-84`` at tp = 1 (the reference's routing
    lines, which ``moe_ffn`` keeps inside)."""
    T, E = probs.shape
    gates, top_idx = lax.top_k(probs, mo.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    sel = jnp.zeros((T, E), jnp.float32)
    sel = jax.vmap(lambda s, i, g: s.at[i].set(g))(sel, top_idx, gates)
    C = max(1, min(T, int(mo.capacity_factor * mo.top_k * T / E + 0.999)))
    w_tok, tok_idx = lax.top_k(sel.T, C)
    return dict(gates=gates, top_idx=top_idx, sel=sel, C=C, w_tok=w_tok,
                tok_idx=tok_idx, valid=w_tok > 0.0)


def _tied_probs():
    """(20, 5) probs whose rows tie: all equal, pairs equal at the top,
    ties at the k-th place, zeros, and the same row repeated, so that both
    top-ks (per token, and per expert over mostly-zero columns) meet ties
    above, at and below the cut."""
    rows = [[0.2] * 5, [0.4, 0.4, 0.1, 0.1, 0.0], [0.1, 0.3, 0.3, 0.3, 0.0],
            [0.0, 0.0, 0.5, 0.5, 0.0], [0.25, 0.25, 0.25, 0.25, 0.0],
            [0.6, 0.1, 0.1, 0.1, 0.1], [0.0, 0.0, 0.0, 0.0, 1.0]]
    r = np.array(rows * 3, np.float32)[:20]
    return r / r.sum(-1, keepdims=True)


def _same(got: tmoe.Dispatch, want: dict, what: str):
    assert got.C == want["C"], what
    for name in ("gates", "top_idx", "sel", "w_tok", "tok_idx", "valid"):
        g, w = getattr(got, name).numpy(), np.asarray(want[name])
        assert g.shape == w.shape, (what, name)
        if g.dtype.kind == "f":
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), (
                what, name)
        else:
            assert np.array_equal(g, w), (what, name)


@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_dispatch_is_bitwise_the_reference(cf, k):
    """Fed the JAX router's probs, the port's dispatch is the reference's
    to the bit (eagerly and under ``jax.jit``), and so is it on a crafted
    matrix of tied gates: both top-ks send ties to the lowest index."""
    jmo, tmo, jp, _ = _pair(E=6, k=k, cf=cf)
    jx, _ = _x("float32", T=64)
    cases = {"router": np.array(jmoe.router_probs(
        jp, jx.reshape(-1, 32), jmo, "float32")), "ties": _tied_probs()}
    jitted = jax.jit(_reference_dispatch, static_argnums=1)
    for what, probs in cases.items():
        mo = tmo if what == "router" else MoEConfig(
            num_experts=5, top_k=min(k, 5), capacity_factor=cf)
        got = tmoe.dispatch(torch.from_numpy(probs), mo)
        _same(got, _reference_dispatch(jnp.asarray(probs), mo), what)
        _same(got, jitted(jnp.asarray(probs), mo), f"{what} jit")
    # the ties really tie: some expert's slots end in gates that equal the
    # first one left out, so the index order decided the cut
    t = tmoe.dispatch(torch.from_numpy(_tied_probs()), MoEConfig(
        num_experts=5, top_k=min(k, 5), capacity_factor=cf))
    ranked = torch.sort(t.sel.T, dim=-1, descending=True, stable=True)[0]
    if t.C < ranked.shape[1]:
        assert bool((ranked[:, t.C - 1] == ranked[:, t.C]).any())


@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
def test_gradient_matches_jax_grad(cf):
    """The gradient of ``sum(out) + aux`` (fp32) for every leaf — the
    router (through the gathered gates and ``imp``), the three expert
    stacks and the shared FFN — within 2e-5 of the leaf's largest |∂|
    (``jax.grad``; the matmuls' summation orders differ)."""
    jmo, tmo, jp, tp = _pair(cf=cf)
    jx, tx = _x("float32")

    def jloss(p):
        out, aux = jmoe.moe_ffn(p, jx, jmo, JCTX, dtype="float32")
        return jnp.sum(out) + aux

    jg = dict(leaves_with_paths(jax.device_get(jax.grad(jloss)(jp))))
    params = {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
                  else {kk: vv.clone().requires_grad_(True)
                        for kk, vv in v.items()}) for k, v in tp.items()}
    out, aux = tmoe.moe_ffn(params, tx, tmo, CTX, dtype="float32")
    (out.sum() + aux).backward()
    paths = [p for p, _ in leaves_with_paths(params)]
    assert paths == sorted(jg) and ("router",) in paths
    for path, leaf in leaves_with_paths(params):
        close(leaf.grad, jg[path], 2e-5, f"grad {path}")
