"""The port's Griffin recurrent block (``repro_torch.models.rglru``)
against ``repro.models.rglru``, on the CPU at smoke size.

Params and inputs are drawn with numpy from a seed. Each tolerance is
stated where it is set.

* ``associative_scan`` is ``lax.associative_scan`` run eagerly, to the
  bit, at every length up to 17 and at 31–33, 63–65, 100, 257 and 512
  (odd and even levels of the recursion). Under ``jit`` XLA:CPU contracts
  ``a2·b1 + b2`` into an FMA, so there the two differ in the last bit;
  the model's tests hold them within a tolerance.
* ``_causal_conv`` (train and decode state) bitwise; the gates within a
  few ulps (sigmoid, exp and logaddexp are each library's own); the decay
  in (0, 1] (``test_recurrent_refs.py``'s check on the port).
* ``rglru_train`` with its final state and ``rglru_decode`` against the
  JAX functions in fp32 and bf16, the gradient against ``jax.grad``, and
  ``rglru_train`` against the port's own step-by-step decode
  (``test_recurrent_refs.py::test_rglru_train_matches_stepwise_decode``
  on the port).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import RGLRUConfig as JaxRG
from repro.models import rglru as jrg
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import RGLRUConfig
from repro_torch.models import rglru as trg
from repro_torch.sharding.rules import ParallelContext

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
D, W = 32, 48
R, JR = RGLRUConfig(lru_width=W, conv_width=4), JaxRG(lru_width=W,
                                                      conv_width=4)


def _params(seed=0):
    """numpy params of ``rglru_defs`` (biases drawn too, so they
    matter)."""
    r = np.random.default_rng(seed)
    out = {}
    for k, d in trg.rglru_defs(D, R).items():
        scale = d.scale if d.init == "normal" else 0.3
        out[k] = (r.normal(size=d.shape) * scale).astype(np.float32)
    return out


def _x(B, S, seed=1, width=D):
    return np.random.default_rng(seed).normal(size=(B, S, width)).astype(
        np.float32)


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max|want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, dtype=np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def test_defs_equal_the_reference():
    jd, td = jrg.rglru_defs(D, JR), trg.rglru_defs(D, R)
    assert sorted(jd) == sorted(td)
    for k in td:
        assert (td[k].shape, td[k].init, td[k].scale) == (
            tuple(jd[k].shape), jd[k].init, jd[k].scale), k
        assert td[k].dim_specs == tuple(jd[k].spec) + (None,) * (
            len(td[k].shape) - len(jd[k].spec)), k


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("lengths", [range(1, 18), (31, 32, 33, 63, 64,
                                                    65, 100, 257, 512)])
def test_associative_scan_is_the_eager_reference_to_the_bit(lengths):
    """h (the scanned b) equal to JAX's eager ``lax.associative_scan``,
    bit for bit, with a -0.0 in the input (the interleave's zero-padded
    add turns it to +0.0 on both sides). The scanned decays are not
    compared: XLA:CPU flushes their denormal products to zero."""
    for S in lengths:
        r = np.random.default_rng(S)
        a = r.uniform(0.0, 1.0, size=(2, S, 5)).astype(np.float32)
        b = r.normal(size=(2, S, 5)).astype(np.float32)
        b[0, 0, 0] = -0.0
        _, want = lax.associative_scan(_combine, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
        _, got = trg.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(want).view(np.int32)), S


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_bitwise(with_state):
    """The taps summed left to right from ``0 +``: the same fp32 products
    and sums, so the same bits (the decode state too)."""
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 9, W)).astype(np.float32)
    k = r.normal(size=(4, W)).astype(np.float32)
    st = r.normal(size=(2, 3, W)).astype(np.float32) if with_state else None
    jy, js = jrg._causal_conv(jnp.asarray(x), jnp.asarray(k),
                              None if st is None else jnp.asarray(st))
    ty, ts = trg._causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                              None if st is None else torch.from_numpy(st))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_gates_match_and_the_decay_is_in_the_unit_interval():
    """a and b within 2e-6 of their largest |value| (sigmoid, exp,
    logaddexp: a few ulps apart between the libraries); a in (0, 1], as
    ``test_recurrent_refs.py::test_rglru_decay_in_unit_interval`` checks
    on the reference."""
    p = _params(4)
    xc = _x(2, 5, 5, W) * 3
    ja, jb = jrg._gates(_j(p), jnp.asarray(xc), JR)
    ta, tb = trg._gates(_t(p), torch.from_numpy(xc), R)
    close(ta, ja, 2e-6, "a")
    close(tb, jb, 2e-6, "b")
    assert float(ta.min()) > 0.0 and float(ta.max()) <= 1.0


#: (compute dtype, tolerance). fp32: 1e-5 of the largest |value| (the
#: projections' summation order and the gates' ulps). bf16: the
#: projections agree to the bit, but ``jax.nn.gelu`` rounds its inner ops
#: to bf16 where PyTorch's rounds once (the gate differs by up to 4.6e-3
#: of its largest value), and the output projection sums 48 such products:
#: 2e-2 (measured 1.06e-2)
DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rglru_train_and_its_state_match_jax(dtype, tol):
    p, x = _params(6), _x(2, 37, 7)
    want, jst = jrg.rglru_train(_j(p), jnp.asarray(x).astype(dtype), JR,
                                JCTX, dtype, return_state=True)
    got, tst = trg.rglru_train(_t(p), torch.from_numpy(x).to(getattr(
        torch, dtype)), R, CTX, dtype, return_state=True)
    assert got.dtype == getattr(torch, dtype)
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == got.dtype
    close(got, want, tol, "out")
    close(tst.h, jst.h, tol, "h")
    close(tst.conv, jst.conv, tol, "conv")


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rglru_decode_matches_jax(dtype, tol):
    r = np.random.default_rng(8)
    p, x = _params(9), _x(2, 1, 10)
    h = r.normal(size=(2, W)).astype(np.float32)
    conv = r.normal(size=(2, 3, W)).astype(np.float32)
    want, jst = jrg.rglru_decode(_j(p), jnp.asarray(x).astype(dtype),
                                 jrg.RGLRUState(jnp.asarray(h), jnp.asarray(
                                     conv).astype(dtype)), JR, JCTX, dtype)
    got, tst = trg.rglru_decode(_t(p), torch.from_numpy(x).to(getattr(
        torch, dtype)), trg.RGLRUState(torch.from_numpy(h), torch.from_numpy(
            conv).to(getattr(torch, dtype))), R, CTX, dtype)
    close(got, want, tol, "out")
    close(tst.h, jst.h, tol, "h")
    assert tst.h.dtype == torch.float32
    assert np.array_equal(tst.conv.float().numpy(),
                          np.asarray(jst.conv.astype(jnp.float32)))


def test_rglru_train_gradient_matches_jax():
    """∂ Σ out·R for every param and the input, fp32, S = 17: each within
    2e-5 of its largest |∂| (``jax.grad``; its scan runs eagerly inside
    the transposition, ours through autograd)."""
    p, x = _params(11), _x(2, 17, 12)
    Rm = np.random.default_rng(13).normal(size=(2, 17, D)).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(jrg.rglru_train(pp, xx, JR, JCTX, "float32") * Rm)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (trg.rglru_train(tp, tx, R, CTX, "float32") * torch.from_numpy(Rm)).sum(
    ).backward()
    close(tx.grad, jgx, 2e-5, "x")
    for k in tp:
        close(tp[k].grad, jgp[k], 2e-5, k)


def test_rglru_train_matches_stepwise_decode():
    """The port's scan against its own decode, one step at a time from a
    zero state, fp32: within 1e-6 of the largest |out| (the reference's own
    check holds 1e-4 absolute)."""
    p, x = _t(_params(14)), torch.from_numpy(_x(2, 10, 15))
    full = trg.rglru_train(p, x, R, CTX, "float32")
    st = trg.RGLRUState(h=torch.zeros(2, W), conv=torch.zeros(2, 3, W))
    outs = []
    for t in range(10):
        o, st = trg.rglru_decode(p, x[:, t:t + 1], st, R, CTX, "float32")
        outs.append(o[:, 0])
    close(torch.stack(outs, 1), full.numpy(), 1e-6)
