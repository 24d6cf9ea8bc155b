"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against
``repro.models.xlstm``, on the CPU at smoke size.

Params and inputs are drawn with numpy from a seed (biases too, so they
matter). Each tolerance is stated where it is set.

* The defs (shapes, scales, inits, per-dim specs).
* ``log_sigmoid`` against ``jax.nn.log_sigmoid`` at |x| up to 100.
* ``mlstm_train`` (quadratic, q-chunked) with and without its final
  state, ``mlstm_train_chunkwise`` at chunks 4, 8 and 16, ``mlstm_decode``,
  ``slstm_train`` with its state and ``slstm_decode``, in fp32 and bf16;
  the gradients against ``jax.grad``.
* The port against itself, as ``tests/test_recurrent_refs.py`` holds the
  reference: the chunkwise form equals the quadratic one
  (``test_mlstm_chunkwise_equals_quadratic``), the quadratic form equals
  the stepwise decode (``test_mlstm_train_matches_stepwise_decode``), and
  the sLSTM's forward equals its decode.
* The refusal of a length the chunks do not tile, in both forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import XLSTMConfig as JaxX
from repro.models import xlstm as jx
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import xlstm as tx
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.sharding.rules import ParallelContext

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
D, NH = 64, 4
X, JXC = XLSTMConfig(), JaxX()


def _draw(defs, seed):
    r = np.random.default_rng(seed)
    return tree_map(lambda d: (r.normal(size=d.shape) * (
        d.scale if d.init == "normal" else 0.3)).astype(np.float32), defs)


def _t(p):
    return tree_map(lambda a: torch.from_numpy(a.copy()), p)


def _j(p):
    return tree_map(jnp.asarray, p)


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max|want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, dtype=np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def mparams(seed):
    return _draw(tx.mlstm_defs(D, NH, X), seed)


def sparams(seed):
    return _draw(tx.slstm_defs(D, NH, X), seed)


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_defs_equal_the_reference(which):
    jd = dict(leaves_with_paths(jax.tree.map(
        lambda d: d, getattr(jx, f"{which}_defs")(D, NH, JXC),
        is_leaf=lambda d: hasattr(d, "spec"))))
    td = dict(leaves_with_paths(getattr(tx, f"{which}_defs")(D, NH, X)))
    assert sorted(jd) == sorted(td)
    for k, d in td.items():
        j = jd[k]
        assert (d.shape, d.init, d.scale, d.dtype) == (
            tuple(j.shape), j.init, j.scale, j.dtype), k
        assert d.dim_specs == tuple(j.spec) + (None,) * (
            len(d.shape) - len(j.spec)), k


def test_log_sigmoid_matches_jax_at_large_magnitudes():
    """``-logaddexp(-x, 0)`` is ``jax.nn.log_sigmoid``'s form: within
    2^-22 of it (2 ulps of a value near 1; the libraries' log1p/exp differ
    in the last bit) and within 2^-22 relative where |value| > 1, over
    [-100, 100]: no overflow to -inf at -100 and -100 exactly there, and
    values below 1e-38 far right (XLA:CPU flushes those to zero, PyTorch
    keeps them: an absolute difference below 1e-38)."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [-100.0, -88.0, -30.0, 30.0, 88.0, 100.0]]).astype(
        np.float32)
    got = tx.log_sigmoid(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2.0 ** -22 * np.maximum(np.abs(want),
                                                          1.0)).all()
    assert got[-6] == want[-6] == np.float32(-100)
    assert want[-1] == 0.0 and -1e-38 < got[-1] < 0.0


#: (compute dtype, tolerance, state tolerance). fp32: 2e-5 of the largest
#: |value| (the two libraries' reduction orders over S and the head dim,
#: and their exp/log ulps). bf16: the projections, the scores and the PV
#: products run in bf16 on both sides, and a one-ulp difference in a bf16
#: score or in F moves an output by a bf16 ulp (2^-8): 3e-2 (measured
#: below 1.6e-2); the fp32 state (k·v sums of bf16 values) 1e-2.
DTYPES = [("float32", 2e-5, 2e-5), ("bfloat16", 3e-2, 1e-2)]


def _in(x, dtype):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype,tol,stol", DTYPES)
@pytest.mark.parametrize("S,chunk", [(24, 2048), (24, 8), (40, 16)])
def test_mlstm_train_matches_jax(dtype, tol, stol, S, chunk):
    """The quadratic form, unchunked and in 3 or 2 q-chunks, with and
    without its final (C, n, m) state."""
    p, (xj, xt) = mparams(1), _in(_x(2, S, 2), dtype)
    want = jx.mlstm_train(_j(p), xj, NH, JCTX, dtype, chunk=chunk)
    got = tx.mlstm_train(_t(p), xt, NH, CTX, dtype, chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, tol, "out")
    want, jst = jx.mlstm_train(_j(p), xj, NH, JCTX, dtype, chunk=chunk,
                               return_state=True)
    got, tst = tx.mlstm_train(_t(p), xt, NH, CTX, dtype, chunk=chunk,
                              return_state=True)
    close(got, want, tol, "out with state")
    for f in ("C", "n", "m"):
        assert getattr(tst, f).dtype == torch.float32
        close(getattr(tst, f), getattr(jst, f), stol, f)


@pytest.mark.parametrize("dtype,tol,stol", DTYPES)
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_train_chunkwise_matches_jax(dtype, tol, stol, chunk):
    p, (xj, xt) = mparams(3), _in(_x(2, 32, 4), dtype)
    want, jst = jx.mlstm_train_chunkwise(_j(p), xj, NH, JCTX, dtype,
                                         chunk=chunk, return_state=True)
    got, tst = tx.mlstm_train_chunkwise(_t(p), xt, NH, CTX, dtype,
                                        chunk=chunk, return_state=True)
    close(got, want, tol, "out")
    for f in ("C", "n", "m"):
        close(getattr(tst, f), getattr(jst, f), stol, f)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunkwise_equals_quadratic(chunk):
    """``test_recurrent_refs.py::test_mlstm_chunkwise_equals_quadratic`` on
    the port: the two forms, fp32, within 1e-5 of the largest |out| (the
    reference holds 1e-4 absolute), and their final states within 1e-5."""
    p, x = _t(mparams(5)), torch.from_numpy(_x(2, 48, 6))
    quad, qst = tx.mlstm_train(p, x, NH, CTX, "float32", return_state=True)
    cw, cst = tx.mlstm_train_chunkwise(p, x, NH, CTX, "float32",
                                       chunk=chunk, return_state=True)
    close(cw, quad.numpy(), 1e-5, "out")
    for f in ("C", "n", "m"):
        close(getattr(cst, f), getattr(qst, f).numpy(), 1e-5, f)


@pytest.mark.parametrize("dtype,tol,stol", DTYPES)
def test_mlstm_decode_matches_jax(dtype, tol, stol):
    r = np.random.default_rng(7)
    p, (xj, xt) = mparams(8), _in(_x(2, 1, 9), dtype)
    dh = tx.mlstm_defs(D, NH, X)["w_q"].shape[1] // NH
    st = (r.normal(size=(2, NH, dh, dh)).astype(np.float32),
          r.normal(size=(2, NH, dh)).astype(np.float32),
          r.normal(size=(2, NH)).astype(np.float32))
    want, jst = jx.mlstm_decode(_j(p), xj, jx.MLSTMState(
        *map(jnp.asarray, st)), NH, JCTX, dtype)
    got, tst = tx.mlstm_decode(_t(p), xt, tx.MLSTMState(
        *map(torch.from_numpy, st)), NH, CTX, dtype)
    close(got, want, tol, "out")
    for f in ("C", "n", "m"):
        close(getattr(tst, f), getattr(jst, f), stol, f)


def test_mlstm_train_matches_stepwise_decode():
    """``test_recurrent_refs.py::test_mlstm_train_matches_stepwise_decode``
    on the port: the quadratic form against its own decode stepped from
    the zero state (m at -1e30), fp32, within 1e-5 of the largest |out|;
    the final state of the forward is the decode's."""
    p, x = _t(mparams(10)), torch.from_numpy(_x(2, 12, 11))
    full, fst = tx.mlstm_train(p, x, NH, CTX, "float32", return_state=True)
    dh = p["w_q"].shape[1] // NH
    st = tx.MLSTMState(C=torch.zeros(2, NH, dh, dh), n=torch.zeros(2, NH, dh),
                       m=torch.full((2, NH), -1e30))
    outs = []
    for i in range(12):
        o, st = tx.mlstm_decode(p, x[:, i:i + 1], st, NH, CTX, "float32")
        outs.append(o[:, 0])
    close(torch.stack(outs, 1), full.numpy(), 1e-5, "out")
    # the stabilisers differ (the forward's m is the row max, the decode's
    # the running one): compare C/exp(-m) and n/exp(-m), i.e. unstabilised
    for f in ("C", "n"):
        a = getattr(st, f) * torch.exp(st.m).reshape(2, NH, *(
            [1] * (getattr(st, f).dim() - 2)))
        b = getattr(fst, f) * torch.exp(fst.m).reshape(2, NH, *(
            [1] * (getattr(fst, f).dim() - 2)))
        close(a, b.numpy(), 1e-5, f)


@pytest.mark.parametrize("dtype,tol,stol", DTYPES)
def test_slstm_train_and_its_state_match_jax(dtype, tol, stol):
    p, (xj, xt) = sparams(12), _in(_x(2, 20, 13), dtype)
    want, jst = jx.slstm_train(_j(p), xj, NH, JCTX, dtype, return_state=True)
    got, tst = tx.slstm_train(_t(p), xt, NH, CTX, dtype, return_state=True)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, tol, "out")
    for f in ("h", "c", "n", "m"):
        assert getattr(tst, f).dtype == torch.float32
        close(getattr(tst, f), getattr(jst, f), stol, f)


@pytest.mark.parametrize("dtype,tol,stol", DTYPES)
def test_slstm_decode_matches_jax(dtype, tol, stol):
    r = np.random.default_rng(14)
    p, (xj, xt) = sparams(15), _in(_x(2, 1, 16), dtype)
    st = [r.normal(size=(2, D)).astype(np.float32) for _ in range(3)]
    st.append(r.normal(size=(2, D)).astype(np.float32) - 1.0)
    st[2] = np.abs(st[2]) + 0.5          # n > 0, as a running sum is
    want, jst = jx.slstm_decode(_j(p), xj, jx.SLSTMState(
        *map(jnp.asarray, st)), NH, JCTX, dtype)
    got, tst = tx.slstm_decode(_t(p), xt, tx.SLSTMState(
        *map(torch.from_numpy, st)), NH, CTX, dtype)
    close(got, want, tol, "out")
    for f in ("h", "c", "n", "m"):
        close(getattr(tst, f), getattr(jst, f), stol, f)


def test_slstm_train_matches_stepwise_decode():
    """The sLSTM's sequential forward against its own decode from the
    zero state (m at -1e30): the same steps, so bitwise, fp32."""
    p, x = _t(sparams(17)), torch.from_numpy(_x(2, 9, 18))
    full, fst = tx.slstm_train(p, x, NH, CTX, "float32", return_state=True)
    z = torch.zeros(2, D)
    st = tx.SLSTMState(z, z, z, torch.full((2, D), -1e30))
    outs = []
    for i in range(9):
        o, st = tx.slstm_decode(p, x[:, i:i + 1], st, NH, CTX, "float32")
        outs.append(o[:, 0])
    assert torch.equal(torch.stack(outs, 1), full)
    assert all(torch.equal(a, b) for a, b in zip(st, fst))


@pytest.mark.parametrize("which", ["mlstm", "mlstm_chunkwise", "slstm"])
def test_gradient_matches_jax(which):
    """∂ Σ out·R for every param and the input, fp32: each within 5e-5 of
    its largest |∂| (``jax.grad`` through ``lax.scan`` against autograd
    through the port's loops)."""
    S = 16
    p = sparams(19) if which == "slstm" else mparams(19)
    x = _x(2, S, 20)
    Rm = np.random.default_rng(21).normal(size=(2, S, D)).astype(np.float32)
    fj = {"mlstm": lambda pp, xx: jx.mlstm_train(pp, xx, NH, JCTX, "float32",
                                                 chunk=8),
          "mlstm_chunkwise": lambda pp, xx: jx.mlstm_train_chunkwise(
              pp, xx, NH, JCTX, "float32", chunk=4),
          "slstm": lambda pp, xx: jx.slstm_train(pp, xx, NH, JCTX,
                                                 "float32")}[which]
    ft = {"mlstm": lambda pp, xx: tx.mlstm_train(pp, xx, NH, CTX, "float32",
                                                 chunk=8),
          "mlstm_chunkwise": lambda pp, xx: tx.mlstm_train_chunkwise(
              pp, xx, NH, CTX, "float32", chunk=4),
          "slstm": lambda pp, xx: tx.slstm_train(pp, xx, NH, CTX,
                                                 "float32")}[which]
    jgp, jgx = jax.grad(lambda pp, xx: jnp.sum(fj(pp, xx) * Rm),
                        argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(True), _t(p))
    txx = torch.from_numpy(x).requires_grad_(True)
    (ft(tp, txx) * torch.from_numpy(Rm)).sum().backward()
    close(txx.grad, jgx, 5e-5, "x")
    jg = dict(leaves_with_paths(jax.device_get(jgp)))
    for path, leaf in leaves_with_paths(tp):
        close(leaf.grad, jg[path], 5e-5, path)


def test_a_length_the_chunks_do_not_tile_is_refused():
    """The reference's reshape refuses 2 q-chunks of 12 for S = 25 at
    chunk 12, and its chunkwise form asserts S % chunk == 0; the port
    raises ValueError for both, and runs what tiles."""
    p = mparams(22)
    x = _x(1, 25, 23)
    with pytest.raises(TypeError):
        jx.mlstm_train(_j(p), jnp.asarray(x), NH, JCTX, "float32", chunk=12)
    with pytest.raises(ValueError, match="not 2 chunks of 12"):
        tx.mlstm_train(_t(p), torch.from_numpy(x), NH, CTX, "float32",
                       chunk=12)
    with pytest.raises(AssertionError):
        jx.mlstm_train_chunkwise(_j(p), jnp.asarray(x), NH, JCTX, "float32",
                                 chunk=8)
    with pytest.raises(ValueError, match="not a multiple of chunk=8"):
        tx.mlstm_train_chunkwise(_t(p), torch.from_numpy(x), NH, CTX,
                                 "float32", chunk=8)
    assert tx.mlstm_train(_t(p), torch.from_numpy(x), NH, CTX, "float32",
                          chunk=13).shape == (1, 25, D)


def test_an_overflowing_normalizer_gives_the_reference_nan_gradients():
    """The mLSTM's normalizer ``max(|η|, exp(-m))``: with input gates near
    -3000, ``exp(-m)`` overflows. The forward stays finite (h = 0), and the
    backward multiplies 0 by inf: the input- and forget-gate weights'
    gradients are NaN in the reference and in the port alike, the rest
    finite (ROADMAP Queue 3 item 27: fedcams on the full-depth model
    reaches it after one local step)."""
    p = mparams(24)
    p["w_i"] = p["w_i"] * np.float32(3000.0)
    x = _x(2, 16, 25)
    jg = jax.grad(lambda pp: jnp.sum(jx.mlstm_train(
        pp, jnp.asarray(x), NH, JCTX, "float32", chunk=8)))(_j(p))
    tp = tree_map(lambda a: a.requires_grad_(True), _t(p))
    out = tx.mlstm_train(tp, torch.from_numpy(x), NH, CTX, "float32", chunk=8)
    assert bool(torch.isfinite(out).all())
    out.sum().backward()
    want = {k: bool(np.isfinite(np.asarray(v)).all()) for k, v in jg.items()}
    got = {k: bool(torch.isfinite(v.grad).all()) for k, v in tp.items()}
    assert got == want
    assert not got["w_i"] and not got["w_f"] and got["w_q"] and got["w_v"]
