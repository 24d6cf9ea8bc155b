"""The dense compressed uplink against the JAX package: the ``sign_ef`` and
``topk_ef`` twins against the Pallas kernels (interpret mode) and the
compressors they stand for; ``ef_compress``/``ef_compress_masked`` against
``repro.core.error_feedback``; and the sign/int8/identity compressors.

Tolerances: top-k, int8 and identity are held bitwise. The sign scale
``‖x+e‖₁/d`` is summed in a fixed halving-tree order on the port's side;
``jnp.mean``'s order on XLA:CPU and the order of the Pallas partials are not
specified, so the scale is held within ``SIGN_ULP`` ulp, the signs equal,
and ``err = tot − hat`` exactly given the port's own scale. The CUDA
kernels are held to these twins bitwise on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_feedback as jef
from repro.core.compressors import make_compressor as jax_make
from repro.kernels.ops import KernelImpl
from repro.kernels.sign_ef import sign_ef as pallas_sign_ef
from repro.kernels.topk_ef import topk_ef as pallas_topk_ef
from repro_torch.core import error_feedback as tef
from repro_torch.core.compressors import make_compressor
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

#: the sign scale's bound against the JAX reference, in ulp of the scale:
#: two fp32 sums of up to ~10^4 terms in unspecified orders
SIGN_ULP = 4


def _inputs(seed, c, d, ties=False):
    r = np.random.default_rng(seed)
    if ties:
        x = (r.integers(-2, 3, size=(c, d)) * 0.5).astype(np.float32)
        x[:, ::7] = 0.0
        x[:, 3::11] = -0.0
        return x, np.zeros((c, d), np.float32)
    return (r.normal(size=(c, d)).astype(np.float32),
            (r.normal(size=(c, d)) * 0.3).astype(np.float32))


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / float(np.spacing(max(abs(a), abs(b))))


def _check_sign(tot, hat, err, jax_hat):
    """``hat``/``err``: the port's (d,) outputs for totals ``tot``;
    ``jax_hat``: the reference's hat for the same totals."""
    scale = np.abs(hat).max()
    assert np.all(np.abs(hat) == scale)
    jscale = np.abs(jax_hat).max()
    assert _ulps(scale, jscale) <= SIGN_ULP, (scale, jscale)
    np.testing.assert_array_equal(np.sign(hat), np.sign(jax_hat))
    np.testing.assert_array_equal(err, tot - hat)


# -- sign_ef --------------------------------------------------------------------


@pytest.mark.parametrize("d", [8192, 6922, 100, 2049])
@pytest.mark.parametrize("ties", [False, True])
def test_sign_ef_twin_vs_pallas_and_make_sign(d, ties):
    """Two clients on rows of a larger EF buffer, at d % 2048 == 0 and at
    ragged d (where the Pallas route pads and rescales): the scale within
    SIGN_ULP ulp of the Pallas kernel's and of ``make_sign``'s through
    ``ef_compress``; signs equal (sign(0) = sign(-0.0) = +1)."""
    x, e = _inputs(d + ties, 2, d, ties)
    rows = torch.tensor([3, 1])
    errs = np.zeros((4, d), np.float32)
    errs[[3, 1]] = e
    buf = torch.from_numpy(errs.copy())
    hat = ops.sign_ef(torch.from_numpy(x), buf, rows).numpy()
    kimpl = KernelImpl(interpret=True)
    jcomp = jax_make("sign")
    for i in range(2):
        tot = x[i] + e[i]
        if d % 2048 == 0:
            ph, pe = pallas_sign_ef(jnp.asarray(x[i]), jnp.asarray(e[i]))
        else:
            ph, pe = kimpl.ef_compress_leaf("sign", 1.0, jnp.asarray(x[i]),
                                            jnp.asarray(e[i]))
        jh, je = jef.ef_compress(jcomp, jnp.asarray(x[i]), jnp.asarray(e[i]))
        for want in (ph, jh):
            _check_sign(tot, hat[i], buf[rows[i]].numpy(), np.asarray(want))
    assert not buf[[0, 2]].any()      # other rows untouched


def test_sign_ef_twin_equals_make_sign_compress_and_nan():
    """In the port, ``sign_ef``'s hat is ``make_sign().compress`` of the
    totals bitwise (one scale definition); a NaN total makes that client's
    whole hat NaN, as ``jnp.mean`` does in the reference."""
    x, e = _inputs(5, 3, 5000)
    x[1, 17] = np.nan
    buf = torch.from_numpy(e.copy())
    hat = ops.sign_ef(torch.from_numpy(x), buf, torch.arange(3))
    comp = make_compressor("sign")
    tot = torch.from_numpy(x + e)
    for i in (0, 2):
        assert torch.equal(hat[i], comp.compress(tot[i]))
    assert hat[1].isnan().all() and not hat[[0, 2]].isnan().any()
    jh = np.asarray(jax_make("sign").compress(jnp.asarray(x[1] + e[1])))
    assert np.isnan(jh).all()


def test_sign_scale_chunks_its_partials_tree_past_sign_chunk(monkeypatch):
    """Past ``SIGN_CHUNK`` partials per client (d > 2**24 at the kernel's
    8192) the scale's second tree runs per chunk and the chunk sums add in
    chunk order. Shown here at a chunk of 4 partials on 10 (three chunks,
    the last padded); at a chunk no narrower than nb nothing changes."""
    d = 2048 * 9 + 5
    tot = torch.from_numpy(_inputs(9, 2, d)[0])
    whole = ref.sign_scale(tot)
    monkeypatch.setattr(ref, "SIGN_CHUNK", 16)
    assert torch.equal(ref.sign_scale(tot), whole)
    monkeypatch.setattr(ref, "SIGN_CHUNK", 4)
    got = ref.sign_scale(tot)
    a = torch.nn.functional.pad(tot.abs(), (0, 10 * 2048 - d))
    parts = ref.tree_sum(a.view(2, 10, 2048))
    chunks = [ref.tree_sum(parts[:, i:i + 4]) for i in (0, 4, 8)]
    want = ref.div_rn((chunks[0] + chunks[1]) + chunks[2], float(d))
    assert torch.equal(got, want)
    exact = np.abs(tot.numpy().astype(np.float64)).sum(axis=1) / d
    for g, w in zip(got.numpy(), exact):
        assert _ulps(g, np.float32(w)) <= SIGN_ULP, (g, w)


# -- topk_ef -------------------------------------------------------------------


@pytest.mark.parametrize("n,block,k,ties", [
    (4096, 2048, 32, False), (4096, 2048, 1, False), (4096, 2048, 1024, True),
    (4096, 2048, 2048, False), (1024, 256, 32, True), (768, 384, 1, True)])
def test_topk_ef_twin_matches_pallas_bitwise(n, block, k, ties):
    x, e = _inputs(n + k, 1, n, ties)
    ph, pe = pallas_topk_ef(jnp.asarray(x[0]), jnp.asarray(e[0]), k=k,
                            block=block)
    buf = torch.from_numpy(e.copy())
    hat = ops.topk_ef(torch.from_numpy(x), buf, torch.tensor([0]), k=k,
                      block=block)
    np.testing.assert_array_equal(np.asarray(ph), hat[0].numpy())
    np.testing.assert_array_equal(np.asarray(pe), buf[0].numpy())
    assert int((hat != 0).sum()) <= k * (n // block)


@pytest.mark.parametrize("d,ratio,block", [(6922, 1 / 64, 2048),
                                           (1000, 2 / 256, 256),
                                           (300, 1 / 384, 2048),
                                           (2500, 1 / 2, 512)])
def test_topk_ef_twin_matches_blocktopk_and_kernel_route_on_ragged_d(
        d, ratio, block):
    """A ragged last block (zero-filled, so padded positions compete as
    zeros and are dropped): bitwise the JAX ``make_blocktopk`` through
    ``ef_compress`` and the Pallas route ``KernelImpl.ef_compress_leaf``,
    for three clients on rows of the EF buffer."""
    x, e = _inputs(d, 3, d)
    rows = torch.tensor([2, 0, 4])
    errs = np.zeros((5, d), np.float32)
    errs[[2, 0, 4]] = e
    buf = torch.from_numpy(errs)
    comp = make_compressor("blocktopk", ratio, block)
    hat = tef.ef_compress_rows(comp, torch.from_numpy(x), buf, rows)
    jcomp = jax_make("blocktopk", ratio, block)
    kimpl = KernelImpl(block=block, interpret=True)
    for i in range(3):
        jh, je = jef.ef_compress(jcomp, jnp.asarray(x[i]), jnp.asarray(e[i]))
        np.testing.assert_array_equal(np.asarray(jh), hat[i].numpy())
        np.testing.assert_array_equal(np.asarray(je), buf[rows[i]].numpy())
        kh, ke = kimpl.ef_compress_leaf("blocktopk", ratio,
                                        jnp.asarray(x[i]), jnp.asarray(e[i]))
        np.testing.assert_array_equal(np.asarray(kh), hat[i].numpy())
        np.testing.assert_array_equal(np.asarray(ke), buf[rows[i]].numpy())


@pytest.mark.parametrize("kernel", ["topk_ef", "sign_ef"])
def test_dense_ef_twins_reject_bad_rows(kernel):
    err = torch.zeros(4, 256)
    fn = (lambda r: ops.topk_ef(torch.ones(len(r), 256), err, r, k=4,
                                block=128)) if kernel == "topk_ef" else (
        lambda r: ops.sign_ef(torch.ones(len(r), 256), err, r))
    for rows, match in (([0, 4], r"\[0, 4\)"), ([2, 2], "distinct")):
        with pytest.raises(ValueError, match=f"{kernel}: rows.*{match}"):
            fn(torch.tensor(rows))
    assert not err.any()


# -- ef_compress / ef_compress_masked -----------------------------------------


COMPRESSORS = [("blocktopk", 1 / 64, 2048), ("topk", 1 / 64, 2048),
               ("int8", 1 / 64, 2048), ("none", 1 / 64, 2048),
               ("sign", 1 / 64, 2048), ("packedsign", 1 / 64, 2048)]


@pytest.mark.parametrize("name,ratio,block", COMPRESSORS)
def test_ef_compress_and_masked_match_jax(name, ratio, block):
    """(c, d) EF compression and its masked form against the JAX functions
    per client row: bitwise, except the sign scale (SIGN_ULP)."""
    c, d = 3, 5000
    x, e = _inputs(7, c, d)
    comp = make_compressor(name, ratio, block)
    jcomp = jax_make(name, ratio, block)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    hat, new_err = tef.ef_compress(comp, tx, te)
    assert torch.equal(te, torch.from_numpy(e))        # input untouched
    part = np.array([1, 0, 1])
    mhat, merr = tef.ef_compress_masked(comp, tx, te, torch.from_numpy(part))
    for i in range(c):
        jh, je = jef.ef_compress(jcomp, jnp.asarray(x[i]), jnp.asarray(e[i]))
        mh, me = jef.ef_compress_masked(jcomp, jnp.asarray(x[i]),
                                        jnp.asarray(e[i]), part[i])
        if name in ("sign", "packedsign"):
            _check_sign(x[i] + e[i], hat[i].numpy(), new_err[i].numpy(),
                        np.asarray(jh))
        else:
            np.testing.assert_array_equal(np.asarray(jh), hat[i].numpy())
            np.testing.assert_array_equal(np.asarray(je), new_err[i].numpy())
            np.testing.assert_array_equal(np.asarray(mh), mhat[i].numpy())
            np.testing.assert_array_equal(np.asarray(me), merr[i].numpy())
    assert not mhat[1].any() and torch.equal(merr[1], te[1])
    assert torch.equal(mhat[[0, 2]], hat[[0, 2]])
    h1, e1 = tef.ef_compress(comp, tx[0], te[0])        # a single (d,) row
    assert h1.shape == (d,) and torch.equal(h1, hat[0])
    assert torch.equal(e1, new_err[0])


def test_ef_compress_telescopes():
    """Σ_t Δ̂_t = Σ_t Δ_t + e_1 − e_{T+1} (sign, 5 steps), exactly up to
    the fp32 sums' rounding."""
    comp = make_compressor("sign")
    r = np.random.default_rng(0)
    err = torch.zeros(1, 700)
    s_hat = torch.zeros(1, 700, dtype=torch.float64)
    s_delta = torch.zeros(1, 700, dtype=torch.float64)
    for _ in range(5):
        delta = torch.from_numpy(r.normal(size=(1, 700)).astype(np.float32))
        hat, err = tef.ef_compress(comp, delta, err)
        s_hat += hat.double()
        s_delta += delta.double()
    np.testing.assert_allclose(s_hat.numpy(), (s_delta - err.double()).numpy(),
                               atol=1e-5)


# -- compressors ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sign", "packedsign", "int8", "none"])
@pytest.mark.parametrize("kind", ["normal", "zeros", "ties"])
@pytest.mark.parametrize("d", [1, 37, 6922])
def test_dense_compressors_match_jax(name, kind, d):
    r = np.random.default_rng(d)
    x = {"normal": r.normal(size=d) * 0.3,
         "zeros": np.zeros(d),
         "ties": r.integers(-2, 3, size=d) * 0.25}[kind].astype(np.float32)
    if kind == "zeros" and d > 1:
        x[::2] = -0.0
    comp, jcomp = make_compressor(name), jax_make(name)
    assert comp.name == jcomp.name and comp.select is None
    assert comp.bits_per_message(d) == jcomp.bits_per_message(d)
    got = comp.compress(torch.from_numpy(x)).numpy()
    want = np.asarray(jcomp.compress(jnp.asarray(x)))
    if name in ("sign", "packedsign"):
        assert np.all(np.abs(got) == np.abs(got).max())
        assert _ulps(np.abs(got).max(), np.abs(want).max()) <= SIGN_ULP
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        if kind != "zeros":
            np.testing.assert_allclose(comp.q_bound(x), jcomp.q_bound(x),
                                       rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        assert comp.q_bound(x) == jcomp.q_bound(x)


def test_int8_scale_is_the_eager_division():
    """Reference-side (ROADMAP Queue 3): jitted on XLA:CPU, ``make_int8``'s
    ``max|x| / 127.0`` becomes ``max|x| * fl(1/127)``, one ulp off the
    eager function on some inputs, and every quantized value follows the
    scale. The port computes the eager function's true division, bitwise;
    on such an input the jitted program differs."""
    r = np.random.default_rng(0)
    jcomp, comp = jax_make("int8"), make_compressor("int8")
    found = 0
    for i in range(200):
        x = (r.normal(size=64) * r.uniform(1e-3, 1)).astype(np.float32)
        got = comp.compress(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jcomp.compress(jnp.asarray(x))))
        amax = np.abs(x).max()
        if amax / np.float32(127.0) != amax * (np.float32(1) / np.float32(127)):
            jitted = np.asarray(jax.jit(jcomp.compress)(jnp.asarray(x)))
            assert not np.array_equal(jitted, got)
            found += 1
    assert found > 0
