"""The port's batched wire codecs and rows bitpack twins against
``repro.comm.wire`` and ``repro.kernels.bitpack``.

* ``encode_rows`` of every codec FedSim builds, on a (c, d) block, against
  the JAX codec's ``encode`` under ``jax.vmap``, with both of its packing
  routes (``pack_impl="jnp"`` and ``"pallas"``, the Pallas kernels in
  interpret mode): bytes equal everywhere but the sign codec's scale bytes
  (within ``SIGN_ULP`` ulp, as tests/test_torch_wire.py allows); row r is
  ``encode(tot[r])`` byte for byte; ``decode_rows`` is the JAX decode of
  each row (stacked, and under ``vmap``) bit for bit.
* The fused sign forms of the rows twins (the ``>= 0`` predicate packed
  from fp32 totals; the scale times ±1 unpacked) against their unfused
  compositions and the JAX codec, on -0.0, NaN, ±inf and denormal totals
  and on NaN, inf and ±0 scales.
* The rows twins against per-row ``ref.pack_uint`` / ``ref.unpack_uint``
  and ``pack_uint_words`` for n = 1..32, written at a column offset of a
  wider block whose other bytes stay as they were.

The CUDA rows kernels are held to these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as jw
from repro.kernels import bitpack as jbp
from repro_torch.comm import wire as tw
from repro_torch.kernels import ops, ref
from test_torch_dense_uplink import SIGN_ULP, _ulps

torch.set_num_threads(1)

C = 3


def _pack_kw(m, impl):
    """The JAX codec's packing route; the port's codecs have one."""
    return {"pack_impl": impl} if m is jw else {}


#: name → (make(module, impl), JAX pack routes, scales per message or None)
CODECS = {
    "dense32": (lambda m, i: m.make_dense32_codec(), ("jnp",), None),
    "topk-f32": (lambda m, i: m.make_topk_codec(1 / 8), ("jnp",), None),
    "topk-bf16": (lambda m, i: m.make_topk_codec(1 / 8, "bfloat16"),
                  ("jnp",), None),
    "blocktopk-f32": (lambda m, i: m.make_blocktopk_codec(
        1 / 64, **_pack_kw(m, i)), ("jnp", "pallas"), None),
    "blocktopk-f16": (lambda m, i: m.make_blocktopk_codec(
        1 / 8, 256, "float16", **_pack_kw(m, i)), ("jnp", "pallas"), None),
    "blocktopk-bf16": (lambda m, i: m.make_blocktopk_codec(
        1 / 8, 256, "bfloat16", **_pack_kw(m, i)), ("jnp", "pallas"), None),
    "blocktopk-int8": (lambda m, i: m.make_blocktopk_codec(
        1 / 8, 256, "int8", **_pack_kw(m, i)), ("jnp", "pallas"), None),
    "sign": (lambda m, i: m.make_sign_codec(**_pack_kw(m, i)),
             ("jnp", "pallas"), lambda d: 1),
    "sign-block": (lambda m, i: m.make_sign_codec(300, **_pack_kw(m, i)),
                   ("jnp", "pallas"), lambda d: -(-d // 300)),
}
CASES = [(name, impl) for name, (_, impls, _) in CODECS.items()
         for impl in impls]


def _block(d, seed=0):
    """(C, d) fp32 totals from a numpy seed: normal values; ties with -0.0
    and +0.0; normal values with exact zeros."""
    r = np.random.default_rng(seed + d)
    x = (r.normal(size=(C, d)) * 0.1).astype(np.float32)
    x[1] = (r.integers(-2, 3, size=d) * 0.5).astype(np.float32)
    x[1, ::5] = -0.0
    x[2, ::7] = 0.0
    return x


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("d", [37, 2053])
@pytest.mark.parametrize("name,impl", CASES)
def test_encode_rows_and_decode_rows_match_jax_vmap(name, impl, d):
    """d = 37 (one block of 128, d % 8 != 0) and d = 2053 (a ragged last
    block at either block size)."""
    make, _, n_scales = CODECS[name]
    jc, tc = make(jw, impl), make(tw, impl)
    x = _block(d)
    jbuf = np.asarray(jax.vmap(jc.encode)(jnp.asarray(x)))
    tbuf = tc.encode_rows(torch.from_numpy(x))
    assert tbuf.dtype == torch.uint8
    assert tuple(tbuf.shape) == (C, tc.nbytes(d)) == jbuf.shape
    t = tbuf.numpy()
    if n_scales:   # the sign scale(s): within SIGN_ULP, the rest equal
        s0, s1 = tw.HEADER_BYTES, tw.HEADER_BYTES + 4 * n_scales(d)
        for a, b in zip(t[:, s0:s1].reshape(-1).view(np.float32),
                        jbuf[:, s0:s1].reshape(-1).view(np.float32)):
            assert _ulps(a, b) <= SIGN_ULP, (a, b)
        np.testing.assert_array_equal(t[:, :s0], jbuf[:, :s0])
        np.testing.assert_array_equal(t[:, s1:], jbuf[:, s1:])
    else:
        np.testing.assert_array_equal(t, jbuf)
    for r in range(C):   # row r is the one-message encode of row r
        assert torch.equal(tbuf[r], tc.encode(torch.from_numpy(x[r])))
    # decode: the JAX decode of the port's bytes, stacked and under vmap
    jdec = np.stack([np.asarray(jc.decode(jnp.asarray(t[r]), d))
                     for r in range(C)])
    jdec_v = np.asarray(jax.vmap(lambda b: jc.decode(b, d))(jnp.asarray(t)))
    tdec = tc.decode_rows(tbuf, d)
    assert tdec.dtype == torch.float32 and tuple(tdec.shape) == (C, d)
    np.testing.assert_array_equal(_bits(tdec.numpy()), _bits(jdec))
    np.testing.assert_array_equal(_bits(jdec_v), _bits(jdec))
    for r in range(C):
        assert torch.equal(tc.decode(tbuf[r], d), tdec[r])
    if tc.exact:   # decode(encode(x)) is the compressor's output, row-wise
        for r in range(C):
            want = tc.compressor.compress(torch.from_numpy(x[r]))
            np.testing.assert_array_equal(_bits(tdec[r].numpy()),
                                          _bits(want.numpy()))


def _flush(t):
    """Denormals → zeros of the same sign: what XLA:CPU reads a denormal
    operand as (ROADMAP Queue 3 item 5), where the port keeps IEEE."""
    den = (t != 0) & (t.abs() < torch.finfo(torch.float32).tiny)
    return torch.where(den, torch.copysign(torch.zeros_like(t), t), t)


def test_blocktopk_int8_codec_is_the_eager_jax_codec():
    """ROADMAP Queue 3 item 6. The port's int8 blocktopk codec quantizes
    with true divisions, as the JAX ``_quantize`` does when it runs
    eagerly: on totals flushed of denormals (what XLA:CPU would read them
    as) the port's messages equal the eager JAX encode's byte for byte.
    Under ``jax.jit``, XLA:CPU turns the block scale's ``/ 127.0`` into a
    multiply by fl(1/127): the jitted scale is exactly that product, at
    most one ulp from the port's (14 of 360 blocks here), the offsets are
    the same and a quantized value moves by at most one step, and only in
    a block whose scale moved."""
    d, nb, kb, ib = 2048 * 8 + 37, 9, 32, 11
    r = np.random.default_rng(7)
    x = _flush(torch.from_numpy(
        (r.normal(size=(40, d)) * 0.1).astype(np.float32))).numpy()
    jc = jw.make_blocktopk_codec(1 / 64, 2048, "int8")
    tc = tw.make_blocktopk_codec(1 / 64, 2048, "int8")
    eager = np.stack([np.asarray(jc.encode(jnp.asarray(row))) for row in x])
    enc = jax.jit(jc.encode)
    jitted = np.stack([np.asarray(enc(jnp.asarray(row))) for row in x])
    port = tc.encode_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, eager)
    s0 = tw.HEADER_BYTES + (nb * kb * ib + 7) // 8
    s1 = s0 + 4 * nb
    np.testing.assert_array_equal(jitted[:, :s0], port[:, :s0])
    se = port[:, s0:s1].copy().view(np.float32)
    sj = jitted[:, s0:s1].copy().view(np.float32)
    amax = np.abs(np.pad(x, ((0, 0), (0, nb * 2048 - d)))).reshape(
        40, nb, 2048).max(axis=-1)
    amax = np.maximum(amax, np.float32(1e-30))
    np.testing.assert_array_equal(se, amax / np.float32(127))
    np.testing.assert_array_equal(sj, amax * np.float32(1 / 127))
    assert max(_ulps(a, b) for a, b in zip(se.ravel(), sj.ravel())) <= 1
    assert (se != sj).any()
    qe = port[:, s1:].view(np.int8).astype(int).reshape(40, nb, kb)
    qj = jitted[:, s1:].view(np.int8).astype(int).reshape(40, nb, kb)
    assert (np.abs(qe - qj) <= 1).all()
    assert (qe[se == sj] == qj[se == sj]).all()


def _special_totals(d, seed=0):
    """(4, d) fp32 totals: -0.0 and +0.0, NaNs of several payloads (sign
    bit set or not), ±inf, denormals of both signs, normal values."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(4, d)).astype(np.float32)
    bits = x.view(np.uint32)
    specials = np.array([0x80000000, 0x00000000, 0x7FC00000, 0xFFC00001,
                         0x7FFFFFFF, 0x7F800000, 0xFF800000, 0x00000001,
                         0x807FFFFF, 0x00400000, 0x80000001],
                        dtype=np.uint32)
    pick = r.random((4, d)) < 0.6
    bits[pick] = r.choice(specials, size=int(pick.sum()))
    return torch.from_numpy(x)


@pytest.mark.parametrize("d", [1, 8, 1001])
def test_fused_sign_pack_is_the_predicate_composition(d):
    """The fp32 form of the rows pack twin is ``pack_uint((x >= 0), 1)``
    row by row (-0.0 → 1, NaN → 0, not the sign bit) and ``np.packbits`` of
    the same predicate; on the totals with their denormals flushed it is
    the JAX sign codec's bit stream of the totals (XLA:CPU reads a
    negative denormal as -0.0, so ``>= 0`` holds for it there)."""
    x = _special_totals(d, seed=d)
    col = 20
    nbytes = (d + 7) // 8
    out = torch.full((4, col + nbytes + 3), 0xA5, dtype=torch.uint8)
    got = ops.pack_uint_rows(x, 1, out.clone(), col)     # the CPU dispatch
    assert torch.equal(got, ref.pack_uint_rows(x, 1, out.clone(), col))
    assert (got[:, :col] == 0xA5).all() and (got[:, col + nbytes:]
                                              == 0xA5).all()
    jcodec = jw.make_sign_codec()
    for r in range(4):
        row = got[r, col:col + nbytes]
        assert torch.equal(row, ref.pack_uint((x[r] >= 0).to(torch.uint8),
                                              1))
        np.testing.assert_array_equal(row.numpy(),
                                      np.packbits(x[r].numpy() >= 0))
        flushed = ref.pack_uint_rows(_flush(x[r:r + 1]), 1,
                                     out[:1].clone(), col)[0, col:]
        jbuf = np.asarray(jcodec.encode(jnp.asarray(x[r].numpy())))
        np.testing.assert_array_equal(flushed[:nbytes].numpy(), jbuf[col:])
    back = ref.unpack_uint_rows(got, col, 1, d, torch.uint8)
    v = x.view(torch.int32)
    assert (back[v == -2 ** 31] == 1).all()               # -0.0 → 1
    assert (back[x.isnan()] == 0).all()                    # NaN → 0


SCALES = np.array([0x7FC00000, 0xFFC00001, 0x7F800000, 0xFF800000,
                   0x00000000, 0x80000000, 0x00000003, 0x3E4CCCCD],
                  dtype=np.uint32)


def _sign_messages(d, nsc, seed):
    """(8, W) sign messages of length d with ``nsc`` scales each, drawn
    from SCALES (NaNs, ±inf, ±0, a denormal, 0.2), random bits."""
    r = np.random.default_rng(seed)
    nbytes = (d + 7) // 8
    buf = r.integers(0, 256, size=(8, 16 + 4 * nsc + nbytes), dtype=np.uint8)
    sc = np.stack([np.roll(SCALES, i)[np.arange(nsc) % len(SCALES)]
                   for i in range(8)])
    buf[:, 16:16 + 4 * nsc] = sc.view(np.uint8).reshape(8, 4 * nsc)
    return torch.from_numpy(buf)


@pytest.mark.parametrize("d,block", [(1001, 0), (9, 0), (1001, 300),
                                     (600, 300)])
def test_fused_sign_unpack_is_the_scaled_composition(d, block):
    """The fp32 form of the rows unpack twin is ``scale * (bits*2 - 1)``
    (``unpack_uint`` → ±1 → multiply) bitwise for every scale in SCALES,
    NaN, ±inf and ±0 included, and the JAX sign codec's decode (NaN where
    it has NaN; the port's output with its denormals flushed where the
    scale is a denormal, which XLA:CPU reads as 0)."""
    nsc = 1 if block == 0 else -(-d // block)
    buf = _sign_messages(d, nsc, seed=d + block)
    col = 16 + 4 * nsc
    got = ops.unpack_uint_rows(buf, col, 1, d, torch.float32,
                               scale_col=16, scale_block=block)
    assert torch.equal(got.view(torch.int32), ref.unpack_uint_rows(
        buf, col, 1, d, torch.float32, scale_col=16,
        scale_block=block).view(torch.int32))
    jcodec = jw.make_sign_codec(block)
    for r in range(8):
        bits = ref.unpack_uint(buf[r, col:], 1, d, torch.uint8)
        sgn = bits.float() * 2.0 - 1.0
        scales = buf[r, 16:col].clone().view(torch.float32)
        per = scales.repeat_interleave(block or d)[:d]
        want = per * sgn
        assert torch.equal(got[r].view(torch.int32), want.view(torch.int32))
        jdec = np.asarray(jcodec.decode(jnp.asarray(buf[r].numpy()), d))
        nan = np.isnan(jdec)
        np.testing.assert_array_equal(got[r].isnan().numpy(), nan)
        np.testing.assert_array_equal(_bits(_flush(got[r]).numpy())[~nan],
                                      _bits(jdec)[~nan])


@pytest.mark.parametrize("nbits", range(1, 33))
def test_rows_twins_match_per_row_pack_uint(nbits):
    """Each row packed as ``ref.pack_uint`` / ``pack_uint_words`` packs it,
    at a column offset of a wider block whose other bytes stay as they
    were; unpack is its inverse, row by row as ``ref.unpack_uint``."""
    count = 1000 + nbits             # never a whole number of groups
    r = np.random.default_rng(nbits)
    v = r.integers(0, 2 ** nbits, size=(C, count), dtype=np.uint64).astype(
        np.uint32)
    vals = torch.from_numpy(v.view(np.int32).copy())
    col = 5 + nbits % 7
    nbytes = (count * nbits + 7) // 8
    block = torch.from_numpy(r.integers(0, 256, size=(C, col + nbytes + 9),
                                        dtype=np.uint8))
    out = ops.pack_uint_rows(vals, nbits, block.clone(), col)
    assert torch.equal(out, ref.pack_uint_rows(vals, nbits, block.clone(),
                                               col))
    assert torch.equal(out[:, :col], block[:, :col])
    assert torch.equal(out[:, col + nbytes:], block[:, col + nbytes:])
    words = jax.vmap(lambda a: jbp.pack_uint_words(a, nbits))(jnp.asarray(v))
    np.testing.assert_array_equal(out[:, col:col + nbytes].numpy(),
                                  np.asarray(words))
    for i in range(C):
        assert torch.equal(out[i, col:col + nbytes],
                           ref.pack_uint(vals[i], nbits))
    back = ops.unpack_uint_rows(out, col, nbits, count)
    assert back.dtype == torch.int32 and tuple(back.shape) == (C, count)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), v)
    for i in range(C):
        assert torch.equal(back[i], ref.unpack_uint(
            out[i, col:col + nbytes], nbits, count))
    if nbits <= 8:   # uint8 values in and out
        u8 = vals.to(torch.uint8)
        assert torch.equal(ops.pack_uint_rows(u8, nbits, block.clone(), col),
                           out)
        assert torch.equal(ops.unpack_uint_rows(out, col, nbits, count,
                                                torch.uint8), u8)


def test_rows_kernel_wrappers_refuse_cpu_tensors_and_bad_arguments():
    """The rows kernel wrappers never run their twins; a CPU tensor is
    refused before anything is built or launched, and so are arguments
    the kernels do not take."""
    ops.reset_launches()
    vals = torch.zeros(2, 9)
    out = torch.zeros(2, 30, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.pack_uint_rows_cuda(vals, 1, out, 20)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.unpack_uint_rows_cuda(out, 20, 1, 9, torch.float32,
                                  scale_col=16)
    with pytest.raises(TypeError, match="uint8, int32 or float32"):
        ops.pack_uint_rows_cuda(vals.double(), 1, out, 20)
    with pytest.raises(ValueError, match="nbits=1"):
        ops.unpack_uint_rows_cuda(out, 20, 3, 9, torch.float32,
                                  scale_col=16)
    with pytest.raises(TypeError, match="cannot hold"):
        ops.unpack_uint_rows_cuda(out, 20, 9, 9, torch.uint8)
    assert all(n == 0 for n in ops.launches.values())
