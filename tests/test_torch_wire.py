"""The port's wire formats against ``repro.comm.wire`` and
``repro.kernels.bitpack``: the n-bit packing twins byte-identical to
``pack_uint_words``/``unpack_uint_words`` and to the Pallas kernels
(interpret mode) for every width, and every codec's bytes, decode and
sizes against the JAX codec on the same input.

Byte equality holds for the whole buffer except the sign codec's scale
(4 bytes per scale): it is summed in the port's fixed tree order and held
within ``SIGN_ULP`` ulp (tests/test_torch_dense_uplink.py). The CUDA
pack/unpack kernels are held to the twins on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:  # see tests/hypothesis_fallback.py
    from hypothesis_fallback import given, settings, st

from repro.comm import wire as jw
from repro.kernels import bitpack as jbp
from repro_torch.comm import wire as tw
from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import Selection
from repro_torch.kernels import ops, ref
from test_torch_dense_uplink import SIGN_ULP, _ulps

torch.set_num_threads(1)


def _values(seed, nbits, count):
    r = np.random.default_rng(seed)
    return r.integers(0, 2 ** nbits, size=count, dtype=np.uint64).astype(
        np.uint32)


def _port_vals(v):
    """uint32 values → the port's int32 carrier (the same bits)."""
    return torch.from_numpy(v.view(np.int32).copy())


# -- n-bit packing ------------------------------------------------------------


@pytest.mark.parametrize("nbits", range(1, 33))
def test_pack_uint_twins_match_words_and_pallas(nbits):
    """Every width at a ragged count: the twin, the kernel route on the CPU
    (``ops``, and the wire module's entry through it), the JAX word-wise
    form and the Pallas kernel produce the same bytes, and unpack inverts
    them."""
    count = 1000 + nbits            # never a whole number of groups
    v = _values(nbits, nbits, count)
    want = np.asarray(jbp.pack_uint_words(jnp.asarray(v), nbits))
    pallas = np.asarray(jbp.pack_uint(jnp.asarray(v), nbits, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    for got in (ref.pack_uint(_port_vals(v), nbits),
                ops.pack_uint(_port_vals(v), nbits),
                tw.pack_uint(_port_vals(v), nbits)):
        assert got.dtype == torch.uint8 and got.numel() == want.size
        np.testing.assert_array_equal(got.numpy(), want)
    buf = torch.from_numpy(want.copy())
    jun = np.asarray(jbp.unpack_uint_words(jnp.asarray(want), nbits, count))
    np.testing.assert_array_equal(jun, v)
    for got in (ref.unpack_uint(buf, nbits, count),
                ops.unpack_uint(buf, nbits, count),
                tw.unpack_uint(buf, nbits, count)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), v)


@pytest.mark.parametrize("nbits,count", [(1, 704266), (11, 11008), (1, 1),
                                         (8, 3), (3, 5)])
def test_pack_uint_at_the_slices_shapes(nbits, count):
    """The sign codec's 1-bit stream of ConvMixer-256-8 (d = 704,266) and
    blocktopk's 11-bit index stream (344 blocks × 32 picks), from uint8
    bits where n = 1; plus tiny ragged counts."""
    v = _values(count, nbits, count)
    inp = (torch.from_numpy(v.astype(np.uint8)) if nbits == 1
           else _port_vals(v))
    got = ops.pack_uint(inp, nbits)
    want = np.asarray(jbp.pack_uint_words(jnp.asarray(v), nbits))
    assert got.numel() == (count * nbits + 7) // 8
    np.testing.assert_array_equal(got.numpy(), want)
    dtype = torch.uint8 if nbits <= 8 else torch.int32
    back = ops.unpack_uint(got, nbits, count, dtype)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back.numpy().astype(np.uint32), v)
    if nbits == 1:
        np.testing.assert_array_equal(got.numpy(),
                                      np.packbits(v.astype(np.uint8)))


def test_pack_uint_keeps_only_the_low_bits_and_reads_missing_bytes_as_0():
    v = torch.tensor([-1, 0x1234567, 5], dtype=torch.int32)
    got = ref.pack_uint(v, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.pack_uint_words(
            jnp.asarray(v.numpy().view(np.uint32)), 4)))
    assert ref.unpack_uint(got, 4, 3).tolist() == [15, 7, 5]
    short = ref.unpack_uint(torch.tensor([0xAB], dtype=torch.uint8), 4, 4)
    assert short.tolist() == [0xA, 0xB, 0, 0]


@settings(max_examples=40, deadline=None)
@given(nbits=st.integers(1, 32), count=st.integers(1, 300),
       seed=st.integers(0, 2 ** 31 - 1))
def test_pack_uint_property(nbits, count, seed):
    """Any width and count: the twin equals ``pack_uint_words`` and the
    round trip is the identity."""
    v = _values(seed, nbits, count)
    got = ref.pack_uint(_port_vals(v), nbits)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.pack_uint_words(jnp.asarray(v), nbits)))
    back = ref.unpack_uint(got, nbits, count).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, v)


# -- codecs ---------------------------------------------------------------------


def _pallas(m):
    """The JAX codec's Pallas packing route (interpret mode here); the
    port's codecs have one route, the kernel dispatch of ``ops``."""
    return {"pack_impl": "pallas"} if m is jw else {}


CODECS = {
    "dense32": (lambda m: m.make_dense32_codec(), None),
    "topk-f32": (lambda m: m.make_topk_codec(1 / 8), None),
    "topk-f16": (lambda m: m.make_topk_codec(1 / 8, "float16"), None),
    "topk-bf16": (lambda m: m.make_topk_codec(1 / 8, "bfloat16"), None),
    "blocktopk-f32": (lambda m: m.make_blocktopk_codec(1 / 64), None),
    "blocktopk-f32-pallas": (
        lambda m: m.make_blocktopk_codec(1 / 64, **_pallas(m)), None),
    "blocktopk-f16": (
        lambda m: m.make_blocktopk_codec(1 / 8, 256, "float16"), None),
    "blocktopk-bf16": (
        lambda m: m.make_blocktopk_codec(1 / 8, 256, "bfloat16"), None),
    "blocktopk-int8": (
        lambda m: m.make_blocktopk_codec(1 / 8, 256, "int8", **_pallas(m)),
        None),
    "sign": (lambda m: m.make_sign_codec(), lambda d: 1),
    "sign-pallas": (lambda m: m.make_sign_codec(**_pallas(m)),
                    lambda d: 1),
    "sign-block": (lambda m: m.make_sign_codec(block=300),
                   lambda d: -(-d // 300)),
}


def _x(d, kind="normal"):
    r = np.random.default_rng(d)
    if kind == "ties":
        x = (r.integers(-2, 3, size=d) * 0.5).astype(np.float32)
        x[::5] = -0.0
        return x
    return (r.normal(size=d) * 0.1).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("d", [37, 1000, 6922])
@pytest.mark.parametrize("name", list(CODECS))
def test_codec_bytes_decode_and_sizes_match_jax(name, d, kind):
    make, n_scales = CODECS[name]
    jc, tc = make(jw), make(tw)
    assert tc.name == jc.name and tc.exact == jc.exact
    x = _x(d, kind)
    jbuf = np.asarray(jc.encode(jnp.asarray(x)))
    tbuf = tc.encode(torch.from_numpy(x))
    assert tbuf.dtype == torch.uint8 and tbuf.numel() == tc.nbytes(d)
    assert tc.nbytes(d) == jc.nbytes(d) == jbuf.size
    assert tw.measured_vs_analytic(tc, d) == jw.measured_vs_analytic(jc, d)
    t = tbuf.numpy()
    if n_scales:   # the sign scale(s): within SIGN_ULP, the rest equal
        s0, s1 = tw.HEADER_BYTES, tw.HEADER_BYTES + 4 * n_scales(d)
        for a, b in zip(t[s0:s1].view(np.float32), jbuf[s0:s1].view(
                np.float32)):
            assert _ulps(a, b) <= SIGN_ULP, (a, b)
        np.testing.assert_array_equal(t[:s0], jbuf[:s0])
        np.testing.assert_array_equal(t[s1:], jbuf[s1:])
        jdec = np.asarray(jc.decode(jnp.asarray(t), d))  # the port's bytes
    else:
        np.testing.assert_array_equal(t, jbuf)
        jdec = np.asarray(jc.decode(jnp.asarray(jbuf), d))
    np.testing.assert_array_equal(tc.decode(tbuf, d).numpy(), jdec)
    if tc.exact:   # decode(encode(x)) is the compressor's output
        assert torch.equal(tc.decode(tbuf, d),
                           tc.compressor.compress(torch.from_numpy(x)))
    assert tw.parse_header(tbuf) == jw.parse_header(jnp.asarray(jbuf))


@pytest.mark.parametrize("name", [n for n in CODECS
                                  if n.startswith(("topk", "blocktopk"))])
@pytest.mark.parametrize("d", [1000, 6922])
def test_selection_paths_match_the_byte_roundtrip(name, d):
    """``encode_from_selection`` of the compressor's own selection is
    ``encode``'s bytes; ``roundtrip_selection`` equals
    ``decode_to_selection(encode_from_selection(·))`` and the JAX
    ``roundtrip_selection``."""
    make, _ = CODECS[name]
    jc, tc = make(jw), make(tw)
    x = torch.from_numpy(_x(d))
    sel = tc.compressor.select(x)
    buf = tc.encode_from_selection(sel, d)
    assert torch.equal(buf, tc.encode(x))
    back = tc.decode_to_selection(buf, d)
    rt = tc.roundtrip_selection(sel, d)
    assert torch.equal(rt.vals, back.vals) and torch.equal(rt.idx, back.idx)
    jsel = jw.Selection(vals=jnp.asarray(sel.vals.numpy()),
                        idx=jnp.asarray(sel.idx.numpy()))
    jrt = jc.roundtrip_selection(jsel, d)
    np.testing.assert_array_equal(np.asarray(jrt.vals), rt.vals.numpy())
    np.testing.assert_array_equal(np.asarray(jrt.idx), rt.idx.numpy())


def test_registry_header_and_refusals():
    for name in ("none", "identity", "dense32", "topk", "blocktopk", "sign",
                 "packedsign"):
        assert tw.make_wire_codec(name).name == jw.make_wire_codec(name).name
    for name in ("int8", "randk"):
        with pytest.raises(ValueError, match="no wire codec"):
            tw.make_wire_codec(name)
    with pytest.raises(ValueError, match="wire_pack_impl"):
        FedConfig(wire_pack_impl="fast")
    bad = tw.make_dense32_codec().encode(torch.ones(4)).clone()
    bad[0] = 0
    with pytest.raises(ValueError, match="bad wire header"):
        tw.parse_header(bad)
    sel = Selection(vals=torch.ones(2), idx=torch.tensor([0, 1],
                                                         dtype=torch.int32))
    assert tw.make_topk_codec(1 / 2).roundtrip_selection(sel, 4) is sel
