"""Wire formats: serialize a compressed client delta to a flat ``uint8``
buffer and decode it back bit-exactly.

Counterpart of ``repro.comm.wire``, with the same byte layout, so a port
buffer and a JAX buffer of the same message agree byte for byte (the sign
codec's 4 scale bytes excepted, see below). Every message is

    [16-byte header][payload]

with the header carrying magic/version/codec/value-dtype plus ``d``, the
per-block keep count and the block size (all little-endian ``uint32``).
Codecs:

``dense32``
    Raw fp32 coordinates — the uncompressed baseline, 32d bits + header.
``topk``
    Exact global top-k: ``k`` uint32 indices + ``k`` values (fp32, fp16 or
    bf16).
``blocktopk``
    Blockwise top-k: per-block indices packed at ``ceil(log2(B))`` bits
    each (11 bits for B=2048) + values at fp32/fp16/bf16, or int8 against a
    per-block fp32 scale (max|v|/127).
``sign``
    Scaled sign: one fp32 scale (‖x‖₁/d, or one per block when
    ``block > 0``) + 1 bit per coordinate — Table 1's 32 + d bits.

The sub-word streams (the 1-bit signs, the 11-bit indices) go through
:func:`pack_uint` / :func:`unpack_uint`, which dispatch per device like
every kernel route: the CUDA kernel on a card, its twin on the CPU. The
JAX codecs' ``pack_impl`` chooses between two routes on the chip (XLA or
Pallas, byte-identical); the port has one, so its codecs take no such
argument and ``FedConfig.wire_pack_impl`` changes nothing here.

Selections use the port's stable-sort top-k (``core.compressors``), the
same picks as ``lax.top_k``. The sign scale is summed by the fixed halving
trees of ``kernels.ref.sign_scale``; ``jnp.mean``'s order is unspecified,
so the 4 scale bytes may differ from JAX's by a few ulp while the header
and the packed bits are byte-equal. With fp32 values,
``decode(encode(x)) == compressor.compress(x)`` bit for bit.

Nothing here synchronizes the device with the host: shapes follow from
``d`` and the codec config, the header tensor is built once per (d,
device), and ``decode(buf, d)`` takes the known ``d`` instead of parsing
the header (:func:`parse_header` is the host-side check).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.compressors import (Compressor, Selection, block_layout,
                                          make_blocktopk, make_identity,
                                          make_sign, make_topk)
from repro_torch.kernels import ops, ref

HEADER_BYTES = 16
MAGIC = 0xFC
VERSION = 1

CODEC_IDS = {"dense32": 1, "topk": 2, "blocktopk": 3, "sign": 4}
_VALUE_DTYPES = {
    "float32": (0, torch.float32, 4),
    "float16": (1, torch.float16, 2),
    "bfloat16": (2, torch.bfloat16, 2),
    "int8": (3, torch.int8, 1),
}


# ---------------------------------------------------------------------------
# byte-level helpers
# ---------------------------------------------------------------------------


def _to_bytes(x) -> torch.Tensor:
    """Reinterpret any tensor as a flat uint8 view (little-endian)."""
    x = x.contiguous()
    if x.dtype == torch.uint8:
        return x.reshape(-1)
    return x.reshape(-1).view(torch.uint8)


def _from_bytes(buf, dtype, count: int):
    """Inverse of ``_to_bytes``: read ``count`` items of ``dtype``. The
    slice is copied first, since a view as a wider dtype needs an aligned
    offset that a packed stream does not keep."""
    if dtype == torch.uint8:
        return buf[:count]
    width = torch.empty((), dtype=dtype).element_size()
    return buf[:count * width].clone().view(dtype)


def pack_uint(vals, nbits: int) -> torch.Tensor:
    """Pack unsigned ints (< 2**nbits; uint8 or int32 holding uint32 bit
    patterns) at ``nbits`` bits each, MSB-first, into a uint8 stream
    (zero-padded to a whole byte)."""
    return ops.pack_uint(vals, nbits)


def unpack_uint(buf, nbits: int, count: int,
                dtype=torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack_uint`: ``count`` values as int32 (uint32 bit
    patterns) or, for nbits <= 8, uint8."""
    return ops.unpack_uint(buf, nbits, count, dtype)


def _header_np(codec: str, vdtype: str, d: int, k: int, block: int):
    h = np.zeros(HEADER_BYTES, np.uint8)
    h[0], h[1] = MAGIC, VERSION
    h[2] = CODEC_IDS[codec]
    h[3] = _VALUE_DTYPES[vdtype][0]
    h[4:8] = np.frombuffer(np.uint32(d).astype("<u4").tobytes(), np.uint8)
    h[8:12] = np.frombuffer(np.uint32(k).astype("<u4").tobytes(), np.uint8)
    h[12:16] = np.frombuffer(np.uint32(block).astype("<u4").tobytes(),
                             np.uint8)
    return h


@functools.lru_cache(maxsize=64)
def _header(codec: str, vdtype: str, d: int, k: int, block: int,
            device: torch.device) -> torch.Tensor:
    """The 16 header bytes on ``device``, built once per message shape (a
    host-to-device copy per message would synchronize every encode)."""
    return torch.from_numpy(_header_np(codec, vdtype, d, k, block)).to(device)


def parse_header(buf) -> dict:
    """Host-side header validation/introspection (copies 16 bytes to the
    host; not for the round)."""
    h = buf[:HEADER_BYTES].cpu().numpy().astype(np.uint8)
    if h[0] != MAGIC or h[1] != VERSION:
        raise ValueError(f"bad wire header: magic={h[0]:#x} version={h[1]}")
    names = {v: k for k, v in CODEC_IDS.items()}
    vnames = {v[0]: k for k, v in _VALUE_DTYPES.items()}
    word = lambda a: int(a.view("<u4")[0])
    return {
        "codec": names[int(h[2])],
        "value_dtype": vnames[int(h[3])],
        "d": word(h[4:8]),
        "k": word(h[8:12]),
        "block": word(h[12:16]),
    }


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WireCodec:
    """A serializer for compressed deltas (``repro.comm.wire.WireCodec``).

    ``encode(x, rng=None)`` maps a flat fp32 vector to a packed uint8
    buffer; ``decode(buf, d)`` maps it back to the dense fp32
    representation (``d`` must be the original length). ``nbytes(d)`` is
    the exact buffer size. ``compressor`` is the dense-path
    :class:`Compressor` this codec is the wire format of; ``exact`` states
    whether ``decode(encode(x)) == compressor.compress(x)`` bit for bit.

    Codecs whose payload is (value, index) pairs also provide
    ``encode_from_selection(sel, d)`` (byte-identical to ``encode(x)``
    when ``sel`` is the compressor's own selection of ``x``),
    ``decode_to_selection(buf, d)`` and ``roundtrip_selection(sel, d)`` —
    what the server receives, without the byte shuffle (the identity for
    ``exact`` codecs, the value narrowing otherwise)."""

    name: str
    encode: Callable
    decode: Callable
    nbytes: Callable
    compressor: Compressor
    exact: bool = True
    header_bytes: int = field(default=HEADER_BYTES)
    encode_from_selection: Optional[Callable] = None
    decode_to_selection: Optional[Callable] = None
    roundtrip_selection: Optional[Callable] = None


def make_dense32_codec() -> WireCodec:
    def encode(x, rng=None):
        flat = x.reshape(-1).float()
        return torch.cat([
            _header("dense32", "float32", flat.numel(), 0, 0, flat.device),
            _to_bytes(flat)])

    def decode(buf, d: int):
        return _from_bytes(buf[HEADER_BYTES:], torch.float32, d)

    return WireCodec(name="dense32", encode=encode, decode=decode,
                     nbytes=lambda d: HEADER_BYTES + 4 * d,
                     compressor=make_identity())


def make_topk_codec(ratio: float, value_dtype: str = "float32") -> WireCodec:
    if value_dtype not in ("float32", "float16", "bfloat16"):
        raise ValueError(f"topk codec: unsupported value_dtype {value_dtype!r}")
    _, vdt, vb = _VALUE_DTYPES[value_dtype]
    comp = make_topk(ratio)

    def k_of(d: int) -> int:
        return max(1, int(round(ratio * d)))

    def encode_from_selection(sel: Selection, d: int):
        return torch.cat([
            _header("topk", value_dtype, d, k_of(d), 0, sel.vals.device),
            _to_bytes(sel.idx.to(torch.int32)), _to_bytes(sel.vals.to(vdt))])

    def encode(x, rng=None):
        flat = x.reshape(-1).float()
        return encode_from_selection(comp.select(flat), flat.numel())

    def decode_to_selection(buf, d: int) -> Selection:
        k = k_of(d)
        off = HEADER_BYTES
        idx = _from_bytes(buf[off:], torch.int32, k)
        vals = _from_bytes(buf[off + 4 * k:], vdt, k).float()
        return Selection(vals=vals, idx=idx)

    def decode(buf, d: int):
        sel = decode_to_selection(buf, d)
        out = torch.zeros(d, dtype=torch.float32, device=buf.device)
        out[sel.idx.long()] = sel.vals
        return out

    def roundtrip_selection(sel: Selection, d: int) -> Selection:
        if value_dtype == "float32":
            return sel
        return Selection(vals=sel.vals.to(vdt).float(), idx=sel.idx)

    return WireCodec(
        name=f"topk_{ratio:g}_{value_dtype}", encode=encode, decode=decode,
        nbytes=lambda d: HEADER_BYTES + k_of(d) * (4 + vb),
        compressor=comp, exact=value_dtype == "float32",
        encode_from_selection=encode_from_selection,
        decode_to_selection=decode_to_selection,
        roundtrip_selection=roundtrip_selection)


def make_blocktopk_codec(ratio: float, block: int = 2048,
                         value_dtype: str = "float32") -> WireCodec:
    _, vdt, vb = _VALUE_DTYPES[value_dtype]
    int8 = value_dtype == "int8"
    comp = make_blocktopk(ratio, block)

    def layout(d: int):
        bs, nb = block_layout(d, block)
        kb = max(1, int(round(ratio * bs)))
        ib = max(1, math.ceil(math.log2(bs)))
        return bs, nb, kb, ib

    def _quantize(vals):
        """Per-block int8 quantization of (nb, kb) kept values; returns
        (scale (nb,), q (nb, kb) int8)."""
        amax = vals.abs().amax(dim=1)
        scale = ref.div_rn(torch.maximum(amax, amax.new_tensor(1e-30)),
                           127.0)
        return scale, torch.round(vals / scale[:, None]).to(torch.int8)

    def _bases(nb: int, bs: int, device):
        return (torch.arange(nb, dtype=torch.int32, device=device)
                * bs)[:, None]

    def encode_from_selection(sel: Selection, d: int):
        bs, nb, kb, ib = layout(d)
        # Selection carries padded-domain global positions in block order;
        # the wire packs block-local offsets at ib bits each
        dev = sel.vals.device
        idx = sel.idx.reshape(nb, kb).to(torch.int32) - _bases(nb, bs, dev)
        vals = sel.vals.reshape(nb, kb)
        parts = [_header("blocktopk", value_dtype, d, kb, bs, dev),
                 pack_uint(idx.contiguous(), ib)]
        if int8:
            scale, q = _quantize(vals)
            parts += [_to_bytes(scale), _to_bytes(q)]
        else:
            parts.append(_to_bytes(vals.to(vdt)))
        return torch.cat(parts)

    def encode(x, rng=None):
        flat = x.reshape(-1).float()
        return encode_from_selection(comp.select(flat), flat.numel())

    def decode_to_selection(buf, d: int) -> Selection:
        bs, nb, kb, ib = layout(d)
        off = HEADER_BYTES
        nidx = (nb * kb * ib + 7) // 8
        idx = unpack_uint(buf[off:off + nidx], ib, nb * kb).reshape(nb, kb)
        off += nidx
        if int8:
            scale = _from_bytes(buf[off:], torch.float32, nb)
            off += 4 * nb
            q = _from_bytes(buf[off:], torch.int8, nb * kb)
            vals = q.reshape(nb, kb).float() * scale[:, None]
        else:
            vals = _from_bytes(buf[off:], vdt, nb * kb)
            vals = vals.reshape(nb, kb).float()
        gidx = idx + _bases(nb, bs, buf.device)
        return Selection(vals=vals.reshape(-1), idx=gidx.reshape(-1))

    def decode(buf, d: int):
        bs, nb, kb, ib = layout(d)
        sel = decode_to_selection(buf, d)
        out = torch.zeros(nb * bs, dtype=torch.float32, device=buf.device)
        out[sel.idx.long()] = sel.vals
        return out[:d]

    def roundtrip_selection(sel: Selection, d: int) -> Selection:
        if value_dtype == "float32":
            return sel
        bs, nb, kb, ib = layout(d)
        vals = sel.vals.reshape(nb, kb)
        if int8:
            scale, q = _quantize(vals)
            vals = q.float() * scale[:, None]
        else:
            vals = vals.to(vdt).float()
        return Selection(vals=vals.reshape(-1), idx=sel.idx)

    def nbytes(d: int) -> int:
        bs, nb, kb, ib = layout(d)
        n = HEADER_BYTES + (nb * kb * ib + 7) // 8
        return n + (4 * nb + nb * kb if int8 else nb * kb * vb)

    return WireCodec(
        name=f"blocktopk_{ratio:g}_{value_dtype}", encode=encode,
        decode=decode, nbytes=nbytes, compressor=comp,
        exact=value_dtype == "float32",
        encode_from_selection=encode_from_selection,
        decode_to_selection=decode_to_selection,
        roundtrip_selection=roundtrip_selection)


def make_sign_codec(block: int = 0) -> WireCodec:
    """1 bit/coordinate + fp32 scale(s). ``block=0``: one global ‖x‖₁/d
    scale — the paper's Table 1 format and bit-exact vs ``make_sign``.
    ``block>0``: one scale per block of that size (mean |x| over the
    block's real elements)."""

    def nb_of(d: int) -> int:
        return 1 if block <= 0 else -(-d // block)

    def scales_of(flat, d: int):
        if block <= 0:
            return ref.sign_scale(flat.reshape(1, -1))
        nb = nb_of(d)
        xb = torch.nn.functional.pad(flat.abs(), (0, nb * block - d))
        counts = (d - torch.arange(nb, device=flat.device) * block).clamp(
            0, block).float()
        return ref.tree_sum(xb.view(nb, block)) / counts

    def encode(x, rng=None):
        flat = x.reshape(-1).float()
        d = flat.numel()
        return torch.cat([
            _header("sign", "float32", d, 0, max(block, 0), flat.device),
            _to_bytes(scales_of(flat, d)),
            pack_uint((flat >= 0).to(torch.uint8), 1)])

    def decode(buf, d: int):
        nb = nb_of(d)
        scales = _from_bytes(buf[HEADER_BYTES:], torch.float32, nb)
        bits = unpack_uint(buf[HEADER_BYTES + 4 * nb:], 1, d, torch.uint8)
        sgn = bits.float() * 2.0 - 1.0
        if block <= 0:
            return scales[0] * sgn
        return torch.repeat_interleave(scales, block)[:d] * sgn

    def dense_compress(x, rng=None):
        flat = x.reshape(-1).float()
        return decode(encode(flat), flat.numel()).reshape(x.shape)

    base = make_sign()
    comp = base if block <= 0 else Compressor(
        name=f"sign_b{block}", compress=dense_compress,
        bits_per_message=lambda d: 32 * nb_of(d) + d, q_bound=base.q_bound)

    return WireCodec(
        name="sign" if block <= 0 else f"sign_b{block}",
        encode=encode, decode=decode,
        nbytes=lambda d: HEADER_BYTES + 4 * nb_of(d) + (d + 7) // 8,
        compressor=comp)


def make_wire_codec(name: str, ratio: float = 1 / 64, block: int = 2048,
                    value_dtype: str = "float32") -> WireCodec:
    """Registry mirroring :func:`repro_torch.core.compressors.
    make_compressor`."""
    if name in ("none", "identity", "dense32"):
        return make_dense32_codec()
    if name == "topk":
        return make_topk_codec(ratio, value_dtype)
    if name == "blocktopk":
        return make_blocktopk_codec(ratio, block, value_dtype)
    if name in ("sign", "packedsign"):
        return make_sign_codec()
    raise ValueError(
        f"no wire codec for compressor {name!r} (randk/int8 deltas have no "
        f"packed format yet — run them with wire=False)")


def measured_vs_analytic(codec: WireCodec, d: int) -> dict:
    """Measured wire size against the Table-1 analytic bit count."""
    analytic_bits = codec.compressor.bits_per_message(d)
    measured_bits = 8 * codec.nbytes(d)
    return {
        "codec": codec.name, "d": d,
        "measured_bytes": codec.nbytes(d),
        "measured_bits": measured_bits,
        "analytic_bits": analytic_bits,
        "header_bits": 8 * codec.header_bytes,
        "overhead_bits": measured_bits - analytic_bits,
    }
