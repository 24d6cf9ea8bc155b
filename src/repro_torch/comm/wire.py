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

Every codec encodes and decodes a whole (c, ·) block of clients at once
(``encode_rows`` / ``decode_rows``, what the JAX codecs do under
``jax.vmap``): each of its steps runs once over the block, and the
sub-word streams (the 1-bit signs, the 11-bit indices) are packed straight
into, and unpacked straight from, the (c, nbytes) message block by one
``kernels.ops.pack_uint_rows`` / ``unpack_uint_rows`` call, which
dispatches per device like every kernel route: the CUDA kernel on a card,
its twin on the CPU. The sign codec's ``>= 0`` predicate and its scaled
decode run inside those calls. ``encode`` / ``decode`` of one message are
the block of one row. The JAX codecs' ``pack_impl`` chooses between two
routes on the chip (XLA or Pallas, byte-identical); the port has one, so
its codecs take no such argument and ``FedConfig.wire_pack_impl`` changes
nothing here.

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
import torch.nn.functional as F

from repro_torch.core.compressors import (Compressor, Selection, _top_idx,
                                          block_layout, make_blocktopk,
                                          make_identity, make_sign, make_topk)
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


def _row_bytes(x) -> torch.Tensor:
    """A (c, n) tensor as its (c, n·itemsize) little-endian bytes."""
    return x.contiguous().view(torch.uint8)


def _cols(bufs, start: int, count: int, dtype):
    """``count`` items of ``dtype`` from column ``start`` of each row of the
    (c, W) uint8 block ``bufs`` → (c, count). The columns are copied first,
    since a view as a wider dtype needs an aligned offset that a packed
    message does not keep."""
    width = torch.empty((), dtype=dtype).element_size()
    part = bufs[:, start:start + count * width]
    return part.clone(memory_format=torch.contiguous_format).view(dtype)


def _message(c: int, nbytes: int, header):
    """A fresh (c, nbytes) message block with every row's header filled
    in; the codec writes the payload columns."""
    out = torch.empty((c, nbytes), dtype=torch.uint8, device=header.device)
    out[:, :HEADER_BYTES] = header
    return out


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

    ``encode_rows(tot)`` maps a (c, d) block of fp32 vectors to a (c,
    nbytes) uint8 block of messages, each row encoded on its own, and
    ``decode_rows(bufs, d)`` maps it back to the (c, d) dense fp32
    representation — the JAX codec's ``encode``/``decode`` under
    ``jax.vmap``, each codec step run once over the block. ``encode(x,
    rng=None)`` / ``decode(buf, d)`` are the one-message case (``d`` must
    be the original length). ``nbytes(d)`` is the exact message size.
    ``compressor`` is the dense-path :class:`Compressor` this codec is the
    wire format of; ``exact`` states whether ``decode(encode(x)) ==
    compressor.compress(x)`` bit for bit.

    Codecs whose payload is (value, index) pairs also provide
    ``encode_from_selection(sel, d)`` (byte-identical to ``encode(x)``
    when ``sel`` is the compressor's own selection of ``x``),
    ``decode_to_selection(buf, d)`` and ``roundtrip_selection(sel, d)`` —
    what the server receives, without the byte shuffle (the identity for
    ``exact`` codecs, the value narrowing otherwise)."""

    name: str
    encode_rows: Callable
    decode_rows: Callable
    nbytes: Callable
    compressor: Compressor
    exact: bool = True
    header_bytes: int = field(default=HEADER_BYTES)
    encode_from_selection: Optional[Callable] = None
    decode_to_selection: Optional[Callable] = None
    roundtrip_selection: Optional[Callable] = None

    def encode(self, x, rng=None):
        return self.encode_rows(x.reshape(1, -1))[0]

    def decode(self, buf, d: int):
        return self.decode_rows(buf.reshape(1, -1), d)[0]


def make_dense32_codec() -> WireCodec:
    def encode_rows(tot):
        tot = tot.float()
        c, d = tot.shape
        out = _message(c, HEADER_BYTES + 4 * d,
                       _header("dense32", "float32", d, 0, 0, tot.device))
        out[:, HEADER_BYTES:] = _row_bytes(tot)
        return out

    def decode_rows(bufs, d: int):
        return _cols(bufs, HEADER_BYTES, d, torch.float32)

    return WireCodec(name="dense32", encode_rows=encode_rows,
                     decode_rows=decode_rows,
                     nbytes=lambda d: HEADER_BYTES + 4 * d,
                     compressor=make_identity())


def make_topk_codec(ratio: float, value_dtype: str = "float32") -> WireCodec:
    if value_dtype not in ("float32", "float16", "bfloat16"):
        raise ValueError(f"topk codec: unsupported value_dtype {value_dtype!r}")
    _, vdt, vb = _VALUE_DTYPES[value_dtype]
    comp = make_topk(ratio)

    def k_of(d: int) -> int:
        return max(1, int(round(ratio * d)))

    def nbytes(d: int) -> int:
        return HEADER_BYTES + k_of(d) * (4 + vb)

    def message(idx, vals, d: int):
        """(c, k) int32 positions and fp32 values → (c, nbytes) messages."""
        k = k_of(d)
        out = _message(idx.shape[0], nbytes(d),
                       _header("topk", value_dtype, d, k, 0, vals.device))
        out[:, HEADER_BYTES:HEADER_BYTES + 4 * k] = _row_bytes(idx)
        out[:, HEADER_BYTES + 4 * k:] = _row_bytes(vals.to(vdt))
        return out

    def encode_rows(tot):
        tot = tot.float()
        idx = _top_idx(tot, k_of(tot.shape[1]))        # lax.top_k's picks
        return message(idx.to(torch.int32), tot.gather(1, idx), tot.shape[1])

    def encode_from_selection(sel: Selection, d: int):
        return message(sel.idx.reshape(1, -1).to(torch.int32),
                       sel.vals.reshape(1, -1), d)[0]

    def fields(bufs, d: int):
        k = k_of(d)
        return (_cols(bufs, HEADER_BYTES, k, torch.int32),
                _cols(bufs, HEADER_BYTES + 4 * k, k, vdt).float())

    def decode_rows(bufs, d: int):
        idx, vals = fields(bufs, d)
        out = torch.zeros((bufs.shape[0], d), dtype=torch.float32,
                          device=bufs.device)
        return out.scatter_(1, idx.long(), vals)

    def decode_to_selection(buf, d: int) -> Selection:
        idx, vals = fields(buf.reshape(1, -1), d)
        return Selection(vals=vals[0], idx=idx[0])

    def roundtrip_selection(sel: Selection, d: int) -> Selection:
        if value_dtype == "float32":
            return sel
        return Selection(vals=sel.vals.to(vdt).float(), idx=sel.idx)

    return WireCodec(
        name=f"topk_{ratio:g}_{value_dtype}", encode_rows=encode_rows,
        decode_rows=decode_rows, nbytes=nbytes,
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
        """Per-block int8 quantization of (..., nb, kb) kept values; returns
        (scale (..., nb), q (..., nb, kb) int8)."""
        amax = vals.abs().amax(dim=-1)
        scale = ref.div_rn(amax.clamp_min(1e-30), 127.0)
        return scale, torch.round(vals / scale[..., None]).to(torch.int8)

    def _bases(nb: int, bs: int, device):
        return (torch.arange(nb, dtype=torch.int32, device=device)
                * bs)[:, None]

    def nbytes(d: int) -> int:
        bs, nb, kb, ib = layout(d)
        n = HEADER_BYTES + (nb * kb * ib + 7) // 8
        return n + (4 * nb + nb * kb if int8 else nb * kb * vb)

    def message(li, vals, d: int):
        """(c, nb, kb) int32 block-local offsets and fp32 values → (c,
        nbytes) messages: the offsets packed at ib bits each, straight
        into the block, then the values."""
        bs, nb, kb, ib = layout(d)
        c = li.shape[0]
        out = _message(c, nbytes(d), _header("blocktopk", value_dtype, d, kb,
                                             bs, vals.device))
        ops.pack_uint_rows(li.reshape(c, -1).contiguous(), ib, out,
                           HEADER_BYTES)
        off = HEADER_BYTES + (nb * kb * ib + 7) // 8
        if int8:
            scale, q = _quantize(vals)
            out[:, off:off + 4 * nb] = _row_bytes(scale)
            out[:, off + 4 * nb:] = _row_bytes(q.reshape(c, -1))
        else:
            out[:, off:] = _row_bytes(vals.reshape(c, -1).to(vdt))
        return out

    def encode_rows(tot):
        tot = tot.float()
        c, d = tot.shape
        bs, nb, kb, ib = layout(d)
        xb = F.pad(tot, (0, nb * bs - d)).view(c, nb, bs)
        li = _top_idx(xb, kb)           # (c, nb, kb): lax.top_k's picks
        return message(li.to(torch.int32), xb.gather(2, li), d)

    def encode_from_selection(sel: Selection, d: int):
        # Selection carries padded-domain global positions in block order;
        # the wire packs block-local offsets at ib bits each
        bs, nb, kb, ib = layout(d)
        dev = sel.vals.device
        li = sel.idx.reshape(nb, kb).to(torch.int32) - _bases(nb, bs, dev)
        return message(li[None], sel.vals.reshape(1, nb, kb), d)[0]

    def fields(bufs, d: int):
        """(c, nb, kb) global int32 positions and fp32 values of each
        message of the block."""
        bs, nb, kb, ib = layout(d)
        c = bufs.shape[0]
        li = ops.unpack_uint_rows(bufs, HEADER_BYTES, ib, nb * kb)
        off = HEADER_BYTES + (nb * kb * ib + 7) // 8
        if int8:
            scale = _cols(bufs, off, nb, torch.float32)
            q = _cols(bufs, off + 4 * nb, nb * kb, torch.int8)
            vals = q.view(c, nb, kb).float() * scale[..., None]
        else:
            vals = _cols(bufs, off, nb * kb, vdt).view(c, nb, kb).float()
        return li.view(c, nb, kb) + _bases(nb, bs, bufs.device), vals

    def decode_rows(bufs, d: int):
        bs, nb, kb, ib = layout(d)
        c = bufs.shape[0]
        gidx, vals = fields(bufs, d)
        out = torch.zeros((c, nb * bs), dtype=torch.float32,
                          device=bufs.device)
        out.scatter_(1, gidx.view(c, -1).long(), vals.view(c, -1))
        return out[:, :d]

    def decode_to_selection(buf, d: int) -> Selection:
        gidx, vals = fields(buf.reshape(1, -1), d)
        return Selection(vals=vals.reshape(-1), idx=gidx.reshape(-1))

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

    return WireCodec(
        name=f"blocktopk_{ratio:g}_{value_dtype}", encode_rows=encode_rows,
        decode_rows=decode_rows, nbytes=nbytes, compressor=comp,
        exact=value_dtype == "float32",
        encode_from_selection=encode_from_selection,
        decode_to_selection=decode_to_selection,
        roundtrip_selection=roundtrip_selection)


def make_sign_codec(block: int = 0) -> WireCodec:
    """1 bit/coordinate + fp32 scale(s). ``block=0``: one global ‖x‖₁/d
    scale — the paper's Table 1 format and bit-exact vs ``make_sign``.
    ``block>0``: one scale per block of that size (mean |x| over the
    block's real elements). Encode is the scales, then one fused pack of
    the ``>= 0`` predicate from the fp32 totals; decode is one fused unpack
    that multiplies each row's scale(s), read from the message, by ±1."""

    def nb_of(d: int) -> int:
        return 1 if block <= 0 else -(-d // block)

    def scales_of(tot):
        """(c, d) → (c, nb) fp32 scales."""
        c, d = tot.shape
        if block <= 0:
            return ref.sign_scale(tot)[:, None]
        nb = nb_of(d)
        xb = F.pad(tot.abs(), (0, nb * block - d)).view(c, nb, block)
        counts = (d - torch.arange(nb, device=tot.device) * block).clamp(
            0, block).float()
        return ref.tree_sum(xb) / counts

    def nbytes(d: int) -> int:
        return HEADER_BYTES + 4 * nb_of(d) + (d + 7) // 8

    def encode_rows(tot):
        tot = tot.float().contiguous()
        c, d = tot.shape
        nb = nb_of(d)
        out = _message(c, nbytes(d), _header("sign", "float32", d, 0,
                                             max(block, 0), tot.device))
        out[:, HEADER_BYTES:HEADER_BYTES + 4 * nb] = _row_bytes(
            scales_of(tot))
        return ops.pack_uint_rows(tot, 1, out, HEADER_BYTES + 4 * nb)

    def decode_rows(bufs, d: int):
        return ops.unpack_uint_rows(bufs, HEADER_BYTES + 4 * nb_of(d), 1, d,
                                    torch.float32, scale_col=HEADER_BYTES,
                                    scale_block=max(block, 0))

    def dense_compress(x, rng=None):
        flat = x.reshape(1, -1)
        return decode_rows(encode_rows(flat), flat.shape[1]).reshape(x.shape)

    base = make_sign()
    comp = base if block <= 0 else Compressor(
        name=f"sign_b{block}", compress=dense_compress,
        bits_per_message=lambda d: 32 * nb_of(d) + d, q_bound=base.q_bound)

    return WireCodec(
        name="sign" if block <= 0 else f"sign_b{block}",
        encode_rows=encode_rows, decode_rows=decode_rows, nbytes=nbytes,
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
