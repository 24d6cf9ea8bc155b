"""Plain-PyTorch twins of the CUDA kernels (the CPU path and the on-card
oracle).

Each function computes exactly what its kernel in ``csrc/`` computes, with
the same inputs, outputs and accumulation order, so the kernel is held to
it bitwise on the card, and the twin is held to the JAX package's eager
functions, Pallas kernels (interpret mode) and ``repro.kernels.ref``
oracles on the CPU (tests/test_torch_kernels.py,
tests/test_torch_dense_uplink.py, tests/test_torch_wire.py). Every
multiply and add is rounded separately; the jitted Pallas programs on
XLA:CPU contract the moment updates into FMAs and sit one rounding away.

* :func:`topk_ef_sparse` — ``repro.kernels.topk_ef.topk_ef_sparse``:
  exact-k per block in ``lax.top_k`` order (descending |value| as its bit
  pattern, so NaN above +inf and NaNs by payload; ties to the lowest
  index). This is NOT the threshold ``repro.kernels.ref.topk_ef_ref``,
  which keeps more than k on ties. The kernels reach the same picks by a
  radix select of the k-th magnitude, which :func:`threshold_select`
  repeats step by step for the tests, on inputs such as
  :func:`topk_hard_cases`.
* :func:`topk_ef` — ``repro.kernels.topk_ef.topk_ef``: the same selection
  with a dense hat (picks kept, the rest 0) and ``err = tot - hat``.
* :func:`sign_ef` — ``repro.kernels.sign_ef.sign_ef``: scaled sign with
  error feedback; the scale ``‖x+e‖₁/d`` is summed by fixed halving trees
  (:func:`sign_scale`), so it is a few ulp from ``jnp.mean``'s, whose order
  is unspecified.
* :func:`pack_uint` / :func:`unpack_uint` — ``repro.kernels.bitpack``'s
  MSB-first n-bit packing, byte-identical to ``pack_uint_words`` /
  ``unpack_uint_words``; :func:`pack_uint_rows` / :func:`unpack_uint_rows`
  are the same over each row of a (c, ·) block (``vmap`` of them), with
  the sign codec's predicate and its scaled decode fused in.
* :func:`fedams_update_ref` — ``repro.kernels.fedams_update`` (and
  ``repro.kernels.ref.fedams_update_ref``): the elementwise FedAMS step.
* :func:`fedams_ingest_ref` — ``repro.kernels.fedams_ingest`` (and
  ``repro.kernels.ref.fedams_ingest_ref``): client-major scatter-mean plus
  the FedAMS step, with bf16 or int8-blockscale second-moment storage.

Python floats (``beta1``, ``1 - beta1``, ``eta``, ``eps``) enter tensor
math as float32 scalars, the same rounding JAX applies to weakly typed
constants.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def magnitude_bits(t):
    """|t| as its fp32 bit pattern (int32 ``bits & 0x7FFFFFFF``): orders as
    ``lax.top_k`` orders ``jnp.abs(t)`` — like the floats (+0.0 == -0.0),
    with a NaN above +inf and NaNs by their payload bits."""
    return t.view(torch.int32) & 0x7FFFFFFF


def _block_picks(x, err, rows, k: int, block: int):
    """EF totals ``x + err[rows]`` cut into zero-padded blocks, and the
    block-local indices of each block's k picks in ``lax.top_k`` order
    (stable descending sort on :func:`magnitude_bits`, or ``argmax`` at
    k = 1: the first maximum on ties)."""
    c, d = x.shape
    nb = -(-d // block)
    tot = x + err[rows]
    tb = F.pad(tot, (0, nb * block - d)).view(c, nb, block)
    mag = magnitude_bits(tb)
    if k == 1:
        li = mag.argmax(dim=-1, keepdim=True)
    else:
        li = torch.sort(mag, dim=-1, descending=True,
                        stable=True).indices[..., :k]
    return tot, tb, li


def topk_ef_sparse(x, err, rows, *, k: int, block: int):
    """Blockwise exact top-k of ``x + err[rows]`` with fused error feedback.

    ``x``: (c, d) fp32 deltas; ``err``: (m, d) fp32 EF buffer; ``rows``:
    (c,) int64 rows of ``err`` (distinct). The last block is zero-padded to
    ``nb·block``; padded positions compete as zeros and can be picked (their
    global index is ≥ d and their value 0.0). ``err[rows]`` is overwritten
    IN PLACE with the totals, picks zeroed. Returns ``(vals, idx)``, each
    (c, nb, k): kept values in selection order and their global int32 flat
    positions."""
    c, d = x.shape
    _, tb, li = _block_picks(x, err, rows, k, block)
    nb = tb.shape[1]
    vals = tb.gather(-1, li)
    err[rows] = tb.scatter(-1, li, 0.0).view(c, nb * block)[:, :d]
    base = torch.arange(nb, device=x.device)[:, None] * block
    return vals, (li + base).to(torch.int32)


def topk_ef(x, err, rows, *, k: int, block: int):
    """The dense form of :func:`topk_ef_sparse`: the same picks, returned
    as a (c, d) hat that keeps them and is 0 elsewhere. ``err[rows]``
    becomes ``tot - hat`` IN PLACE (0 at the picks, the totals elsewhere),
    the arithmetic of the Pallas ``_topk_ef_kernel``."""
    c, d = x.shape
    tot, tb, li = _block_picks(x, err, rows, k, block)
    nb = tb.shape[1]
    hat = torch.zeros_like(tb).scatter(-1, li, tb.gather(-1, li))
    hat = hat.view(c, nb * block)[:, :d]
    err[rows] = tot - hat
    return hat


#: the CUDA selection's radix digits of a 31-bit magnitude, from the top:
#: (shift, width)
SELECT_DIGITS = ((23, 8), (15, 8), (7, 8), (0, 7))


def threshold_select(tb, k: int):
    """The CUDA kernels' selection (``csrc/topk_select.cuh``) step by step,
    with tensor ops; for tests, which hold it to the stable sort of
    :func:`topk_ef_sparse` and to the Pallas kernels.

    ``tb``: (..., block) fp32 selection blocks. Per block, a radix select
    over the digits of :data:`SELECT_DIGITS` finds the k-th largest
    magnitude's prefix, stopping once its bin is taken whole; then
    ``above`` values lie above the prefix, and the first ``need = k -
    above`` of those equal to it, by index, are kept. The k picks are then
    ordered by (magnitude, index), as the sparse kernel sorts them.

    Returns ``(keep, li, passes)``: the (..., block) membership, the
    (..., k) block-local picks in ``lax.top_k`` order, and the digit passes
    each block took."""
    mag = magnitude_bits(tb).long()
    lead = tb.shape[:-1]
    prefix = torch.zeros(lead, dtype=torch.long, device=tb.device)
    r = torch.full(lead, k, dtype=torch.long, device=tb.device)
    shift = torch.full(lead, 31, dtype=torch.long, device=tb.device)
    done = torch.zeros(lead, dtype=torch.bool, device=tb.device)
    passes = torch.zeros(lead, dtype=torch.long, device=tb.device)
    for sh, width in SELECT_DIGITS:
        live = ~done
        inside = (mag >> shift[..., None]) == prefix[..., None]
        digit = (mag >> sh) & ((1 << width) - 1)
        hist = torch.zeros(lead + (256,), dtype=torch.long, device=tb.device)
        hist.scatter_add_(-1, digit, inside.long())
        upto = hist.flip(-1).cumsum(-1).flip(-1)    # count at digit >= bin
        above = upto - hist
        hit = (above < r[..., None]) & (r[..., None] <= upto)
        b = hit.long().argmax(-1, keepdim=True)
        r_new = r - above.gather(-1, b)[..., 0]
        whole = hist.gather(-1, b)[..., 0] == r_new
        prefix = torch.where(live, (prefix << width) | b[..., 0], prefix)
        r = torch.where(live, r_new, r)
        shift = torch.where(live, torch.full_like(shift, sh), shift)
        passes += live.long()
        done |= whole
    hi = mag >> shift[..., None]
    tie = hi == prefix[..., None]
    rank = tie.long().cumsum(-1) - tie.long()      # among ties, by index
    keep = (hi > prefix[..., None]) | (tie & (rank < r[..., None]))
    # the k picks in index order, then by descending magnitude (stable)
    li = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    li = li[..., :k]
    order = torch.sort(mag.gather(-1, li), dim=-1, descending=True,
                       stable=True).indices
    return keep, li.gather(-1, order), passes


def topk_hard_cases(c: int, d: int, seed: int = 0):
    """(c, d) fp32 totals on which a threshold select can go wrong, from a
    numpy seed, one case per 2048-value segment of each row (repeating),
    normal values after: magnitudes that share their top three radix
    digits; all-equal magnitudes; more ties at the threshold than are
    kept; NaNs (fewer and more than 32 per segment, with several payloads)
    beside ±inf; ±0.0 and denormals. Pass them with an EF of -0.0, which
    adds nothing to any value."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(c, d)).astype(np.float32)
    seg = 2048
    sign = np.where(r.random((c, d)) < 0.5, 0x80000000, 0).astype(np.uint32)
    bits = x.view(np.uint32)
    for i, s0 in enumerate(range(0, d, seg)):
        s1 = min(s0 + seg, d)
        n = s1 - s0
        part = bits[:, s0:s1]
        case = i % 6
        if case == 0:      # last digit only: 1.0's pattern + 7 random bits
            part[:] = (0x3F800000 | r.integers(0, 128, (c, n))).astype(
                np.uint32) | sign[:, s0:s1]
        elif case == 1:    # all equal magnitudes
            part[:] = np.uint32(0x3F400000) | sign[:, s0:s1]
        elif case == 2:    # 20 above, then 100 tied at 2.0, then small
            v = (r.normal(size=(c, n)) * 0.1).astype(np.float32)
            pick = r.permutation(n)
            v[:, pick[:20]] = 3.0
            v[:, pick[20:120]] = -2.0
            part[:] = v.view(np.uint32)
        elif case in (3, 4):   # NaNs with ±inf: 5 (case 3) or 40 (case 4)
            many = 5 if case == 3 else 40
            pick = r.permutation(n)
            payload = r.choice(np.array([0x7FC00000, 0x7FFFFFFF, 0xFFC00001,
                                         0x7F800001], np.uint32), (c, many))
            part[:, pick[:many]] = payload
            part[:, pick[many:many + 3]] = 0x7F800000
            part[:, pick[many + 3:many + 5]] = 0xFF800000
        else:              # ±0.0, denormals, a few small normals
            den = r.integers(1, 0x800000, (c, n)).astype(np.uint32)
            den[r.random((c, n)) < 0.3] = 0
            den[:, r.permutation(n)[:8]] = 0x00800000   # smallest normal
            part[:] = den | sign[:, s0:s1]
    return torch.from_numpy(x)


#: elements per block partial of ``sign_ef`` (the Pallas kernel's
#: DEFAULT_BLOCK)
SIGN_BLOCK = 2048
#: widest halving tree over one client's block partials (sign_ef.cu kChunk)
SIGN_CHUNK = 8192


def tree_sum(a):
    """Sum over the last axis by a halving tree: zero-pad to a power of two
    P, then ``a[..., :h] + a[..., h:]`` for h = P/2, ..., 1 — the order of
    ``sign_ef.cu``'s trees, on any device."""
    n = a.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    a = F.pad(a, (0, p - n))
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def sign_scale(tot):
    """(c, d) → (c,) scales ``‖tot_i‖₁ / d``: each block of
    :data:`SIGN_BLOCK` |values| (the ragged tail zero-filled) is summed by a
    halving tree, the nb partials by a second tree (padded to a power of
    two), and the sum is divided by the true d (a correctly rounded
    division). Past :data:`SIGN_CHUNK` partials (d > 16,777,216) the second
    tree runs over chunks of that many (the last zero-padded), and the
    chunk sums are added in chunk order."""
    c, d = tot.shape
    nb = -(-d // SIGN_BLOCK)
    a = F.pad(tot.abs(), (0, nb * SIGN_BLOCK - d)).view(c, nb, SIGN_BLOCK)
    partials = tree_sum(a)
    if nb <= SIGN_CHUNK:
        return div_rn(tree_sum(partials), float(d))
    nch = -(-nb // SIGN_CHUNK)
    chunks = tree_sum(F.pad(partials, (0, nch * SIGN_CHUNK - nb))
                      .view(c, nch, SIGN_CHUNK))
    total = chunks[:, 0]
    for j in range(1, nch):
        total = total + chunks[:, j]
    return div_rn(total, float(d))


def sign_ef(x, err, rows):
    """Scaled sign with fused error feedback for ``c`` clients:
    ``tot = x + err[rows]``, ``hat = scale·(tot >= 0 ? 1 : -1)`` with the
    per-client :func:`sign_scale`, and ``err[rows] = tot - hat`` IN PLACE.
    sign(0) = sign(-0.0) = +1; a NaN total makes its client's scale, and so
    its whole hat, NaN. Returns the (c, d) hat."""
    tot = x + err[rows]
    scale = sign_scale(tot)[:, None]
    hat = torch.where(tot >= 0, scale, -scale)
    err[rows] = tot - hat
    return hat


# -- n-bit packing (MSB first), the wire formats' sub-word streams ----------


def group_shape(nbits: int):
    """(values, bytes) per stream group: L/nbits and L/8 for L=lcm(nbits,8)."""
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits must be in [1, 32], got {nbits}")
    lcm = math.lcm(nbits, 8)
    return lcm // nbits, lcm // 8


def pack_pairs(nbits: int):
    """(byte k) → [(value slot s, shift)] for one group: slot s lands in
    byte k shifted left by ``8k + 8 − (s+1)·nbits`` (right if negative)."""
    gv, gb = group_shape(nbits)
    return [[(s, 8 * k + 8 - (s + 1) * nbits)
             for s in range((8 * k) // nbits,
                            min((8 * k + 7) // nbits, gv - 1) + 1)]
            for k in range(gb)]


def unpack_pairs(nbits: int):
    """(value slot s) → [(byte k, shift)], the transpose of
    :func:`pack_pairs`."""
    gv, gb = group_shape(nbits)
    return [[(k, 8 * k + 8 - (s + 1) * nbits)
             for k in range((s * nbits) // 8,
                            min(((s + 1) * nbits - 1) // 8, gb - 1) + 1)]
            for s in range(gv)]


def _shl(x, sh: int):
    return x << sh if sh >= 0 else x >> -sh


def _pack_last(v, nbits: int):
    """Masked int64 values (..., count) → (..., ceil(count·nbits/8)) uint8,
    each row of the last axis packed on its own. Word-wise shift/or, one
    column per byte of a group."""
    count = v.shape[-1]
    gv, gb = group_shape(nbits)
    groups = -(-count // gv)
    v = F.pad(v, (0, groups * gv - count)).view(*v.shape[:-1], groups, gv)
    cols = []
    for pairs in pack_pairs(nbits):
        acc = torch.zeros_like(v[..., 0])
        for s, sh in pairs:
            acc = acc | _shl(v[..., s], sh)
        cols.append(acc & 0xFF)
    out = torch.stack(cols, dim=-1).flatten(-2).to(torch.uint8)
    return out[..., :(count * nbits + 7) // 8]


def _unpack_last(b, nbits: int, count: int, dtype):
    """int64 bytes (..., n) → (..., count) values of ``dtype``, each row of
    the last axis on its own; bytes past n read as 0."""
    gv, gb = group_shape(nbits)
    groups = -(-count // gv)
    need = groups * gb
    b = F.pad(b[..., :need], (0, max(need - b.shape[-1], 0)))
    b = b.view(*b.shape[:-1], groups, gb)
    mask = (1 << nbits) - 1
    cols = []
    for pairs in unpack_pairs(nbits):
        acc = torch.zeros_like(b[..., 0])
        for k, sh in pairs:
            acc = acc | _shl(b[..., k], -sh)
        cols.append(acc & mask)
    out = torch.stack(cols, dim=-1).flatten(-2)[..., :count]
    if dtype == torch.int32:   # uint32 bit patterns: wrap the top half
        out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(dtype)


def pack_uint(vals, nbits: int):
    """``vals`` (any shape, uint8 or int32 holding uint32 bit patterns,
    only the low ``nbits`` bits are kept) → ceil(count·nbits/8) uint8
    bytes, MSB first (slot 0 lands in bit 7 of byte 0, as
    ``np.packbits``), the last byte zero-padded."""
    return _pack_last(vals.reshape(-1).to(torch.int64) & ((1 << nbits) - 1),
                      nbits)


def unpack_uint(buf, nbits: int, count: int, dtype=torch.int32):
    """Inverse of :func:`pack_uint`: read ``count`` values of ``nbits``
    from the uint8 stream ``buf`` (missing trailing bytes read as 0).
    ``dtype``: int32 (uint32 bit patterns) or, for nbits ≤ 8, uint8."""
    return _unpack_last(buf.reshape(-1).to(torch.int64), nbits, count,
                        dtype)


def pack_uint_rows(vals, nbits: int, out, col: int = 0):
    """The rows kernel's contract: row r of ``vals`` (c, count), packed as
    :func:`pack_uint` packs it, written to ``out[r, col:col + nbytes]`` of
    the (c, W) uint8 block ``out`` IN PLACE; returns ``out``. Float32
    totals (``nbits=1``) pack their predicate ``vals >= 0`` (-0.0 → 1,
    NaN → 0): the sign codec's ``pack_uint((flat >= 0).to(uint8), 1)``."""
    if vals.dtype == torch.float32:
        if nbits != 1:
            raise ValueError("float32 totals pack at nbits=1")
        vals = (vals >= 0).to(torch.uint8)
    packed = _pack_last(vals.to(torch.int64) & ((1 << nbits) - 1), nbits)
    out[:, col:col + packed.shape[-1]] = packed
    return out


def unpack_uint_rows(buf, col: int, nbits: int, count: int,
                     dtype=torch.int32, *, scale_col=None,
                     scale_block: int = 0):
    """Inverse of :func:`pack_uint_rows`: ``count`` values of each row's
    stream at ``buf[r, col:]`` → (c, count). With ``dtype=float32``
    (``nbits=1``), the sign codec's decode: ``scale_r · (bits·2 − 1)``, the
    row's fp32 scale read from ``buf[r, scale_col:scale_col + 4]`` (per
    block of ``scale_block`` values, when it is > 0)."""
    nbytes = (count * nbits + 7) // 8
    raw = buf[:, col:col + nbytes].to(torch.int64)
    if dtype != torch.float32:
        return _unpack_last(raw, nbits, count, dtype)
    if nbits != 1:
        raise ValueError("scaled signs unpack at nbits=1")
    sgn = _unpack_last(raw, 1, count, torch.uint8).float() * 2.0 - 1.0
    nsc = 1 if scale_block <= 0 else -(-count // scale_block)
    scales = buf[:, scale_col:scale_col + 4 * nsc].clone(
        memory_format=torch.contiguous_format).view(torch.float32)
    if scale_block <= 0:
        return scales * sgn
    return torch.repeat_interleave(scales, scale_block, dim=1)[:, :count] * sgn


def div_rn(a, s):
    """``a / s`` for a Python number ``s``, correctly rounded on any device.
    PyTorch on CUDA divides by a Python scalar as a multiply by its
    reciprocal, which can differ in the last bit from the true quotient that
    JAX and the CUDA kernels compute; a 0-d tensor divisor is a true
    division. The divisor is filled on the device (``torch.tensor`` would
    copy it from the host and wait for the device's queue)."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def sqrt_rn(a):
    """Correctly rounded fp32 sqrt on any device. PyTorch's vectorized CPU
    sqrt is not always correctly rounded; the fp64 sqrt rounded to fp32 is
    (double rounding is innocuous for sqrt at these precisions), and it is
    what the CUDA kernel's ``__fsqrt_rn`` computes."""
    return torch.sqrt(a.double()).float()


def fedams_update_ref(x, m, v, vhat, delta, *, eta: float, beta1: float,
                      beta2: float, eps: float, option: int = 1):
    """Fused FedAMS server update on flat fp32 vectors; the op order of
    ``repro.core.server_opt._server_update_f32`` (a true division, and
    ``(1-β₂)·(Δ·Δ)``)."""
    m2 = beta1 * m + (1 - beta1) * delta
    v2 = beta2 * v + (1 - beta2) * (delta * delta)
    if option == 1:
        vh2 = torch.maximum(vhat, v2).clamp_min(eps)
        x2 = x + eta * m2 / sqrt_rn(vh2)
    else:
        vh2 = torch.maximum(vhat, v2)
        x2 = x + eta * m2 / (sqrt_rn(vh2) + eps)
    return x2, m2, v2, vh2


def dequant(q, scale):
    """int8-blockscale → fp32: ``q · scale[block]`` over (nb·block,)."""
    nb = scale.shape[0]
    return (q.float().view(nb, -1) * scale[:, None]).reshape(-1)


def requant(a, nb: int):
    """fp32 (nb·block,) → ``(q, scale)``: ``scale = max(max|a|/127, 1e-30)``
    per block, ``q = clip(round(a/scale), ±127)`` (round half to even)."""
    ab = a.view(nb, -1)
    scale = div_rn(ab.abs().amax(dim=1), 127.0).clamp_min(1e-30)
    q = torch.round(ab / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(-1), scale


def scatter_mean_padded(vals, idx, N: int, n_div):
    """Client-major scatter-mean of ``(vals, idx)`` (n, ...) into a fresh
    (N,) fp32 vector. Within one client the indices are distinct, so each
    ``index_add_`` adds at most one value per coordinate and collisions
    across clients accumulate in client order — the JAX scatter's order."""
    acc = torch.zeros(N, dtype=torch.float32, device=vals.device)
    for j in range(vals.shape[0]):
        acc.index_add_(0, idx[j].reshape(-1).long(), vals[j].reshape(-1))
    return div_rn(acc, n_div)


def fedams_ingest_ref(x, m, v, vhat, vals, idx, v_scale=None, vh_scale=None,
                      *, n_div, eta: float, beta1: float, beta2: float,
                      eps: float, option: int = 1, block: int = 2048,
                      state_dtype: str = "float32"):
    """One-pass sparse ingest, the contract of the CUDA ``fedams_ingest``.

    ``x``/``m``: (d,) fp32 with ``nb = ceil(d/block)``; ``v``/``vhat``: (d,)
    fp32 or bf16, or for int8 the (nb·block,) payload with ``v_scale``/
    ``vh_scale`` (nb,) fp32; ``vals``/``idx``: (n, nb, k) fp32/int32 global
    selections. The pass runs over the zero-padded (nb·block,) domain, as
    ``repro.core.server_opt.server_ingest`` does. Returns ``(x, m, v,
    vhat)`` with x/m (d,) and state in storage form, plus the new scales for
    int8."""
    n, nb, k = vals.shape
    N = nb * block
    d = x.shape[0]
    pad = lambda a: F.pad(a, (0, N - a.shape[0]))
    # an index outside the padded domain (a rejected payload's flipped
    # index, zero-valued) adds nothing: the kernel drops it with every entry
    # outside its block
    safe = torch.where((idx >= 0) & (idx < N), idx, N)
    dm = scatter_mean_padded(vals, safe, N + 1, n_div)[:N]
    if state_dtype == "int8":
        vv, vh = dequant(v, v_scale), dequant(vhat, vh_scale)
    else:
        vv, vh = pad(v.float()), pad(vhat.float())
    x2, m2, v2, vh2 = fedams_update_ref(pad(x), pad(m), vv, vh, dm, eta=eta,
                                        beta1=beta1, beta2=beta2, eps=eps,
                                        option=option)
    x2, m2 = x2[:d], m2[:d]
    if state_dtype == "int8":
        qv, sv = requant(v2, nb)
        qvh, svh = requant(vh2, nb)
        return x2, m2, qv, qvh, sv, svh
    dt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    return x2, m2, v2[:d].to(dt), vh2[:d].to(dt)


#: the inputs on which a fused ingest kernel can go wrong, as ``(name, d,
#: block, n, k, kind)`` for :func:`ingest_case`: ragged d around one block
#: and at every d mod 4 near the main path's 704,266; blocks of 128 to 4096
#: (4096: more than one 2048-element round a CTA); one client and 64; k of
#: 1, 33 and the whole block (more entries than one staging pass holds);
#: every client on the same coordinates; an int8 block of all-zero moments;
#: a NaN delta; state at an odd offset from an aligned base
INGEST_HARD_CASES = (
    ("main path", 704266, 2048, 10, 32, ""),
    ("d = 1 mod 4", 704265, 2048, 10, 32, ""),
    ("d = 3 mod 4", 704267, 2048, 10, 32, ""),
    ("d = block - 1", 2047, 2048, 4, 32, ""),
    ("d = block", 2048, 2048, 4, 32, ""),
    ("d = block + 1", 2049, 2048, 4, 32, ""),
    ("block 128", 1000, 128, 4, 33, ""),
    ("block 384", 5000, 384, 4, 33, ""),
    ("block 4096", 20000, 4096, 4, 33, ""),
    ("n = 1", 5000, 2048, 1, 32, ""),
    ("n = 64", 5000, 2048, 64, 32, ""),
    ("k = 1", 5000, 2048, 4, 1, ""),
    ("k = block", 5000, 2048, 4, 2048, ""),
    ("k = block = 4096", 9000, 4096, 3, 4096, ""),
    ("n = 64, k = block = 128", 1000, 128, 64, 128, ""),
    ("all clients collide", 5000, 2048, 10, 32, "collide"),
    ("all 64 clients collide, k = block", 1000, 128, 64, 128, "collide"),
    ("int8 block of zeros", 5000, 2048, 4, 32, "zero block"),
    ("NaN delta", 5000, 2048, 4, 32, "nan"),
    ("state at an offset", 704266, 2048, 10, 32, "offset"),
    ("state at an offset, block 384", 5000, 384, 4, 33, "offset"),
)


def ingest_case(d: int, block: int, n: int, k: int, state_dtype: str,
                kind: str = "", seed: int = 0, device="cpu"):
    """The arguments ``(x, m, v, vhat, vals, idx)`` (int8: and ``v_scale,
    vh_scale``) of :func:`fedams_ingest_ref` for one case, from a numpy
    seed: each client picks k distinct positions of each padded block.
    ``kind``: ``"collide"`` — every client picks the same positions, client
    j adding ``(1e8, 1, -1e8, 1)[(j + t) % 4]`` at its t-th, so any order
    but client-major changes the sums; ``"zero block"`` — block 1 gets zero
    deltas and zero moments (int8: its new scales are 1e-30 where the max
    is 0); ``"nan"`` — a diverged client's NaNs; ``"offset"`` — x, m, v and
    vhat are contiguous views one element past an aligned base."""
    r = np.random.default_rng(seed)
    nb = -(-d // block)
    N = nb * block
    keys = r.random((1 if kind == "collide" else n, nb, block))
    pos = np.argpartition(keys, k - 1, axis=-1)[..., :k]
    idx = np.broadcast_to(pos + (np.arange(nb) * block)[:, None], (n, nb, k))
    if kind == "collide":
        seq = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
        vals = seq[(np.arange(n)[:, None, None] + np.arange(k)) % 4]
        vals = np.broadcast_to(vals, (n, nb, k))
    else:
        vals = r.normal(size=(n, nb, k)).astype(np.float32) * 0.05
    vals = np.array(vals, np.float32)
    x = r.normal(size=d).astype(np.float32)
    m = (r.normal(size=d) * 1e-3).astype(np.float32)
    if state_dtype == "int8":
        v = r.integers(0, 128, size=N).astype(np.int8)
        vh = r.integers(0, 128, size=N).astype(np.int8)
        s = (r.random(nb) * 1e-5 + 1e-7).astype(np.float32)
        scales = [s, (s * 1.5).astype(np.float32)]
    else:
        v = (r.random(d) * 1e-4).astype(np.float32)
        vh = (v + r.random(d) * 1e-4).astype(np.float32)
        scales = []
    if kind == "zero block" and nb > 1:
        vals[:, 1] = 0.0
        v[block:2 * block] = 0
        vh[block:2 * block] = 0
    if kind == "nan":
        vals[1, 0, :3] = np.nan
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (x, m, v, vh, vals, idx.astype(np.int32), *scales)]
    if state_dtype == "bfloat16":
        t[2], t[3] = t[2].bfloat16(), t[3].bfloat16()
    if kind == "offset":
        for i in range(4):
            base = torch.empty(t[i].numel() + 1, dtype=t[i].dtype,
                               device=device)
            base[1:].copy_(t[i])
            t[i] = base[1:]
    return tuple(t)
