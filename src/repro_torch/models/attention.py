"""Softmax attention: GQA/MQA/MHA, sliding windows, softcaps, KV caches.

Counterpart of ``repro.models.attention``. Two execution paths share one
scoring core:

  * ``attn_train``  — full-sequence training/prefill, q-chunked to bound
                      the score-matrix working set; a windowed layer reads
                      a static band of keys per chunk;
  * ``attn_decode`` — one new token against a (possibly rolling) KV cache.

Sequence-sharded decode (long_500k: a context with a ``seq_axis``, each of
its ``seq_shards`` ranks holding a contiguous block of the cache's slots)
writes the new token on the rank whose block holds its slot and combines
the blocks' partial softmaxes by their log-sum-exp: ``pmax_seq`` of the
maxima, then ``psum_seq`` of the denominators and of the partial outputs.
Head layout is the padded layout of ``sharding.attn_dims``; kv heads are
expanded to q-head alignment with a gather so GQA/MQA/dense all run the
same einsums. Replicated kv heads (``kv_sharded`` False at tp > 1) take
the model axis's marker on their weights (``models.layers``).

Numerics follow the reference: scores in ``cfg.dtype``, then fp32, scaled
and softcapped; masked scores are -1e30 (a fully masked row gives uniform
weights, not NaN); the softmax weights are cast to ``v``'s dtype for the PV
product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import params as pdefs
from repro_torch.models.layers import NEG_INF, cast, rope, softcap
from repro_torch.sharding.rules import AttnDims


def attn_defs(d_model: int, dims: AttnDims, *, qkv_bias: bool = False):
    hd = dims.head_dim
    kv_shard = "model" if dims.kv_sharded else None
    defs = {
        "wq": pdefs.linear(d_model, dims.q_heads * hd, shard="model"),
        "wk": pdefs.linear(d_model, dims.kv_heads * hd, shard=kv_shard),
        "wv": pdefs.linear(d_model, dims.kv_heads * hd, shard=kv_shard),
        "wo": pdefs.linear(dims.q_heads * hd, d_model, shard="model",
                           shard_dim=0),
    }
    if qkv_bias:
        defs["bq"] = pdefs.bias(dims.q_heads * hd, shard="model")
        defs["bk"] = pdefs.bias(dims.kv_heads * hd, shard=kv_shard)
        defs["bv"] = pdefs.bias(dims.kv_heads * hd, shard=kv_shard)
    return defs


def _project_qkv(p, x, dims: AttnDims, ctx, dtype):
    """Project to q, k, v: (B, S, heads, hd) each."""
    B, S, _ = x.shape
    hd = dims.head_dim
    # replicated kv weights feed the sharded heads: their cotangents
    # arrive partial on each rank
    kv = (lambda w: w) if dims.kv_sharded else ctx.tp_copy
    q = x @ cast(p["wq"], dtype)
    k = x @ cast(kv(p["wk"]), dtype)
    v = x @ cast(kv(p["wv"]), dtype)
    if "bq" in p:
        q = q + cast(p["bq"], dtype)
        k = k + cast(kv(p["bk"]), dtype)
        v = v + cast(kv(p["bv"]), dtype)
    q = q.reshape(B, S, dims.q_local, hd)
    k = k.reshape(B, S, dims.kv_local, hd)
    v = v.reshape(B, S, dims.kv_local, hd)
    return q, k, v


def _kv_head_map(dims: AttnDims, ctx, device):
    """For each local q head, the LOCAL kv-head index holding its group."""
    mi = ctx.model_index()
    gq = mi * dims.q_local + torch.arange(dims.q_local, device=device)
    kv_global = gq // dims.group
    if dims.kv_sharded:
        return kv_global - mi * dims.kv_local
    return kv_global  # replicated: local index == global index


def expand_kv(k, dims: AttnDims, ctx):
    """(B,S,KVl,hd) -> (B,S,Hl,hd) by gathering each q head's kv head."""
    if dims.kv_local == dims.q_local:
        return k
    return torch.index_select(k, 2, _kv_head_map(dims, ctx, k.device))


def _scores_block(q, k, v, *, scale, cap, mask):
    """q:(B,Sq,H,hd) k,v:(B,Sk,H,hd) mask:(Sq,Sk) or (B,Sq,Sk) bool."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = softcap(s, cap)
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _mask(q_pos, k_pos, *, causal: bool, window: int):
    """q_pos:(Sq,) k_pos:(Sk,) -> (Sq,Sk) bool of allowed pairs."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def attention_core(q, k, v, *, causal: bool, window: int,
                   cap: Optional[float], chunk: int = 2048,
                   q_offset: int = 0):
    """Full-sequence attention, q-chunked when Sq > 2·chunk (then Sq must
    be a multiple of ``chunk``, as the reference asserts). A windowed
    layer's chunk i reads the static band of ``ceil(window/chunk)·chunk +
    chunk`` keys ending with it, its start clamped to ``[0, Sk − band]``:
    the keys outside the band are masked for every query of the chunk, so
    chunked equals unchunked. All heads local."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    dev = q.device
    if Sq <= 2 * chunk:
        mask = _mask(q_offset + torch.arange(Sq, device=dev),
                     torch.arange(Sk, device=dev), causal=causal,
                     window=window)
        return _scores_block(q, k, v, scale=scale, cap=cap, mask=mask)

    if Sq % chunk:
        raise ValueError(f"attention_core: Sq={Sq} is not a multiple of "
                         f"chunk={chunk}")
    band = ((window + chunk - 1) // chunk) * chunk + chunk
    out = []
    for i in range(Sq // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        qpos = q_offset + i * chunk + torch.arange(chunk, device=dev)
        if window > 0:
            # local attention: a static-size kv band per q chunk
            start = max(i * chunk - (band - chunk), 0)
            start = min(start, Sk - band) if Sk >= band else 0
            length = min(band, Sk)
            ki, vi = k[:, start:start + length], v[:, start:start + length]
            kpos = start + torch.arange(length, device=dev)
        else:
            ki, vi, kpos = k, v, torch.arange(Sk, device=dev)
        mask = _mask(qpos, kpos, causal=causal, window=window)
        out.append(_scores_block(qi, ki, vi, scale=scale, cap=cap,
                                 mask=mask))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Train / prefill
# ---------------------------------------------------------------------------


def attn_train(p, x, dims: AttnDims, ctx, *, causal: bool, window: int,
               cap: Optional[float], rope_theta: float, positions=None,
               dtype="bfloat16", chunk: int = 2048, return_cache_len: int = 0):
    """Full-sequence attention layer. Returns (out, cache_kv | None).

    When ``return_cache_len`` > 0 the (roped) k/v are also returned as a
    prefill cache of that length (rolling-trimmed for windowed layers).
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, dims, ctx, dtype)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    ke = expand_kv(k, dims, ctx)
    ve = expand_kv(v, dims, ctx)
    out = attention_core(q, ke, ve, causal=causal, window=window, cap=cap,
                         chunk=chunk)
    out = out.reshape(B, S, dims.q_local * dims.head_dim)
    out = ctx.psum_model(out @ cast(p["wo"], dtype))
    cache = None
    if return_cache_len:
        C = return_cache_len
        if S >= C:
            # roll so that slot j holds position p with p % C == j
            shift = (S - C) % C
            kc = torch.roll(k[:, S - C:], shifts=shift, dims=1)
            vc = torch.roll(v[:, S - C:], shifts=shift, dims=1)
        else:
            pad = (0, 0, 0, 0, 0, C - S)
            kc = torch.nn.functional.pad(k, pad)
            vc = torch.nn.functional.pad(v, pad)
        cache = (kc, vc)
    return out, cache


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, C, KVl, hd)   C = window or max context
    v: torch.Tensor


def device_pos(pos, device):
    """The decode position as a 0-d int32 tensor on ``device``: a tensor
    is taken as it is (the decode programs keep theirs on the device), an
    int is filled in there. Every decode computes from it alike, with no
    host read: the slot it writes, the masks, the rotary angle."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((), pos, dtype=torch.int32, device=device)


def _cache_write(c, x, slot, inplace: bool = False):
    """The cache ``c`` with ``x`` (B, 1, ...) in ``slot`` (a 0-d int
    tensor) of dim 1: ``c`` itself written in place with ``inplace``, else
    a copy of ``c`` alone (``slice_scatter`` copies the whole storage of a
    view, and a layer's cache is a view of the stack's (n_groups, ...)
    one). One ``index_copy_`` at a device index, the reference's
    ``dynamic_update_slice``."""
    out = c if inplace else c.clone()
    return out.index_copy_(1, slot.reshape(1).long(), x.to(c.dtype))


def _write_slot(cache, new, gslot, total_len: int, ctx, kind,
                inplace: bool = False):
    """``cache`` (a NamedTuple of (B, C, ...) leaves) with ``new``'s
    leaves written at the global slot ``gslot`` (a 0-d int tensor; in
    place with ``inplace``), and the global slot ids of this rank's slots.
    On a sequence-sharded cache every rank writes one slot, its local slot
    clamped into its block ``[lo, lo + Cl)``: the new token where the
    block holds ``gslot``, else that slot's own contents (the reference's
    ``where(here, updated, cache)``, on the one slot)."""
    if not ctx.seq_axis:
        return (kind(*(_cache_write(c, x, gslot, inplace)
                       for c, x in zip(cache, new))),
                torch.arange(total_len, device=cache[0].device))
    Cl = cache[0].shape[1]
    lo = ctx.seq_index() * Cl
    hit = (gslot >= lo) & (gslot < lo + Cl)
    local = (gslot - lo).clamp(0, Cl - 1)
    at = local.reshape(1).long()
    cache = kind(*(_cache_write(
        c, torch.where(hit, x.to(c.dtype), c.index_select(1, at)), local,
        inplace) for c, x in zip(cache, new)))
    return cache, lo + torch.arange(Cl, device=cache[0].device)


def softmax_combine(s, vals, eq: str, ctx):
    """``einsum(eq, softmax(s), vals)`` over the last dim of the fp32
    scores ``s`` (B, H, 1, C), the weights cast to ``vals``' dtype. With a
    sequence axis each rank holds a block of the keys: the blocks combine
    by their log-sum-exp (the global max by ``pmax_seq``, the denominators
    and the unnormalised outputs by ``psum_seq``)."""
    if not ctx.seq_axis:
        w = torch.softmax(s, dim=-1)
        return torch.einsum(eq, w.to(vals.dtype), vals)
    m = ctx.pmax_seq(s.amax(dim=-1))                     # (B,H,1)
    w = torch.exp(s - m[..., None])
    denom = ctx.psum_seq(w.sum(dim=-1))                  # (B,H,1)
    part = ctx.psum_seq(torch.einsum(eq, w.to(vals.dtype), vals))
    return part / denom.permute(0, 2, 1)[..., None]


def attn_decode(p, x, cache: KVCache, pos, dims: AttnDims, ctx, *,
                window: int, cap: Optional[float], rope_theta: float,
                total_len: int, dtype="bfloat16", inplace: bool = False):
    """One-token decode. x: (B,1,d); pos: the current position (an int or
    a 0-d int tensor: :func:`device_pos`). ``total_len`` is the global
    cache length C (a sequence-sharded cache holds C / seq_shards slots a
    rank). Returns (out (B,1,d), new_cache); the input cache is not
    modified, unless ``inplace``: then the new token is written into it
    and it is the new cache."""
    B = x.shape[0]
    hd = dims.head_dim
    pos = device_pos(pos, x.device)
    q, k, v = _project_qkv(p, x, dims, ctx, dtype)
    posv = pos.reshape(1, 1).expand(B, 1)
    q = rope(q, posv, rope_theta)
    k = rope(k, posv, rope_theta)
    gslot = pos % total_len
    new_cache, slot_ids = _write_slot(cache, (k, v), gslot, total_len, ctx,
                                      KVCache, inplace)

    ke = expand_kv(new_cache.k, dims, ctx)
    ve = expand_kv(new_cache.v, dims, ctx)
    # validity: slot filled (j <= pos or cache has wrapped) and inside window
    filled = (slot_ids <= pos) | (pos >= total_len)
    if window > 0 and total_len > window:
        # slot j holds position p_j = pos - ((gslot - j) % total_len)
        age = (gslot - slot_ids) % total_len
        filled &= age < window
    valid = filled[None, None, None, :]  # (1,1,1,C)

    s = torch.einsum("bqhd,bkhd->bhqk", q, ke).float() * hd ** -0.5
    s = softcap(s, cap)
    s = torch.where(valid, s, NEG_INF)
    out = softmax_combine(s, ve, "bhqk,bkhd->bqhd", ctx)
    out = cast(out.reshape(B, 1, dims.q_local * hd), dtype)
    out = ctx.psum_model(out @ cast(p["wo"], dtype))
    return out, new_cache
