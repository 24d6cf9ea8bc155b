"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro.models.mla``:

  * ``mla_train``  — train/prefill: decompress the latent kv at every
                     position and run causal multi-head attention, one
                     q-chunk at a time (the reference's ``lax.scan`` is a
                     loop over the chunks here);
  * ``mla_decode`` — the *absorbed* one-token decode: ``W_uk`` is folded
                     into the query and ``W_uv`` into the output, so
                     attention runs against the compressed latent cache
                     (``c_kv``: kv_lora_rank values a position, and
                     ``k_rope``: rope_head_dim, shared by every head).

Sequence-sharded decode runs as attention's does
(``attention._write_slot``, ``attention.softmax_combine``): each rank of the
sequence axis holds a block of the latent cache's slots. The down
projections and their norms (``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm``,
``w_kr``) are replicated and feed the model-sharded heads, so they take the
model axis's marker on the weight (``models.layers``).

Numerics follow the reference: scores in the activations' dtype, then
fp32, scaled by ``(nope_head_dim + rope_head_dim)^-0.5`` and softcapped;
masked scores are -1e30; ``q_norm`` and ``kv_norm`` take ``rms_norm``'s
default eps; every matmul and einsum runs in the promoted dtype of its
operands (``layers.promoted``: fp32 activations on bf16 weights compute in
fp32). Decode reassociates the forward's products, so it equals the
decompressed forward only within a tolerance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models import params as pdefs
from repro_torch.models.attention import _write_slot, softmax_combine
from repro_torch.models.layers import (NEG_INF, cast, mm, promoted,
                                       rms_norm, rope, softcap)
from repro_torch.sharding.rules import pad_to


def mla_defs(d_model: int, num_heads: int, m: MLAConfig, tp: int):
    H = pad_to(num_heads, tp)
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "w_dq": pdefs.linear(d_model, m.q_lora_rank),
        "q_norm": pdefs.norm_scale(m.q_lora_rank),
        "w_uq": pdefs.linear(m.q_lora_rank, H * qh, shard="model"),
        "w_dkv": pdefs.linear(d_model, m.kv_lora_rank),
        "kv_norm": pdefs.norm_scale(m.kv_lora_rank),
        "w_kr": pdefs.linear(d_model, m.rope_head_dim),
        "w_uk": pdefs.linear(m.kv_lora_rank, H * m.nope_head_dim,
                             shard="model"),
        "w_uv": pdefs.linear(m.kv_lora_rank, H * m.v_head_dim,
                             shard="model"),
        "wo": pdefs.linear(H * m.v_head_dim, d_model, shard="model",
                           shard_dim=0),
    }


def _ein(eq: str, a, b):
    return torch.einsum(eq, *promoted(a, b))


def _queries(p, x, m: MLAConfig, Hl: int, positions, theta, dtype, ctx):
    B, S, _ = x.shape
    cq = rms_norm(ctx.tp_copy(p["q_norm"]),
                  mm(x, ctx.tp_copy(p["w_dq"]), dtype))
    q = mm(cq, p["w_uq"], dtype).reshape(B, S, Hl, -1)
    q_nope = q[..., :m.nope_head_dim]
    q_rope = rope(q[..., m.nope_head_dim:], positions, theta)
    return q_nope, q_rope


def _latents(p, x, m: MLAConfig, positions, theta, dtype, ctx):
    c_kv = rms_norm(ctx.tp_copy(p["kv_norm"]),
                    mm(x, ctx.tp_copy(p["w_dkv"]), dtype))
    k_rope = rope(mm(x, ctx.tp_copy(p["w_kr"]), dtype)[:, :, None, :],
                  positions, theta)
    return c_kv, k_rope[:, :, 0, :]


def _pack_cache(arr, C: int):
    """(B,S,...) -> (B,C,...) rolling layout: slot j holds position p with
    p % C == j (zero-padded when S < C)."""
    B, S = arr.shape[0], arr.shape[1]
    if S >= C:
        return torch.roll(arr[:, S - C:], shifts=(S - C) % C, dims=1)
    out = arr.new_zeros((B, C) + tuple(arr.shape[2:]))
    out[:, :S] = arr
    return out


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, C, kv_lora_rank)
    k_rope: torch.Tensor   # (B, C, rope_head_dim)


def _local_heads(p, m: MLAConfig) -> int:
    return p["w_uq"].shape[1] // (m.nope_head_dim + m.rope_head_dim)


def mla_train(p, x, m: MLAConfig, ctx, *, rope_theta: float,
              cap: Optional[float] = None, dtype="bfloat16",
              chunk: int = 2048, return_cache_len: int = 0):
    """Full-sequence causal MLA. x: (B,S,d) -> (B,S,d) [, MLACache].

    The queries run in ``max(S // chunk, 1)`` chunks of equal length, each
    against all S keys. A length the chunks do not tile is refused, as the
    reference's reshape refuses it."""
    B, S, _ = x.shape
    n_chunks = max(S // chunk, 1)
    cs = S // n_chunks
    if n_chunks * cs != S:
        raise ValueError(f"mla_train: S={S} is not {n_chunks} chunks of "
                         f"{cs} (chunk={chunk})")
    Hl = _local_heads(p, m)
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
    q_nope, q_rope = _queries(p, x, m, Hl, positions, rope_theta, dtype,
                              ctx)
    c_kv, k_rope = _latents(p, x, m, positions, rope_theta, dtype, ctx)
    k_nope = mm(c_kv, p["w_uk"], dtype).reshape(B, S, Hl, m.nope_head_dim)
    v = mm(c_kv, p["w_uv"], dtype).reshape(B, S, Hl, m.v_head_dim)

    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    kpos = torch.arange(S, device=dev)
    out = []
    for i in range(n_chunks):
        qn = q_nope[:, i * cs:(i + 1) * cs]
        qr = q_rope[:, i * cs:(i + 1) * cs]
        s = _ein("bqhd,bkhd->bhqk", qn, k_nope).float()
        s = s + _ein("bqhd,bkd->bhqk", qr, k_rope).float()
        s = softcap(s * scale, cap)
        qpos = i * cs + torch.arange(cs, device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out.append(_ein("bhqk,bkhd->bqhd", w.to(v.dtype), v))
    out = torch.cat(out, dim=1).reshape(B, S, Hl * m.v_head_dim)
    out = ctx.psum_model(mm(out, p["wo"], dtype))
    if return_cache_len:
        C = return_cache_len
        return out, MLACache(_pack_cache(c_kv, C), _pack_cache(k_rope, C))
    return out


def mla_decode(p, x, cache: MLACache, pos, m: MLAConfig, ctx, *,
               rope_theta: float, total_len: int,
               cap: Optional[float] = None, dtype="bfloat16"):
    """Absorbed one-token decode against the latent cache. x: (B,1,d);
    pos: the current position (an int); ``total_len`` is the cache length
    C (a sequence-sharded cache holds C / seq_shards slots a rank).
    Returns (out (B,1,d), new_cache); the input cache is not modified."""
    pos = int(pos)
    B = x.shape[0]
    dev = x.device
    Hl = _local_heads(p, m)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    q_nope, q_rope = _queries(p, x, m, Hl, posv, rope_theta, dtype, ctx)
    c_new, kr_new = _latents(p, x, m, posv, rope_theta, dtype, ctx)
    gslot = pos % total_len
    new_cache, slot_ids = _write_slot(cache, (c_new, kr_new), gslot,
                                      total_len, ctx, MLACache)

    # absorb W_uk into q:  q_lat[h] = q_nope[h] @ W_uk[:, h].T
    w_uk = cast(p["w_uk"], dtype).reshape(m.kv_lora_rank, Hl,
                                          m.nope_head_dim)
    q_lat = _ein("bqhd,chd->bqhc", q_nope, w_uk)        # (B,1,Hl,kv_lora)

    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = _ein("bqhc,bkc->bhqk", q_lat, new_cache.c_kv).float()
    s = s + _ein("bqhd,bkd->bhqk", q_rope, new_cache.k_rope).float()
    s = softcap(s * scale, cap)
    if pos < total_len:                 # slots past pos are still empty
        s = torch.where((slot_ids <= pos)[None, None, None, :], s, NEG_INF)
    lat = softmax_combine(s, new_cache.c_kv, "bhqk,bkc->bqhc", ctx)
    # absorb W_uv on the way out
    w_uv = cast(p["w_uv"], dtype).reshape(m.kv_lora_rank, Hl, m.v_head_dim)
    out = _ein("bqhc,chd->bqhd", cast(lat, dtype), w_uv).reshape(
        B, 1, Hl * m.v_head_dim)
    return ctx.psum_model(mm(out, p["wo"], dtype)), new_cache
