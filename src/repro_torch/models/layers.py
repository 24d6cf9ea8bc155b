"""Shared building blocks of the model zoo: casts, RMSNorm, softcaps,
activations, rotary embeddings, the gated FFN, the vocab-sharded embedding
and cross entropy.

Counterpart of ``repro.models.layers``, written in the same per-rank
(manual-collective) style over the port's ``ParallelContext``: activations
are replicated over the "model" axis, weights arrive in their local shapes,
row-parallel matmuls finish with ``ctx.psum_model``. The port runs at
tp = 1, where every model-axis helper is the identity.

Numerics follow the reference: params live in fp32 and every matmul runs in
``cfg.dtype`` (bf16 by default); norms, RoPE angles, softcaps of logits and
the cross entropy run in fp32. ``jax.nn.gelu`` is the tanh approximation,
so ``activation("gelu")`` is ``F.gelu(..., approximate="tanh")``; masked
logits take -1e30, not -inf, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import params as pdefs

NEG_INF = -1e30


def span(name: str):
    """A ``torch.profiler`` range ``model.<name>`` over one layer of the
    forward (``embed``, ``attention``, ``ffn``, ``unembed``, ``xent``): a
    profiled step reports each layer's device time
    (``scripts/profile_round.py n``). Nearly free when no profiler runs."""
    return torch.profiler.record_function(f"model.{name}")


def cast(x, dtype: str):
    return x.to(getattr(torch, dtype))


def rms_norm(scale, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
    """Apply rotary embedding (half-split, not interleaved). x: (..., S, H,
    hd); positions: (..., S). Angles in fp32; the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq         # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated FFN (column/row parallel)
# ---------------------------------------------------------------------------


def ffn_defs(d_model: int, d_ff: int, act: str = "silu", gated: bool = True):
    defs = {
        "up": pdefs.linear(d_model, d_ff, shard="model"),
        "down": pdefs.linear(d_ff, d_model, shard="model", shard_dim=0),
    }
    if gated:
        defs["gate"] = pdefs.linear(d_model, d_ff, shard="model")
    return defs


def ffn_apply(p, x, ctx, act: str = "silu", dtype="bfloat16",
              psum: bool = True):
    with span("ffn"):
        up = x @ cast(p["up"], dtype)
        if "gate" in p:
            h = activation(x @ cast(p["gate"], dtype), act) * up
        else:
            h = activation(up, act)
        out = h @ cast(p["down"], dtype)
        return ctx.psum_model(out) if psum else out


# ---------------------------------------------------------------------------
# Vocab-sharded embedding + cross entropy
# ---------------------------------------------------------------------------


def embed_defs(vocab_padded: int, d_model: int):
    return {"table": pdefs.embedding(vocab_padded, d_model, shard="model")}


def embed_lookup(p, tokens, ctx, dtype="bfloat16"):
    """Gather rows of a vocab-sharded table: local gather + psum over
    model."""
    with span("embed"):
        table = p["table"]
        vloc = table.shape[0]
        lo = ctx.model_index() * vloc
        local_ids = tokens.long() - lo
        in_range = (local_ids >= 0) & (local_ids < vloc)
        out = table[local_ids.clamp(0, vloc - 1)]
        out = torch.where(in_range[..., None], out, 0.0)
        return cast(ctx.psum_model(out), dtype)


def unembed_logits(p, x, dtype="bfloat16"):
    """x @ table.T — logits sharded over vocab (no collective)."""
    return x @ cast(p["table"], dtype).T


def sharded_xent(logits_local, labels, ctx, true_vocab: Optional[int] = None,
                 mask=None):
    """Cross entropy with vocab-sharded logits.

    logits_local: (..., V/tp) fp32/bf16, labels: (...) int.
    Padded vocab entries (>= true_vocab) are excluded from the partition
    sum (they take -1e30). Returns the mean loss (a 0-d tensor)."""
    logits_local = logits_local.float()
    vloc = logits_local.shape[-1]
    lo = ctx.model_index() * vloc
    # with no padded column here the mask keeps every logit: skipping it
    # gives the same values and one (..., V) temporary fewer
    if true_vocab is not None and lo + vloc > true_vocab:
        col = lo + torch.arange(vloc, device=logits_local.device)
        logits_local = torch.where(col < true_vocab, logits_local, NEG_INF)
    local_max = logits_local.detach().amax(dim=-1)
    gmax = ctx.pmax_model(local_max)
    sumexp = torch.exp(logits_local - gmax[..., None]).sum(dim=-1)
    lse = torch.log(ctx.psum_model(sumexp)) + gmax
    local_ids = labels.long() - lo
    in_range = (local_ids >= 0) & (local_ids < vloc)
    safe = local_ids.clamp(0, vloc - 1)
    lab = logits_local.gather(-1, safe[..., None])[..., 0]
    lab = ctx.psum_model(torch.where(in_range, lab, 0.0))
    nll = lse - lab
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
