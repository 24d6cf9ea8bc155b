"""Layer-stack assembly: periodic layer groups with stacked parameters.

Counterpart of ``repro.models.stack``. :func:`plan_stack` finds the minimal
period of the per-layer (kind, window) descriptors; the group's params
carry a leading n_groups dim (``ParamDef.stacked``), as the reference's
``lax.scan`` wants them, and the port runs the groups as a Python loop that
indexes the stacked leaves. Leftover layers run as an unstacked tail. The
same defs tree (and so the same ravel order and checkpoint layout) as the
JAX package.

This slice ports the attention-only family: ``"attn"`` layers with a dense
FFN. MoE, MLA and the recurrent kinds raise ``NotImplementedError`` naming
their ROADMAP item (:func:`require_ported`).

``remat_policy`` is the reference's: ``"none"``; ``"full"`` recomputes a
group in the backward pass (``torch.utils.checkpoint``); ``"dots"`` saves
the matmul outputs and recomputes the rest (a selective checkpoint). The
numbers are the same for all three.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import params as pdefs
from repro_torch.models.layers import ffn_apply, ffn_defs, rms_norm, span
from repro_torch.models.params import leaves_with_paths, tree_map, unflatten
from repro_torch.sharding.rules import AttnDims, attn_dims


@dataclass(frozen=True)
class LayerDesc:
    kind: str      # attn | rglru | mlstm | slstm
    window: int    # 0 = global (attn only)


def plan_stack(cfg: ModelConfig) -> Tuple[Tuple[LayerDesc, ...], int,
                                          Tuple[LayerDesc, ...]]:
    """-> (group_pattern, n_groups, tail_layers)."""
    descs = [LayerDesc(k, w) for k, w in zip(cfg.layer_kinds,
                                             cfg.layer_windows)]
    L = len(descs)
    for p in range(1, L + 1):
        n = L // p
        if n == 0:
            continue
        if all(descs[i] == descs[i % p] for i in range(n * p)):
            return tuple(descs[:p]), n, tuple(descs[n * p:])
    return tuple(descs), 1, ()


#: what this slice does not build, and the ROADMAP item each waits for
UNPORTED = {
    "moe": "MoE layers (cfg.moe) wait for ROADMAP Queue 1 item 8b",
    "mla": "MLA attention (cfg.mla) waits for ROADMAP Queue 1 item 8c",
    "mtp": "the MTP head (cfg.mtp) waits for ROADMAP Queue 1 item 8c",
    "rglru": "RG-LRU layers ('rglru') wait for ROADMAP Queue 1 item 8d",
    "mlstm": "xLSTM layers ('mlstm') wait for ROADMAP Queue 1 item 8e",
    "slstm": "xLSTM layers ('slstm') wait for ROADMAP Queue 1 item 8e",
}


def require_ported(cfg: ModelConfig) -> None:
    """Refuse a config outside the attention-only family, naming every
    feature it needs that is not ported yet."""
    missing = [UNPORTED[f] for f in ("moe", "mla", "mtp")
               if getattr(cfg, f) is not None]
    missing += [UNPORTED[k] for k in sorted(set(cfg.layer_kinds))
                if k != "attn"]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch ports the attention-only family "
            f"(attn layers with a dense FFN); " + "; ".join(missing))


# ---------------------------------------------------------------------------
# Per-layer defs / apply
# ---------------------------------------------------------------------------


def layer_defs(cfg: ModelConfig, desc: LayerDesc, dims: AttnDims, tp: int):
    require_ported(cfg)
    d = cfg.d_model
    defs = {"norm1": pdefs.norm_scale(d),
            "mix": attn.attn_defs(d, dims, qkv_bias=cfg.qkv_bias),
            "norm2": pdefs.norm_scale(d)}
    if cfg.d_ff > 0:
        defs["mlp"] = ffn_defs(d, cfg.d_ff, cfg.act, cfg.gated_ffn)
    return defs


def layer_train(p, x, cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                ctx, chunk: int = 2048):
    """One layer, full sequence. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = ctx.tp_copy(rms_norm(p["norm1"], x, cfg.norm_eps))
    with span("attention"):
        out, _ = attn.attn_train(p["mix"], h, dims, ctx,
                                 causal=not cfg.is_encoder,
                                 window=desc.window, cap=cfg.attn_softcap,
                                 rope_theta=cfg.rope_theta, dtype=cfg.dtype,
                                 chunk=chunk)
    x = x + out
    h2 = ctx.tp_copy(rms_norm(p["norm2"], x, cfg.norm_eps))
    out2 = ffn_apply(p["mlp"], h2, ctx, act=cfg.act, dtype=cfg.dtype)
    return x + out2, aux


def _cache_len(desc: LayerDesc, max_len: int) -> int:
    return min(desc.window, max_len) if desc.window > 0 else max_len


def layer_prefill(p, x, cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                  ctx, max_len: int, chunk: int = 2048):
    """Full-sequence forward that also emits the layer's decode cache."""
    h = ctx.tp_copy(rms_norm(p["norm1"], x, cfg.norm_eps))
    with span("attention"):
        out, kv = attn.attn_train(
            p["mix"], h, dims, ctx, causal=not cfg.is_encoder,
            window=desc.window, cap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, dtype=cfg.dtype, chunk=chunk,
            return_cache_len=_cache_len(desc, max_len))
    x = x + out
    h2 = ctx.tp_copy(rms_norm(p["norm2"], x, cfg.norm_eps))
    out2 = ffn_apply(p["mlp"], h2, ctx, act=cfg.act, dtype=cfg.dtype)
    return x + out2, {"k": kv[0], "v": kv[1]}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def layer_cache_defs(cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                     batch: int, max_len: int, *, seq_sharded: bool):
    """ParamDef tree describing one layer's decode state (GLOBAL shapes)."""
    require_ported(cfg)
    if seq_sharded:
        raise NotImplementedError(
            "a sequence-sharded decode cache (long_500k over the data axis) "
            "is not ported: the port's ParallelContext has no seq_shards "
            "yet — ROADMAP Queue 1 item 8f")
    C = _cache_len(desc, max_len)
    kvspec = "model" if dims.kv_sharded else None
    kvh = dims.kv_heads if dims.kv_sharded else dims.kv_local
    spec = ("data", None, kvspec, None)
    return {
        "k": pdefs.ParamDef((batch, C, kvh, dims.head_dim), spec=spec,
                            dtype=cfg.dtype),
        "v": pdefs.ParamDef((batch, C, kvh, dims.head_dim), spec=spec,
                            dtype=cfg.dtype),
    }


def init_cache_value(defs, device):
    """Zero-initialized concrete cache on ``device`` (m-states get
    -1e30)."""
    paths, leaves = [], []
    for path, dx in leaves_with_paths(defs):
        fill = -1e30 if path[-1] == "m" else 0.0
        paths.append(path)
        leaves.append(torch.full(dx.shape, fill, dtype=getattr(torch, dx.dtype),
                                 device=device))
    return unflatten(paths, leaves)


def layer_decode(p, x, cache, pos, cfg: ModelConfig, desc: LayerDesc,
                 dims: AttnDims, ctx, max_len: int):
    """One-token decode through one layer. Returns (x, new_cache)."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    with span("attention"):
        out, nc = attn.attn_decode(
            p["mix"], h, attn.KVCache(cache["k"], cache["v"]), pos, dims,
            ctx, window=desc.window, cap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, total_len=_cache_len(desc, max_len),
            dtype=cfg.dtype)
    x = x + out
    h2 = ctx.tp_copy(rms_norm(p["norm2"], x, cfg.norm_eps))
    out2 = ffn_apply(p["mlp"], h2, ctx, act=cfg.act, dtype=cfg.dtype)
    return x + out2, {"k": nc.k, "v": nc.v}


# ---------------------------------------------------------------------------
# Stack defs / apply
# ---------------------------------------------------------------------------


def _dims(cfg: ModelConfig, tp: int) -> AttnDims:
    return attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     max(tp, 1))


def stack_defs(cfg: ModelConfig, tp: int):
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, tp)
    gdefs = {f"l{j}": layer_defs(cfg, desc, dims, tp)
             for j, desc in enumerate(group)}
    out = {"groups": pdefs.stack_defs(gdefs, n_groups)}
    if tail:
        out["tail"] = {f"t{j}": layer_defs(cfg, desc, dims, tp)
                       for j, desc in enumerate(tail)}
    return out


def stack_cache_defs(cfg: ModelConfig, tp: int, batch: int, max_len: int,
                     *, seq_sharded: bool):
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, tp)
    gdefs = {f"l{j}": layer_cache_defs(cfg, desc, dims, batch, max_len,
                                       seq_sharded=seq_sharded)
             for j, desc in enumerate(group)}
    out = {"groups": pdefs.stack_defs(gdefs, n_groups)}
    if tail:
        out["tail"] = {f"t{j}": layer_cache_defs(cfg, desc, dims, batch,
                                                 max_len,
                                                 seq_sharded=seq_sharded)
                       for j, desc in enumerate(tail)}
    return out


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep matmul outputs, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context_fn)
    if policy == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat_policy {policy!r}")


def _group(p, g: int):
    """Group ``g``'s params (or caches): the stacked leaves indexed."""
    return tree_map(lambda t: t[g], p)


def stack_train(p, x, cfg: ModelConfig, ctx, *, remat_policy: str = "full",
                chunk: int = 2048):
    """Run all layers over a full sequence. Returns (x, total_aux_loss)."""
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, ctx.tp)

    def group_fn(x, gp):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, desc in enumerate(group):
            x, a = layer_train(gp[f"l{j}"], x, cfg, desc, dims, ctx, chunk)
            aux = aux + a
        return x, aux

    gfn = _remat(group_fn, remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        x, a = gfn(x, _group(p["groups"], g))
        aux = aux + a
    for j, desc in enumerate(tail):
        x, a = layer_train(p["tail"][f"t{j}"], x, cfg, desc, dims, ctx, chunk)
        aux = aux + a
    return x, aux


def _stack_groups(per_group):
    """A list of per-group cache trees -> one tree with a leading group
    dim (what the reference's scan emits)."""
    return tree_map(lambda *ts: torch.stack(ts), *per_group)


def stack_prefill(p, x, cfg: ModelConfig, ctx, *, max_len: int,
                  chunk: int = 2048):
    """Full-sequence forward emitting decode caches. Returns (x, caches)."""
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, ctx.tp)
    per_group = []
    for g in range(n_groups):
        gp = _group(p["groups"], g)
        cs = {}
        for j, desc in enumerate(group):
            x, cs[f"l{j}"] = layer_prefill(gp[f"l{j}"], x, cfg, desc, dims,
                                           ctx, max_len, chunk)
        per_group.append(cs)
    caches = {"groups": _stack_groups(per_group)}
    if tail:
        ct = {}
        for j, desc in enumerate(tail):
            x, ct[f"t{j}"] = layer_prefill(p["tail"][f"t{j}"], x, cfg, desc,
                                           dims, ctx, max_len, chunk)
        caches["tail"] = ct
    return x, caches


def stack_decode(p, x, caches, pos, cfg: ModelConfig, ctx, max_len: int):
    """One-token decode through the whole stack. Returns (x, new_caches)."""
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, ctx.tp)
    per_group = []
    for g in range(n_groups):
        gp, gc = _group(p["groups"], g), _group(caches["groups"], g)
        ncs = {}
        for j, desc in enumerate(group):
            x, ncs[f"l{j}"] = layer_decode(gp[f"l{j}"], x, gc[f"l{j}"], pos,
                                           cfg, desc, dims, ctx, max_len)
        per_group.append(ncs)
    new_caches = {"groups": _stack_groups(per_group)}
    if tail:
        nt = {}
        for j, desc in enumerate(tail):
            x, nt[f"t{j}"] = layer_decode(p["tail"][f"t{j}"], x,
                                          caches["tail"][f"t{j}"], pos, cfg,
                                          desc, dims, ctx, max_len)
        new_caches["tail"] = nt
    return x, new_caches
