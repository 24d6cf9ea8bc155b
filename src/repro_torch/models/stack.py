"""Layer-stack assembly: periodic layer groups with stacked parameters.

Counterpart of ``repro.models.stack``. :func:`plan_stack` finds the minimal
period of the per-layer (kind, window) descriptors; the group's params
carry a leading n_groups dim (``ParamDef.stacked``), as the reference's
``lax.scan`` wants them, and the port runs the groups as a Python loop that
indexes the stacked leaves. Leftover layers run as an unstacked tail. The
same defs tree (and so the same ravel order and checkpoint layout) as the
JAX package.

Every layer kind of the zoo is built: ``"attn"`` layers (softmax
attention, or MLA with ``cfg.mla``: ``models.mla``) with a dense FFN or,
with ``cfg.moe``, the MoE FFN (``models.moe``), whose aux loss
``stack_train`` sums in the reference's order (within a group, then across
groups, then the tail); ``"rglru"`` layers (``models.rglru``) with an
optional dense FFN; and the xLSTM's ``"mlstm"`` and ``"slstm"`` layers
(``models.xlstm``; ``cfg.xlstm.chunkwise`` trains the mLSTM chunkwise at
``cfg.xlstm.chunk_size``). Each branch's normed input takes the model
axis's entry marker (``ctx.tp_copy``) but the MoE FFN's, which marks its
own inputs (``models.layers``' rule). A ``seq_sharded`` cache shards the
full-length attention caches' slots over ``"data"``; the windowed ones
stay whole, and their decode runs without the sequence axis.

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
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as pdefs
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import ffn_apply, ffn_defs, rms_norm, span
from repro_torch.models.params import leaves_with_paths, tree_map, unflatten
from repro_torch.sharding.rules import AttnDims, attn_dims, pad_to


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


# ---------------------------------------------------------------------------
# Per-layer defs / apply
# ---------------------------------------------------------------------------


def layer_defs(cfg: ModelConfig, desc: LayerDesc, dims: AttnDims, tp: int):
    d = cfg.d_model
    defs = {"norm1": pdefs.norm_scale(d)}
    if desc.kind == "attn":
        if cfg.mla is not None:
            defs["mix"] = mla_mod.mla_defs(d, cfg.num_heads, cfg.mla, tp)
        else:
            defs["mix"] = attn.attn_defs(d, dims, qkv_bias=cfg.qkv_bias)
        defs["norm2"] = pdefs.norm_scale(d)
        if cfg.moe is not None:
            defs["mlp"] = moe_mod.moe_defs(d, cfg.moe, tp, cfg.act)
        elif cfg.d_ff > 0:
            defs["mlp"] = ffn_defs(d, cfg.d_ff, cfg.act, cfg.gated_ffn)
    elif desc.kind == "rglru":
        defs["mix"] = rglru_mod.rglru_defs(d, cfg.rglru)
        if cfg.d_ff > 0:
            defs["norm2"] = pdefs.norm_scale(d)
            defs["mlp"] = ffn_defs(d, cfg.d_ff, cfg.act, cfg.gated_ffn)
    elif desc.kind == "mlstm":
        defs["mix"] = xlstm_mod.mlstm_defs(d, cfg.num_heads, cfg.xlstm)
    elif desc.kind == "slstm":
        defs["mix"] = xlstm_mod.slstm_defs(d, cfg.num_heads, cfg.xlstm)
    else:
        raise ValueError(desc.kind)
    return defs


def _mlp(p, h2, cfg: ModelConfig, ctx):
    """The layer's FFN on the normed ``h2``: dense behind the entry marker,
    or MoE (which marks its own inputs) with its aux loss. Returns (out,
    aux or None)."""
    if cfg.moe is not None:
        return moe_mod.moe_ffn(p, h2, cfg.moe, ctx, act=cfg.act,
                               dtype=cfg.dtype)
    return ffn_apply(p, ctx.tp_copy(h2), ctx, act=cfg.act,
                     dtype=cfg.dtype), None


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _cache_len(desc: LayerDesc, max_len: int) -> int:
    return min(desc.window, max_len) if desc.window > 0 else max_len


def _rglru_ffn(p, x, cfg: ModelConfig, ctx):
    """The recurrent layer's optional FFN, residual added."""
    if "mlp" not in p:
        return x
    h2 = ctx.tp_copy(rms_norm(p["norm2"], x, cfg.norm_eps))
    return x + ffn_apply(p["mlp"], h2, ctx, act=cfg.act, dtype=cfg.dtype)


def _attn_mix(p, h, cfg: ModelConfig, desc: LayerDesc, dims: AttnDims, ctx,
              chunk: int, cache_len: int = 0):
    """The attention layer's mixer over a full sequence: MLA or softmax
    attention. Returns (out, the prefill cache dict or None)."""
    with span("attention"):
        if cfg.mla is not None:
            res = mla_mod.mla_train(p, h, cfg.mla, ctx,
                                    rope_theta=cfg.rope_theta,
                                    cap=cfg.attn_softcap, dtype=cfg.dtype,
                                    chunk=chunk, return_cache_len=cache_len)
            if not cache_len:
                return res, None
            out, c = res
            return out, {"c_kv": c.c_kv, "k_rope": c.k_rope}
        out, kv = attn.attn_train(p, h, dims, ctx, causal=not cfg.is_encoder,
                                  window=desc.window, cap=cfg.attn_softcap,
                                  rope_theta=cfg.rope_theta, dtype=cfg.dtype,
                                  chunk=chunk, return_cache_len=cache_len)
        return out, (None if kv is None else {"k": kv[0], "v": kv[1]})


def _mlstm(p, h, cfg: ModelConfig, ctx, chunk: int, return_state=False):
    """The mLSTM mixer over a full sequence: chunkwise at
    ``cfg.xlstm.chunk_size`` with ``cfg.xlstm.chunkwise``, else quadratic
    at ``chunk``."""
    with span("mlstm"):
        if cfg.xlstm.chunkwise:
            return xlstm_mod.mlstm_train_chunkwise(
                p, h, cfg.num_heads, ctx, cfg.dtype,
                chunk=cfg.xlstm.chunk_size, return_state=return_state)
        return xlstm_mod.mlstm_train(p, h, cfg.num_heads, ctx, cfg.dtype,
                                     chunk=chunk, return_state=return_state)


def _slstm(p, h, cfg: ModelConfig, ctx, return_state=False):
    with span("slstm"):
        return xlstm_mod.slstm_train(p, h, cfg.num_heads, ctx, cfg.dtype,
                                     return_state=return_state)


def layer_train(p, x, cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                ctx, chunk: int = 2048):
    """One layer, full sequence. Returns (x, aux_loss)."""
    h = ctx.tp_copy(rms_norm(p["norm1"], x, cfg.norm_eps))
    if desc.kind == "mlstm":
        return x + _mlstm(p["mix"], h, cfg, ctx, chunk), _zero_aux(x)
    if desc.kind == "slstm":
        return x + _slstm(p["mix"], h, cfg, ctx), _zero_aux(x)
    if desc.kind == "rglru":
        with span("rglru"):
            x = x + rglru_mod.rglru_train(p["mix"], h, cfg.rglru, ctx,
                                          cfg.dtype)
        return _rglru_ffn(p, x, cfg, ctx), _zero_aux(x)
    out, _ = _attn_mix(p["mix"], h, cfg, desc, dims, ctx, chunk)
    x = x + out
    out2, aux = _mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg,
                     ctx)
    return x + out2, (_zero_aux(x) if aux is None else aux)


def layer_prefill(p, x, cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                  ctx, max_len: int, chunk: int = 2048):
    """Full-sequence forward that also emits the layer's decode cache."""
    h = ctx.tp_copy(rms_norm(p["norm1"], x, cfg.norm_eps))
    if desc.kind == "mlstm":
        out, st = _mlstm(p["mix"], h, cfg, ctx, chunk, return_state=True)
        return x + out, {"C": st.C, "n": st.n, "m": st.m}
    if desc.kind == "slstm":
        out, st = _slstm(p["mix"], h, cfg, ctx, return_state=True)
        return x + out, {"h": st.h, "c": st.c, "n": st.n, "m": st.m}
    if desc.kind == "rglru":
        with span("rglru"):
            out, st = rglru_mod.rglru_train(p["mix"], h, cfg.rglru, ctx,
                                            cfg.dtype, return_state=True)
        return _rglru_ffn(p, x + out, cfg, ctx), {"h": st.h, "conv": st.conv}
    out, cache = _attn_mix(p["mix"], h, cfg, desc, dims, ctx, chunk,
                           _cache_len(desc, max_len))
    x = x + out
    out2, _ = _mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg,
                   ctx)
    return x + out2, cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def layer_cache_defs(cfg: ModelConfig, desc: LayerDesc, dims: AttnDims,
                     batch: int, max_len: int, *, seq_sharded: bool):
    """ParamDef tree describing one layer's decode state (GLOBAL shapes).
    The batch dim shards over ``"data"``, unless ``seq_sharded``: then a
    full-length attention cache shards its slots over ``"data"``."""
    d = cfg.d_model
    bspec = None if seq_sharded else "data"
    if desc.kind == "rglru":
        w = cfg.rglru.lru_width or d
        cw = cfg.rglru.conv_width
        return {
            "h": pdefs.ParamDef((batch, w), spec=(bspec, "model"),
                                dtype="float32"),
            "conv": pdefs.ParamDef((batch, cw - 1, w),
                                   spec=(bspec, None, "model"),
                                   dtype=cfg.dtype),
        }
    if desc.kind == "mlstm":
        di = pad_to(int(d * cfg.xlstm.mlstm_proj_factor), 128)
        nh = cfg.num_heads
        dh = di // nh
        return {
            "C": pdefs.ParamDef((batch, nh, dh, di // nh),
                                spec=(bspec, None, None, "model"),
                                dtype="float32"),
            "n": pdefs.ParamDef((batch, nh, dh), spec=(bspec, None, None),
                                dtype="float32"),
            "m": pdefs.ParamDef((batch, nh), spec=(bspec, None),
                                dtype="float32"),
        }
    if desc.kind == "slstm":
        return {k: pdefs.ParamDef((batch, d), spec=(bspec, None),
                                  dtype="float32")
                for k in ("h", "c", "n", "m")}
    C = _cache_len(desc, max_len)
    sspec = "data" if (seq_sharded and C == max_len) else None
    if cfg.mla is not None:
        m = cfg.mla
        spec = (bspec, sspec, None)
        return {
            "c_kv": pdefs.ParamDef((batch, C, m.kv_lora_rank), spec=spec,
                                   dtype=cfg.dtype),
            "k_rope": pdefs.ParamDef((batch, C, m.rope_head_dim), spec=spec,
                                     dtype=cfg.dtype),
        }
    kvspec = "model" if dims.kv_sharded else None
    kvh = dims.kv_heads if dims.kv_sharded else dims.kv_local
    spec = (bspec, sspec, kvspec, None)
    return {
        "k": pdefs.ParamDef((batch, C, kvh, dims.head_dim), spec=spec,
                            dtype=cfg.dtype),
        "v": pdefs.ParamDef((batch, C, kvh, dims.head_dim), spec=spec,
                            dtype=cfg.dtype),
    }


def init_cache_value(defs, device, axis_sizes=None):
    """Zero-initialized concrete cache on ``device`` (m-states get
    -1e30), each leaf in its shape on one rank of a mesh with
    ``axis_sizes`` (axis name → size; None: the global shapes)."""
    paths, leaves = [], []
    for path, dx in leaves_with_paths(defs):
        fill = -1e30 if path[-1] == "m" else 0.0
        paths.append(path)
        leaves.append(torch.full(pdefs.local_shape(dx, axis_sizes or {}),
                                 fill, dtype=getattr(torch, dx.dtype),
                                 device=device))
    return unflatten(paths, leaves)


def layer_decode(p, x, cache, pos, cfg: ModelConfig, desc: LayerDesc,
                 dims: AttnDims, ctx, max_len: int):
    """One-token decode through one layer. Returns (x, new_cache); an
    attention layer writes the new token into ``cache`` in place and
    returns it (:func:`stack_decode` hands it a copy)."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if desc.kind == "mlstm":
        with span("mlstm"):
            out, st = xlstm_mod.mlstm_decode(
                p["mix"], h, xlstm_mod.MLSTMState(cache["C"], cache["n"],
                                                  cache["m"]),
                cfg.num_heads, ctx, cfg.dtype)
        return x + out, {"C": st.C, "n": st.n, "m": st.m}
    if desc.kind == "slstm":
        with span("slstm"):
            out, st = xlstm_mod.slstm_decode(
                p["mix"], h, xlstm_mod.SLSTMState(cache["h"], cache["c"],
                                                  cache["n"], cache["m"]),
                cfg.num_heads, ctx, cfg.dtype)
        return x + out, {"h": st.h, "c": st.c, "n": st.n, "m": st.m}
    if desc.kind == "rglru":
        with span("rglru"):
            out, st = rglru_mod.rglru_decode(
                p["mix"], h, rglru_mod.RGLRUState(cache["h"], cache["conv"]),
                cfg.rglru, ctx, cfg.dtype)
        return _rglru_ffn(p, x + out, cfg, ctx), {"h": st.h, "conv": st.conv}
    C = _cache_len(desc, max_len)
    # a windowed layer's ring is whole on every rank of the sequence axis
    lctx = ctx if C == max_len else ctx.with_(seq_axis=None)
    with span("attention"):
        if cfg.mla is not None:
            out, nc = mla_mod.mla_decode(
                p["mix"], h, mla_mod.MLACache(cache["c_kv"], cache["k_rope"]),
                pos, cfg.mla, lctx, rope_theta=cfg.rope_theta, total_len=C,
                cap=cfg.attn_softcap, dtype=cfg.dtype, inplace=True)
            new_cache = {"c_kv": nc.c_kv, "k_rope": nc.k_rope}
        else:
            out, nc = attn.attn_decode(
                p["mix"], h, attn.KVCache(cache["k"], cache["v"]), pos, dims,
                lctx, window=desc.window, cap=cfg.attn_softcap,
                rope_theta=cfg.rope_theta, total_len=C, dtype=cfg.dtype,
                inplace=True)
            new_cache = {"k": nc.k, "v": nc.v}
    x = x + out
    out2, _ = _mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg,
                   ctx)
    return x + out2, new_cache


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
    """``fn`` checkpointed by ``policy`` (``"none"``, ``"dots"``,
    ``"full"``). No block draws a random number, so the recompute needs no
    saved generator state: ``preserve_rng_state=False``. With it the
    checkpoint would read the CUDA generator's state at each forward and
    set it at each recompute, calls a CUDA graph's capture may refuse (the
    mesh's captured round, remat "full"); the numbers are the same."""
    if policy == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return lambda *a: ckpt.checkpoint(fn, *a, **kw)


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


def _store(dst, src):
    """Put a layer's new cache leaf ``src`` in ``dst``, its place in the
    new caches, unless it is there already (an attention cache written in
    place)."""
    if src is not dst:
        dst.copy_(src)


def stack_prefill(p, x, cfg: ModelConfig, ctx, *, max_len: int,
                  chunk: int = 2048, into=None):
    """Full-sequence forward emitting decode caches. Returns (x, caches).
    ``into``: caches of the decode's shapes (a decode program's carry)
    that each layer's cache is written into as it is made, and that are
    returned; else the layers' caches are stacked anew."""
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, ctx.tp)
    per_group = []
    for g in range(n_groups):
        gp = _group(p["groups"], g)
        cs = {} if into is None else _group(into["groups"], g)
        for j, desc in enumerate(group):
            x, c = layer_prefill(gp[f"l{j}"], x, cfg, desc, dims, ctx,
                                 max_len, chunk)
            if into is None:
                cs[f"l{j}"] = c
            else:
                tree_map(_store, cs[f"l{j}"], c)
        per_group.append(cs)
    caches = into or {"groups": _stack_groups(per_group)}
    if tail:
        ct = caches.setdefault("tail", {})
        for j, desc in enumerate(tail):
            x, c = layer_prefill(p["tail"][f"t{j}"], x, cfg, desc, dims,
                                 ctx, max_len, chunk)
            if into is None:
                ct[f"t{j}"] = c
            else:
                tree_map(_store, ct[f"t{j}"], c)
    return x, caches


def stack_decode(p, x, caches, pos, cfg: ModelConfig, ctx, max_len: int,
                 *, inplace: bool = False):
    """One-token decode through the whole stack at ``pos`` (an int or a
    0-d int tensor). Returns (x, new_caches). The new caches are one copy
    of ``caches`` (which are not modified), each layer's entry written
    into it in place: the old and the new caches and no third copy, as the
    reference's scan holds its input and output stacks. With ``inplace``
    (a decode program's carry) ``caches`` themselves are written and
    returned: no copy."""
    group, n_groups, tail = plan_stack(cfg)
    dims = _dims(cfg, ctx.tp)
    new_caches = caches if inplace else tree_map(torch.clone, caches)
    for g in range(n_groups):
        gp, gc = _group(p["groups"], g), _group(new_caches["groups"], g)
        for j, desc in enumerate(group):
            x, nc = layer_decode(gp[f"l{j}"], x, gc[f"l{j}"], pos, cfg,
                                 desc, dims, ctx, max_len)
            tree_map(_store, gc[f"l{j}"], nc)
    for j, desc in enumerate(tail):
        lc = new_caches["tail"][f"t{j}"]
        x, nc = layer_decode(p["tail"][f"t{j}"], x, lc, pos, cfg, desc,
                             dims, ctx, max_len)
        tree_map(_store, lc, nc)
    return x, new_caches
