"""Mixture-of-Experts FFN: per-expert top-C gather dispatch.

Counterpart of ``repro.models.moe``, as plain functions on tensors:

  1. router logits -> global top-k gates per token, renormalised;
  2. each expert takes its top-C tokens by gate (C = capacity_factor ·
     T·k/E), the slots it cannot fill with tokens of gate 0 (``valid``
     False: computed, then multiplied by 0, as in the reference);
  3. the gathered tokens run the expert FFN batched over the experts;
  4. the weighted outputs are scatter-added back per token, then the
     shared experts and the switch-style aux loss.

Tokens beyond an expert's capacity are dropped, as in the reference. That
includes decode, where T = B: at qwen2-moe's widths C is 1 for B ≤ 12.

Numerics follow the reference: the weights are cast to ``dtype`` and the
activations are not, so the matmuls run in the promoted dtype (JAX's
rule); the router's logits and probs are fp32. Both top-ks break ties to
the lowest index as ``lax.top_k`` does, by a stable descending sort
(``torch.topk`` does not promise it). The gates' sum runs left to right,
as XLA's reduction does, so the dispatch is the reference's to the bit on
the same probs, on any device. The scatter-add runs in the experts'
output dtype, one ``index_add_`` an expert in expert order: each expert's
C token ids are distinct, so the order of the adds is XLA:CPU's sequential
scatter on every device.

Experts are padded to a multiple of tp with their logits pinned at -1e30
(qwen2-moe's 60 are 64 at tp = 8), and each rank of the model axis runs
its ``E / tp`` experts from ``model_index · E / tp``. The FFN takes no
branch-entry marker: the router is replicated and its aux loss reaches the
loss on every rank alike, so the tokens take the model axis's marker where
the experts and the shared FFN read them, and the probs where the dispatch
reads them (``models.layers``' rule, case 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import params as pdefs
from repro_torch.models.layers import (NEG_INF, activation, cast, ffn_apply,
                                       ffn_defs, promoted, softcap, span)
from repro_torch.sharding.rules import pad_to


def moe_defs(d_model: int, mo: MoEConfig, tp: int, act: str = "silu"):
    E = pad_to(mo.num_experts, tp)
    dfe = mo.d_ff_expert
    expert = lambda shape, fan_in: pdefs.ParamDef(
        shape, scale=fan_in ** -0.5, spec=("model", None, None))
    defs = {
        "router": pdefs.linear(d_model, E),
        # stacked expert weights, expert dim sharded over "model"
        "w_up": expert((E, d_model, dfe), d_model),
        "w_gate": expert((E, d_model, dfe), d_model),
        "w_down": expert((E, dfe, d_model), dfe),
    }
    if mo.num_shared_experts:
        dfs = mo.d_ff_shared or mo.num_shared_experts * dfe
        defs["shared"] = ffn_defs(d_model, dfs, act)
    return defs


def _mm(eq: str, a, w):
    """``torch.einsum`` in the promoted dtype of its operands."""
    return torch.einsum(eq, *promoted(a, w))


def router_probs(p, x, mo: MoEConfig, dtype):
    """(T, d) -> (T, E) fp32 softmax probs with padded experts masked
    out."""
    logits = _mm("td,de->te", x, cast(p["router"], dtype)).float()
    logits = softcap(logits, mo.router_softcap)
    E = logits.shape[-1]
    if E > mo.num_experts:
        pad = torch.arange(E, device=logits.device) >= mo.num_experts
        logits = torch.where(pad[None, :], NEG_INF, logits)
    return torch.softmax(logits, dim=-1)


class Dispatch(NamedTuple):
    """Which tokens each expert takes, from the router's probs."""
    gates: torch.Tensor     # (T, k) renormalised top-k probs
    top_idx: torch.Tensor   # (T, k) their experts
    sel: torch.Tensor       # (T, E) fp32: the gates at their experts, else 0
    C: int                  # capacity: slots an expert
    w_tok: torch.Tensor     # (E_loc, C) each slot's gate (0: an empty slot)
    tok_idx: torch.Tensor   # (E_loc, C) each slot's token
    valid: torch.Tensor     # (E_loc, C) w_tok > 0


def _top(x, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lowest
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(probs, mo: MoEConfig, e0: int = 0, E_loc: int = 0) -> Dispatch:
    """``moe_ffn``'s routing (``moe.py:70-84``) on (T, E) probs: global
    top-k gates renormalised, then the top-C tokens of each of the
    ``E_loc`` experts from ``e0`` (all of them by default)."""
    T, E = probs.shape
    E_loc = E_loc or E
    gates, top_idx = _top(probs, mo.top_k)
    total = gates[:, 0]
    for j in range(1, mo.top_k):          # left to right, as XLA sums
        total = total + gates[:, j]
    gates = gates / torch.clamp(total, min=1e-9)[:, None]
    sel = torch.zeros((T, E), dtype=torch.float32, device=probs.device)
    sel = sel.scatter(1, top_idx, gates)
    C = max(1, min(T, int(mo.capacity_factor * mo.top_k * T / E + 0.999)))
    w_tok, tok_idx = _top(sel[:, e0:e0 + E_loc].T, C)
    return Dispatch(gates, top_idx, sel, C, w_tok, tok_idx, w_tok > 0.0)


def moe_ffn(p, x, mo: MoEConfig, ctx, *, act: str = "silu",
            dtype="bfloat16"):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    with span("moe"):
        probs = router_probs(p, xf, mo, dtype)
        E_loc = p["w_up"].shape[0]                        # E / tp locally
        r = dispatch(ctx.tp_copy(probs), mo, ctx.model_index() * E_loc,
                     E_loc)
        xv = ctx.tp_copy(xf)                # read by the local experts
        xg = xv[r.tok_idx.reshape(-1)].reshape(E_loc, r.C, d)
        up = _mm("ecd,edf->ecf", xg, cast(p["w_up"], dtype))
        gt = _mm("ecd,edf->ecf", xg, cast(p["w_gate"], dtype))
        h = activation(gt, act) * up
        ye = _mm("ecf,efd->ecd", h, cast(p["w_down"], dtype))
        ye = ye * (r.w_tok * r.valid)[..., None].to(ye.dtype)
        with span("moe_scatter"):
            out = torch.zeros((T, d), dtype=ye.dtype, device=x.device)
            for e in range(E_loc):
                out.index_add_(0, r.tok_idx[e], ye[e])
        out = ctx.psum_model(out)
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xv, ctx, act=act,
                              dtype=dtype).to(out.dtype)
    # switch-style load balance aux loss (over true experts only)
    Et = mo.num_experts
    frac = (r.sel[:, :Et] > 0).float().mean(dim=0)     # fraction routed
    imp = probs[:, :Et].mean(dim=0)                     # mean router prob
    aux = mo.aux_loss_weight * Et * torch.sum(frac * imp)
    return out.reshape(B, S, d).to(x.dtype), aux


def moe_ffn_dense_ref(p, x, mo: MoEConfig, ctx, *, act: str = "silu",
                      dtype="float32"):
    """Dense reference (every expert on every token) for tests. tp = 1
    only."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs = router_probs(p, xf, mo, dtype)
    sel = dispatch(probs, mo).sel
    up = _mm("td,edf->etf", xf, cast(p["w_up"], dtype))
    gt = _mm("td,edf->etf", xf, cast(p["w_gate"], dtype))
    h = activation(gt, act) * up
    ye = _mm("etf,efd->etd", h, cast(p["w_down"], dtype))
    out = _mm("etd,te->td", ye, sel.to(ye.dtype))
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xf, ctx, act=act,
                              dtype=dtype).to(out.dtype)
    return out.reshape(B, S, d).to(x.dtype)
