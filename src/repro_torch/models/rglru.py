"""Griffin recurrent block: gated temporal conv + RG-LRU (arXiv:2402.19427).

Counterpart of ``repro.models.rglru``. The recurrence
h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t) is elementwise over the
width, and ``rglru_train`` runs it over the sequence as the reference's
``lax.associative_scan`` does (:func:`associative_scan`: the same
recursion, vectorised over the sequence, so O(log S) launches and the
reference's order of products and sums).

As in the reference (DESIGN.md), the input and recurrence gates take
diagonal (per-channel) weights; the decay is ``exp(-c·softplus(λ)·r_t)``
with c = 8, and ``softplus`` is ``logaddexp(x, 0)``. The gates, the scan
and the state ``h`` run in fp32, the projections in ``dtype``; the causal
conv sums its taps left to right from Python's ``0 +``; the decode state
keeps ``h`` in fp32 and ``conv`` in the cache's dtype. The gates' sqrt is
``kernels.ref.sqrt_rn`` (correctly rounded on the CPU too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels.ref import sqrt_rn
from repro_torch.models import params as pdefs
from repro_torch.models.layers import activation, cast, mm


def rglru_defs(d_model: int, r: RGLRUConfig):
    w = r.lru_width or d_model
    vec = lambda: pdefs.ParamDef((w,), scale=1.0, spec=("model",))
    return {
        "w_gate": pdefs.linear(d_model, w, shard="model"),
        "w_x": pdefs.linear(d_model, w, shard="model"),
        "conv_k": pdefs.ParamDef((r.conv_width, w),
                                 scale=r.conv_width ** -0.5,
                                 spec=(None, "model")),
        "lam": vec(),
        "w_rg": vec(),
        "b_rg": pdefs.bias(w, shard="model"),
        "w_ig": vec(),
        "b_ig": pdefs.bias(w, shard="model"),
        "w_out": pdefs.linear(w, d_model, shard="model", shard_dim=0),
    }


def _causal_conv(x, kern, state=None):
    """Depthwise causal conv over seq. x:(B,S,w), kern:(cw,w).
    state: (B,cw-1,w) previous inputs for decode; returns (y, new_state)."""
    cw = kern.shape[0]
    B, S, w = x.shape
    if state is None:
        pad = x.new_zeros((B, cw - 1, w))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + S] * kern[cw - 1 - i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return y, new_state


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, xc, r: RGLRUConfig):
    """fp32 xc (B,S,w) -> the decay a and the gated input b."""
    rg = torch.sigmoid(xc * p["w_rg"] + p["b_rg"])
    ig = torch.sigmoid(xc * p["w_ig"] + p["b_ig"])
    log_a = -r.c_constant * _softplus(p["lam"]) * rg
    a = torch.exp(log_a)
    floor = torch.full((), 1e-12, dtype=log_a.dtype, device=log_a.device)
    b = sqrt_rn(torch.maximum(1.0 - torch.exp(2.0 * log_a), floor)) * (
        ig * xc)
    return a, b


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(a, b):
    """a at the even positions of dim 1, b at the odd ones, as JAX's
    ``_interleave``: each zero-padded, then added (so a -0.0 reads
    +0.0)."""
    shape = list(a.shape)
    shape[1] = a.shape[1] + b.shape[1]
    ap = a.new_zeros(shape)
    ap[:, 0::2] = a
    bp = b.new_zeros(shape)
    bp[:, 1::2] = b
    return ap + bp


def associative_scan(a, b):
    """``lax.associative_scan(combine, (a, b), axis=1)`` for the linear
    recurrence's ``combine``: JAX's recursion (``jax/_src/lax/control_flow/
    loops.py``, ``associative_scan._scan``), each level one vectorised
    combine of adjacent pairs. Returns the scanned (a, b); b is h."""

    def scan(elems):
        n = elems[0].shape[1]
        if n < 2:
            return elems
        reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                           [e[:, 1::2] for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = _combine([e[:, :-1] for e in odd],
                            [e[:, 2::2] for e in elems])
        else:
            even = _combine(odd, [e[:, 2::2] for e in elems])
        even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    return tuple(scan([a, b]))


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, w_local) fp32
    conv: torch.Tensor     # (B, cw-1, w_local)


def rglru_train(p, x, r: RGLRUConfig, ctx, dtype="bfloat16",
                return_state: bool = False):
    """x: (B,S,d) -> (B,S,d) [, final RGLRUState]."""
    gate = activation(mm(x, p["w_gate"], dtype), "gelu")
    xb = mm(x, p["w_x"], dtype)
    xc, conv_state = _causal_conv(xb, cast(p["conv_k"], dtype))
    a, b = _gates(p, xc.float(), r)
    _, h = associative_scan(a, b)
    out = ctx.psum_model(mm(gate * cast(h, dtype), p["w_out"], dtype))
    if return_state:
        return out, RGLRUState(h=h[:, -1], conv=conv_state)
    return out


def rglru_decode(p, x, state: RGLRUState, r: RGLRUConfig, ctx,
                 dtype="bfloat16"):
    """One-step decode. x: (B,1,d) -> (out (B,1,d), new state)."""
    gate = activation(mm(x, p["w_gate"], dtype), "gelu")
    xb = mm(x, p["w_x"], dtype)
    xc, conv_state = _causal_conv(xb, cast(p["conv_k"], dtype), state.conv)
    a, b = _gates(p, xc.float(), r)
    h = a[:, 0] * state.h + b[:, 0]
    out = mm(gate[:, 0] * cast(h, dtype), p["w_out"], dtype)
    out = ctx.psum_model(out)[:, None, :]
    return out, RGLRUState(h=h, conv=conv_state.to(state.conv.dtype))
