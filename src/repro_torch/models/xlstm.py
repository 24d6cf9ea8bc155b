"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

Counterpart of ``repro.models.xlstm``. The mLSTM runs in two equivalent
forms:

  * ``mlstm_train`` — parallel (quadratic) for train and prefill: the decay
    matrix D_ij built from the cumulative log forget gates, q-chunked as
    attention is (``max(S // chunk, 1)`` chunks of equal length; a length
    they do not tile is refused, as the reference's reshape refuses it);
  * ``mlstm_train_chunkwise`` — the chunkwise-recurrent O(S·c) form (a
    stabilized (C, n, m) state carried across chunks of ``chunk``; S must
    be a multiple of it);
  * ``mlstm_decode`` — the stabilized recurrent step.

The sLSTM steps sequentially over the sequence in fp32 (a Python loop of
the reference's ``lax.scan``), its recurrence block-diagonal over the
heads, and then runs its FFN: ``ffn_defs``/``ffn_apply`` with their
defaults (a gated silu), not the config's activation, as the reference.

Sharding as in the reference: the mLSTM's v, o and down projections shard
on the per-head value dim over "model" (C shards on the value axis, every
rank keeps all heads); q, k and the gates are replicated. The sLSTM core is
replicated and its FFN shards as any FFN. The replicated weights inside
these branches take ``ctx.tp_copy`` on the weight (``models.layers``' rule
for the model axis): their cotangents arrive partial on each rank.

``log_sigmoid`` is ``jax.nn.log_sigmoid``, ``-softplus(-x)`` with
softplus ``logaddexp(x, 0)``. Gates, decays and states run in fp32, the
projections in ``dtype`` (each matmul in the promoted dtype of its
operands, ``layers.promoted``); ``mlstm_decode`` forms k ⊗ v in the compute
dtype and casts it to the state's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import params as pdefs
from repro_torch.models.layers import (cast, ffn_apply, ffn_defs, mm,
                                       promoted, rms_norm)
from repro_torch.sharding.rules import pad_to

NEG_INF = -1e30


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, softplus
    ``logaddexp(x, 0)``."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def _ein(eq: str, *ops):
    return torch.einsum(eq, *promoted(*ops))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_defs(d_model: int, num_heads: int, x: XLSTMConfig):
    di = pad_to(int(d_model * x.mlstm_proj_factor), 128)
    dh = di // num_heads
    # v / o / down shard on the PER-HEAD value dim: every shard keeps all
    # heads, so the per-head decay matrix aligns with the replicated q/k
    return {
        "w_q": pdefs.linear(d_model, di),
        "w_k": pdefs.linear(d_model, di),
        "w_v": pdefs.ParamDef((d_model, num_heads, dh),
                              scale=d_model ** -0.5,
                              spec=(None, None, "model")),
        "w_i": pdefs.linear(d_model, num_heads),
        "w_f": pdefs.linear(d_model, num_heads),
        "w_o": pdefs.ParamDef((d_model, num_heads, dh),
                              scale=d_model ** -0.5,
                              spec=(None, None, "model")),
        "w_down": pdefs.ParamDef((num_heads, dh, d_model),
                                 scale=di ** -0.5,
                                 spec=(None, "model", None)),
    }


def _mlstm_qkvgates(p, x, num_heads, dtype, ctx):
    B, S, _ = x.shape
    di = p["w_q"].shape[1]
    dh = di // num_heads
    q = mm(x, ctx.tp_copy(p["w_q"]), dtype).reshape(B, S, num_heads, dh)
    k = mm(x, ctx.tp_copy(p["w_k"]), dtype).reshape(B, S, num_heads, dh)
    v = _ein("bsd,dhv->bshv", x, cast(p["w_v"], dtype))
    log_i = mm(x, ctx.tp_copy(p["w_i"]), dtype).float()       # (B,S,nh)
    log_f = log_sigmoid(mm(x, ctx.tp_copy(p["w_f"]), dtype).float())
    return q, k, v, log_i, log_f, dh


def _mlstm_out(p, x, h, dtype, ctx):
    """The output gate and the down projection (row-parallel: psum)."""
    o = torch.sigmoid(_ein("bsd,dhv->bshv", x, cast(p["w_o"], dtype)))
    out = _ein("bshv,hvd->bsd", cast(h, dtype) * o, cast(p["w_down"], dtype))
    return ctx.psum_model(out)


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, nh, dh_k, dh_v_local) fp32
    n: torch.Tensor   # (B, nh, dh_k)
    m: torch.Tensor   # (B, nh)


def mlstm_train(p, x, num_heads: int, ctx, dtype="bfloat16",
                chunk: int = 2048, return_state: bool = False):
    """Parallel (quadratic) stabilized mLSTM. x: (B,S,d) -> (B,S,d) [,
    the final MLSTMState]."""
    B, S, d = x.shape
    n_chunks = max(S // chunk, 1)
    cs = S // n_chunks
    if n_chunks * cs != S:
        raise ValueError(f"mlstm_train: S={S} is not {n_chunks} chunks of "
                         f"{cs} (chunk={chunk})")
    q, k, v, log_i, log_f, dh = _mlstm_qkvgates(p, x, num_heads, dtype, ctx)
    F = torch.cumsum(log_f, dim=1)                                  # (B,S,nh)
    scale = dh ** -0.5
    jpos = torch.arange(S, device=x.device)
    hs = []
    for ci in range(n_chunks):
        qi = q[:, ci * cs:(ci + 1) * cs]
        Fi = F[:, ci * cs:(ci + 1) * cs]
        ipos = ci * cs + torch.arange(cs, device=x.device)
        # D_ij = F_i - F_j + log_i_j   (j <= i)
        D = Fi[:, :, None, :] - F[:, None, :, :] + log_i[:, None, :, :]
        mask = ipos[:, None] >= jpos[None, :]
        D = torch.where(mask[None, :, :, None], D, NEG_INF)
        m = D.amax(dim=2)                                           # (B,cs,nh)
        w = torch.exp(D - m[:, :, None, :])
        s = _ein("bihd,bjhd->bijh", qi, k).float() * scale
        sw = s * w
        eta = sw.sum(dim=2)                                         # (B,cs,nh)
        denom = torch.maximum(eta.abs(), torch.exp(-m))
        h = _ein("bijh,bjhv->bihv", sw.to(v.dtype), v)
        hs.append(h / denom[..., None].to(v.dtype))
    h = torch.cat(hs, dim=1)                           # (B,S,nh,dhv_local)
    out = _mlstm_out(p, x, h, dtype, ctx)
    if return_state:
        # final recurrent state: weights w_j = exp(F_S - F_j + log_i_j - m_S)
        rel = F[:, -1:, :] - F + log_i                              # (B,S,nh)
        m_fin = rel.amax(dim=1)                                     # (B,nh)
        wgt = torch.exp(rel - m_fin[:, None, :])
        k32, v32 = k.float(), v.float()
        C = torch.einsum("bsh,bshk,bshv->bhkv", wgt, k32, v32)
        n = torch.einsum("bsh,bshk->bhk", wgt, k32)
        return out, MLSTMState(C=C, n=n, m=m_fin)
    return out


def mlstm_train_chunkwise(p, x, num_heads: int, ctx, dtype="bfloat16",
                          chunk: int = 256, return_state: bool = False):
    """Chunkwise-recurrent mLSTM (the xLSTM paper's parallel-chunkwise
    form): the quadratic stabilized form within a chunk of ``chunk``, a
    stabilized (C, n, m) state across chunks; the numbers of
    :func:`mlstm_train` within rounding. S must be a multiple of the
    chunk (``min(chunk, S)``), as the reference asserts."""
    B, S, d = x.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"mlstm_train_chunkwise: S={S} is not a multiple "
                         f"of chunk={c}")
    q, k, v, log_i, log_f, dh = _mlstm_qkvgates(p, x, num_heads, dtype, ctx)
    dhv = v.shape[-1]
    scale = dh ** -0.5
    dev = x.device
    C = torch.zeros((B, num_heads, dh, dhv), dtype=torch.float32, device=dev)
    n = torch.zeros((B, num_heads, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, num_heads), -1e30, dtype=torch.float32, device=dev)
    mask = torch.arange(c, device=dev)[:, None] >= torch.arange(
        c, device=dev)[None, :]
    hs = []
    for j in range(S // c):
        sl = slice(j * c, (j + 1) * c)
        qi, ki, vi, li, lf = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], \
            log_f[:, sl]
        Fl = torch.cumsum(lf, dim=1)                                # (B,c,nh)
        Ftot = Fl[:, -1]                                            # (B,nh)
        # intra-chunk decay D_ij = Fl_i - Fl_j + li_j (j <= i)
        D = Fl[:, :, None, :] - Fl[:, None, :, :] + li[:, None, :, :]
        D = torch.where(mask[None, :, :, None], D, NEG_INF)
        m_intra = D.amax(dim=2)                                     # (B,c,nh)
        m_inter = Fl + m[:, None, :]                                # (B,c,nh)
        m_row = torch.maximum(m_intra, m_inter)
        w = torch.exp(D - m_row[:, :, None, :])
        s = _ein("bihd,bjhd->bijh", qi, ki).float() * scale
        sw = s * w
        num = _ein("bijh,bjhv->bihv", sw.to(vi.dtype), vi)
        eta = sw.sum(dim=2)                                         # (B,c,nh)
        # inter-chunk (prefix) contribution
        wi = torch.exp(m_inter - m_row)                             # (B,c,nh)
        q32 = qi.float() * scale
        num = num.float() + wi[..., None] * torch.einsum(
            "bihd,bhdv->bihv", q32, C)
        eta = eta + wi * torch.einsum("bihd,bhd->bih", q32, n)
        denom = torch.maximum(eta.abs(), torch.exp(-m_row))
        hs.append((num / denom[..., None]).to(vi.dtype))           # (B,c,nh,dhv)
        # state update (stabilized)
        rel = Ftot[:, None, :] - Fl + li                            # (B,c,nh)
        m_new = torch.maximum(Ftot + m, rel.amax(dim=1))
        wk = torch.exp(rel - m_new[:, None, :])
        carry = torch.exp(Ftot + m - m_new)
        k32 = ki.float()
        C = carry[..., None, None] * C + torch.einsum(
            "bjh,bjhd,bjhv->bhdv", wk, k32, vi.float())
        n = carry[..., None] * n + torch.einsum("bjh,bjhd->bhd", wk, k32)
        m = m_new
    out = _mlstm_out(p, x, torch.cat(hs, dim=1), dtype, ctx)
    if return_state:
        return out, MLSTMState(C=C, n=n, m=m)
    return out


def mlstm_decode(p, x, state: MLSTMState, num_heads: int, ctx,
                 dtype="bfloat16"):
    """Stabilized recurrent step. x: (B,1,d) -> (out (B,1,d), state)."""
    q, k, v, log_i, log_f, dh = _mlstm_qkvgates(p, x, num_heads, dtype, ctx)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # (B,nh,dh)
    log_i, log_f = log_i[:, 0], log_f[:, 0]             # (B,nh)
    m_new = torch.maximum(log_f + state.m, log_i)
    fprime = torch.exp(log_f + state.m - m_new)
    iprime = torch.exp(log_i - m_new)
    kv = torch.mul(*promoted(k[..., :, None], v[..., None, :]))
    C = fprime[..., None, None] * state.C + \
        iprime[..., None, None] * kv.to(state.C.dtype)
    n = fprime[..., None] * state.n + iprime[..., None] * k.to(state.n.dtype)
    scale = dh ** -0.5
    hnum = torch.einsum("bhkv,bhk->bhv", C, q.to(C.dtype) * scale)
    eta = torch.einsum("bhk,bhk->bh", n, q.to(n.dtype) * scale)
    denom = torch.maximum(eta.abs(), torch.exp(-m_new))
    h = (hnum / denom[..., None])[:, None]             # (B,1,nh,dhv_local)
    return _mlstm_out(p, x, h, dtype, ctx), MLSTMState(C=C, n=n, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(d_model: int, num_heads: int, x: XLSTMConfig):
    dh = d_model // num_heads
    dff = pad_to(int(d_model * x.slstm_proj_factor), 128)
    return {
        "w_in": pdefs.linear(d_model, 4 * d_model),              # i,f,z,o
        # spec-less, as the reference's P(): no dim hosts a ZeRO state
        # shard (the stacked leaf's group dim can)
        "r": pdefs.ParamDef((4, num_heads, dh, dh), scale=dh ** -0.5,
                            spec=()),
        "b": pdefs.bias(4 * d_model),
        "norm": pdefs.norm_scale(d_model),
        "ffn": ffn_defs(d_model, dff),
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, d) fp32
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def _recurrent_mats(r):
    """The (4, nh, dh, dh) recurrent mats as (nh, dh, 4, dh), contiguous:
    the layout the per-step einsum contracts without copying them. Made
    once a sequence: the step saves this one tensor for the backward, not
    a copy of the mats a step (4 MB a step at xlstm-350m's widths)."""
    return r.float().permute(1, 2, 0, 3).contiguous()


def _slstm_step(rr, pre, st: SLSTMState, num_heads: int) -> SLSTMState:
    """pre: (B,4d) input preactivations; rr: the (nh,dh,4,dh) recurrent
    mats of :func:`_recurrent_mats` (the reference's ``bhk,ghkl->bghl``
    block-diagonal recurrence)."""
    B, d4 = pre.shape
    d = d4 // 4
    dh = d // num_heads
    hh = st.h.reshape(B, num_heads, dh)
    rec = torch.einsum("bhk,hkgl->bghl", hh, rr).reshape(B, 4, d)
    z = pre.reshape(B, 4, d) + rec
    it, ft, zt, ot = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
    lf = log_sigmoid(ft)
    m_new = torch.maximum(lf + st.m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lf + st.m - m_new)
    c = fp * st.c + ip * torch.tanh(zt)
    n = fp * st.n + ip
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(h=h, c=c, n=n, m=m_new)


def _slstm_pre(p, x, dtype, ctx):
    """The input preactivations (B,...,4d) in fp32."""
    return (mm(x, ctx.tp_copy(p["w_in"]), dtype)
            + cast(ctx.tp_copy(p["b"]), dtype)).float()


def _slstm_ffn(p, h, dtype, ctx):
    h = rms_norm(ctx.tp_copy(p["norm"]), h)
    return ffn_apply(p["ffn"], h, ctx, dtype=dtype)


def slstm_train(p, x, num_heads: int, ctx, dtype="bfloat16",
                return_state: bool = False):
    """Sequential sLSTM over the sequence. x: (B,S,d). Core replicated."""
    B, S, d = x.shape
    pre = _slstm_pre(p, x, dtype, ctx)
    z = pre.new_zeros((B, d))
    st = SLSTMState(h=z, c=z, n=z, m=torch.full_like(z, -1e30))
    rr = _recurrent_mats(ctx.tp_copy(p["r"]))
    hs = []
    for i in range(S):
        st = _slstm_step(rr, pre[:, i], st, num_heads)
        hs.append(st.h)
    h = cast(torch.stack(hs, dim=1), dtype)
    out = _slstm_ffn(p, h, dtype, ctx)
    if return_state:
        return out, st
    return out


def slstm_decode(p, x, state: SLSTMState, num_heads: int, ctx,
                 dtype="bfloat16"):
    pre = _slstm_pre(p, x[:, 0], dtype, ctx)
    st = _slstm_step(_recurrent_mats(ctx.tp_copy(p["r"])), pre, state,
                     num_heads)
    return _slstm_ffn(p, cast(st.h, dtype)[:, None, :], dtype, ctx), st
