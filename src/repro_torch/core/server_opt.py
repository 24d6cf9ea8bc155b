"""Server-side optimizers: the paper's FedAMS family plus all baselines.

Counterpart of ``repro.core.server_opt``. The server treats the aggregated
client delta Δ̂_t as a pseudo-gradient and takes one adaptive step
(x ← x + η·m/√v̂; deltas already point downhill):

    fedavg     : x += η Δ
    fedadagrad : v += Δ²
    fedadam    : Adam(m, v)
    fedyogi    : Yogi variance update
    fedamsgrad : Option 2 — v̂=max(v̂,v),  x += η m/(√v̂+ε)
    fedams     : Option 1 — v̂=max(v̂,v,ε), x += η m/√v̂   (this paper)

The op order is ``_server_update_f32``'s (a true division, and
``(1-β₂)·(Δ·Δ)``), so m/v/v̂ are bitwise the JAX package's. The FedAMS
family (fedams, fedcams, fedamsgrad) runs through
:func:`repro_torch.kernels.ops.fedams_update`: the CUDA kernel on the card,
its plain twin on the CPU.

State lives on the flat (d,) vector. v/v̂ may be stored as bf16 or as
int8-blockscale (:class:`QuantState`, padded to the block domain); the
update math always runs in fp32. The one-pass fused ingest
(:func:`server_ingest`) consumes the compacted ``(vals, idx)`` client
selections directly.

The mesh keeps its state per leaf (nested dicts in the params' shapes):
:func:`server_update_tree` and :func:`server_ingest_tree` run the same
functions leaf by leaf.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import block_layout
from repro_torch.kernels import ops, ref
from repro_torch.models.params import tree_map, tree_unzip


class ServerState(NamedTuple):
    m: torch.Tensor      # (d,) fp32 momentum (zeros for fedavg)
    v: object           # (d,) fp32/bf16 second moment, or QuantState
    vhat: object        # max-stabilized second moment (same storage as v)
    t: torch.Tensor     # round counter (int32 scalar)


class QuantState(NamedTuple):
    """int8-blockscale storage for one flat second-moment vector: ``q`` is
    the (N,) int8 payload over the zero-padded block domain (N = nb·block)
    and ``scale`` the (nb,) fp32 per-block absmax scales — dequant is
    ``q * scale[block]``, requant ``scale = max(|v|)/127`` per block."""
    q: torch.Tensor
    scale: torch.Tensor


_is_quant = lambda x: isinstance(x, QuantState)

#: Why hierarchical rounds (``FedConfig.agg_groups > 1``) cannot fuse the
#: server ingest (the same text as the JAX package's).
FUSED_INGEST_GROUPS_DETAIL = (
    "; hierarchical aggregation (agg_groups > 1) is also ineligible — the "
    "group tier pre-merges selections into dense partials, leaving no "
    "compacted (vals, idx) stream for the one-pass ingest")

_FEDAMS_FAMILY = ("fedams", "fedcams", "fedamsgrad")


def init_server_state(flat, state_dtype: str = "float32",
                      block: int = 2048) -> ServerState:
    """``state_dtype`` selects the v/v̂ storage (m is always fp32); int8
    state is stored padded to the ``block`` quantization layout."""
    dev = flat.device
    d = flat.numel()
    zeros = lambda: torch.zeros(d, dtype=torch.float32, device=dev)
    if state_dtype == "bfloat16":
        second = lambda: torch.zeros(d, dtype=torch.bfloat16, device=dev)
    elif state_dtype == "int8":
        bs, nb = block_layout(d, block)
        second = lambda: QuantState(
            q=torch.zeros(nb * bs, dtype=torch.int8, device=dev),
            scale=torch.full((nb,), 1e-30, dtype=torch.float32, device=dev))
    else:
        second = zeros
    return ServerState(m=zeros(), v=second(), vhat=second(),
                       t=torch.zeros((), dtype=torch.int32, device=dev))


def _state_is_quantized(v) -> bool:
    return _is_quant(v) or v.dtype != torch.float32


def _fedams_option(fed: FedConfig) -> int:
    """fedamsgrad IS Option 2 regardless of ``fed.option``."""
    return 2 if fed.algorithm == "fedamsgrad" else fed.option


def server_update(fed: FedConfig, state: ServerState, params, delta):
    """One server step on the flat vector. Returns (new_params, new_state).
    Quantized v/v̂ storage is dequantized to fp32, updated with the exact
    fp32 math, and requantized."""
    if _state_is_quantized(state.v):
        return _server_update_quantized(fed, state, params, delta)
    return _server_update_f32(fed, state, params, delta)


def _server_update_quantized(fed: FedConfig, state: ServerState, params,
                             delta):
    if _is_quant(state.v):
        # the int8 payload lives on the padded block domain — pad the fp32
        # streams up, update, slice back
        d = params.numel()
        N = state.v.q.numel()
        nb = state.v.scale.shape[0]
        padf = lambda a: F.pad(a.float(), (0, N - d))
        st = ServerState(m=padf(state.m), v=ref.dequant(*state.v),
                         vhat=ref.dequant(*state.vhat), t=state.t)
        newx, st2 = _server_update_f32(fed, st, padf(params), padf(delta))
        return newx[:d], ServerState(
            m=st2.m[:d], v=QuantState(*ref.requant(st2.v, nb)),
            vhat=QuantState(*ref.requant(st2.vhat, nb)), t=st2.t)
    st = ServerState(m=state.m, v=state.v.float(), vhat=state.vhat.float(),
                     t=state.t)
    newp, st2 = _server_update_f32(fed, st, params, delta)
    return newp, ServerState(m=st2.m, v=st2.v.to(state.v.dtype),
                             vhat=st2.vhat.to(state.vhat.dtype), t=st2.t)


def _server_update_f32(fed: FedConfig, state: ServerState, params, delta):
    algo, b1, b2, eta, eps = fed.algorithm, fed.beta1, fed.beta2, fed.eta, fed.eps
    t = state.t + 1

    if algo == "fedavg":
        return params + eta * delta, ServerState(state.m, state.v,
                                                 state.vhat, t)
    if algo in _FEDAMS_FAMILY:
        x2, m2, v2, vh2 = ops.fedams_update(
            params, state.m, state.v, state.vhat, delta, eta=eta, beta1=b1,
            beta2=b2, eps=eps, option=_fedams_option(fed))
        return x2, ServerState(m2, v2, vh2, t)
    if algo not in ("fedadam", "fedyogi", "fedadagrad"):
        raise ValueError(f"unknown algorithm {algo!r}")

    m = b1 * state.m + (1 - b1) * delta
    d2 = delta * delta
    if algo == "fedyogi":
        v = state.v - (1 - b2) * d2 * torch.sign(state.v - d2)
    elif algo == "fedadagrad":
        v = state.v + d2
    else:
        v = b2 * state.v + (1 - b2) * d2
    new_params = params + eta * m / (ref.sqrt_rn(v) + eps)
    return new_params, ServerState(m, v, state.vhat, t)


# ===========================================================================
# One-pass fused ingest
# ===========================================================================


def server_ingest_leaf(fed: FedConfig, x, m, v, vh, vals, idx, n_div, *,
                       block: int, impl: str):
    """One-pass sparse ingest for one flat vector.

    ``x``/``m``: (d,) fp32; ``v``/``vh``: (d,) fp32/bf16 or
    :class:`QuantState`; ``vals``/``idx``: (n, nb·k) client-major
    selections with global indices in the zero-padded block domain.
    ``impl``: ``"kernel"`` (:func:`repro_torch.kernels.ops.fedams_ingest` —
    the CUDA kernel on the card, its twin on the CPU) or ``"jnp"`` (the
    plain blocked path, :func:`repro_torch.kernels.ref.fedams_ingest_ref`,
    on any device; the name is the JAX knob's). Returns ``(x2, m2, v2,
    vh2)`` with state in storage form."""
    d = x.shape[0]
    nb = -(-d // block)
    n = vals.shape[0]
    vals3 = vals.reshape(n, nb, -1)
    idx3 = idx.reshape(n, nb, -1)
    quant = _is_quant(v)
    state_dtype = "int8" if quant else str(v.dtype).replace("torch.", "")
    fn = {"kernel": ops.fedams_ingest, "jnp": ref.fedams_ingest_ref}[impl]
    kw = dict(n_div=n_div, eta=fed.eta, beta1=fed.beta1, beta2=fed.beta2,
              eps=fed.eps, option=_fedams_option(fed), block=block,
              state_dtype=state_dtype)
    if quant:
        x2, m2, qv, qvh, sv, svh = fn(x, m, v.q, vh.q, vals3, idx3, v.scale,
                                      vh.scale, **kw)
        return x2, m2, QuantState(qv, sv), QuantState(qvh, svh)
    return fn(x, m, v, vh, vals3, idx3, **kw)


def server_ingest(fed: FedConfig, state: ServerState, xflat, vals, idx,
                  n_div, *, block: int, impl: str):
    """FedSim entry point: fused ingest on the flat (d,) sim vector.
    Returns ``(new_flat, new_state)`` exactly like the two-pass
    ``server_aggregate_sparse`` + ``server_update`` (bitwise at fp32 state
    away from collisions; see :func:`server_ingest_leaf`)."""
    x2, m2, v2, vh2 = server_ingest_leaf(
        fed, xflat, state.m, state.v, state.vhat, vals, idx, n_div,
        block=block, impl=impl)
    return x2, ServerState(m=m2, v=v2, vhat=vh2, t=state.t + 1)


# ===========================================================================
# The mesh's per-leaf state
# ===========================================================================


def server_update_tree(fed: FedConfig, st: ServerState, params, agg):
    """:func:`server_update` leaf by leaf over the mesh's state trees
    (``st.m``/``st.v``/``st.vhat`` nested dicts like ``params``; bf16 v/v̂
    allowed). Returns ``(new_params, new_state)``."""
    def leaf(x, m, v, vh, d):
        x2, s2 = server_update(
            fed, ServerState(m.reshape(-1), v.reshape(-1), vh.reshape(-1),
                             st.t), x.reshape(-1).float(), d.reshape(-1))
        return (x2.reshape(x.shape).to(x.dtype), s2.m.reshape(x.shape),
                s2.v.reshape(v.shape), s2.vhat.reshape(vh.shape))

    xs, ms, vs, vhs = tree_unzip(
        tree_map(leaf, params, st.m, st.v, st.vhat, agg), 4)
    return xs, ServerState(m=ms, v=vs, vhat=vhs, t=st.t + 1)


def server_ingest_tree(fed: FedConfig, st: ServerState, params, sels, n_div,
                       gather, *, block: int, impl: str):
    """Mesh entry point: per-leaf gather + fused ingest over the state
    trees. ``sels`` has :class:`~repro_torch.core.compressors.Selection`
    leaves (this rank's compacted uplink, ``idx`` in the leaf's padded
    block domain); ``gather`` lifts one (nb·k,) tensor to the gathered
    (n, nb·k) client-major stack (the client-axis all_gather — the same
    collective ``stages.sparse_topk_leaf`` runs). Each leaf is ingested by
    :func:`server_ingest_leaf` at its own block layout
    (``block_layout(leaf size, block)``). Returns ``(new_params,
    new_state)`` like :func:`server_update_tree`."""
    def leaf(x, m, v, vh, sel):
        bs, _ = block_layout(x.numel(), block)
        x2, m2, v2, vh2 = server_ingest_leaf(
            fed, x.reshape(-1).float(), m.reshape(-1), v.reshape(-1),
            vh.reshape(-1), gather(sel.vals), gather(sel.idx), n_div,
            block=bs, impl=impl)
        return (x2.reshape(x.shape).to(x.dtype), m2.reshape(x.shape),
                v2.reshape(v.shape), vh2.reshape(vh.shape))

    xs, ms, vs, vhs = tree_unzip(
        tree_map(leaf, params, st.m, st.v, st.vhat, sels), 4)
    return xs, ServerState(m=ms, v=vs, vhat=vhs, t=st.t + 1)
