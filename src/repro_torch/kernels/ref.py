"""Plain-PyTorch twins of the CUDA kernels (the CPU path and the on-card
oracle).

Each function computes exactly what its kernel in ``csrc/`` computes, with
the same inputs, outputs and accumulation order, so the kernel is held to
it bitwise on the card, and the twin is held bitwise to the JAX package's
eager functions and ``repro.kernels.ref`` oracles on the CPU
(tests/test_torch_kernels.py). Every multiply and add is rounded
separately; the jitted Pallas programs on XLA:CPU contract the moment
updates into FMAs and sit one rounding away.

* :func:`topk_ef_sparse` — ``repro.kernels.topk_ef.topk_ef_sparse``:
  exact-k per block in ``lax.top_k`` order (descending |value|, ties to the
  lowest index). This is NOT the threshold ``repro.kernels.ref.topk_ef_ref``,
  which keeps more than k on ties.
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

import torch
import torch.nn.functional as F


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
    nb = -(-d // block)
    tot = x + err[rows]
    tb = F.pad(tot, (0, nb * block - d)).view(c, nb, block)
    mag = tb.abs()
    if k == 1:
        li = mag.argmax(dim=-1, keepdim=True)   # first maximum on ties
    else:
        li = torch.sort(mag, dim=-1, descending=True,
                        stable=True).indices[..., :k]
    vals = tb.gather(-1, li)
    err[rows] = tb.scatter(-1, li, 0.0).view(c, nb * block)[:, :d]
    base = torch.arange(nb, device=x.device)[:, None] * block
    return vals, (li + base).to(torch.int32)


def div_rn(a, s):
    """``a / s`` for a Python number ``s``, correctly rounded on any device.
    PyTorch on CUDA divides by a Python scalar as a multiply by its
    reciprocal, which can differ in the last bit from the true quotient that
    JAX and the CUDA kernels compute; a 0-d tensor divisor is a true
    division."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


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
    dm = scatter_mean_padded(vals, idx, N, n_div)
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
