"""Error-feedback compression (paper Algorithm 2, lines 12 and 14-16).

    Δ̂ = C(Δ + e)            (compress the delta plus the carried error)
    e' = Δ + e − Δ̂           (participating clients)
    e' = e                    (non-participating clients keep stale error)

Counterpart of ``repro.core.error_feedback`` on the port's flat tensors:
a block of c clients is a (c, d) delta, and its errors are either a (c, d)
tensor (:func:`ef_compress`) or rows of the resident (m, d) EF buffer,
updated in place (:func:`ef_compress_rows`, what FedSim's dense uplink
runs).

The kernel route is per call, as ``repro.kernels.ops.KernelImpl.
ef_compress_leaf`` is per leaf: sign/packedsign go through
``kernels.ops.sign_ef`` and blocktopk through ``kernels.ops.topk_ef`` (the
CUDA kernels on the card, their twins on the CPU). Global top-k, int8,
randk and identity run ``comp.compress`` per client as plain torch — the
kernel route's ``"topk"`` is blockwise, a different function from the
global top-k that ``make_topk`` computes. randk takes its drawn positions
(``draws``, one row a client) where the JAX functions take a PRNG key.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressors import Compressor, block_layout
from repro_torch.kernels import ops


def ef_compress_rows(comp: Compressor, delta, errors, rows, draws=None):
    """EF compression for ``c`` clients on the resident buffer.

    ``delta``: (c, d) fp32; ``errors``: (m, d) fp32 EF buffer whose rows
    ``rows`` ((c,) int64, distinct) become ``delta + e − Δ̂`` IN PLACE;
    ``draws``: randk's (c, k) drawn positions, else None. Returns the (c, d)
    hats Δ̂."""
    if comp.name in ("sign", "packedsign"):
        return ops.sign_ef(delta, errors, rows)
    if comp.name.startswith("blocktopk"):
        bs, _ = block_layout(delta.shape[1], comp.block)
        k = max(1, int(round(comp.ratio * bs)))
        return ops.topk_ef(delta, errors, rows, k=k, block=bs)
    tot = errors[rows] + delta
    if draws is None:
        draws = [None] * tot.shape[0]
    hat = torch.stack([comp.compress(t, r) for t, r in zip(tot, draws)])
    errors[rows] = tot - hat
    return hat


def ef_compress(comp: Compressor, delta, error, rng=None):
    """Returns ``(delta_hat, new_error)`` for (c, d) — or (d,) — ``delta``
    and ``error``; ``error`` is not modified. ``rng`` stands where the JAX
    function takes its key: randk's drawn positions, (c, k) — or (k,) —,
    and unused by every other compressor."""
    one = delta.dim() == 1
    d2 = delta.reshape(1, -1) if one else delta
    new_err = error.reshape(d2.shape).clone()
    rows = torch.arange(d2.shape[0], device=d2.device)
    draws = None if rng is None else rng.reshape(d2.shape[0], -1)
    # rows 0..c-1 of the c-row copy are valid by construction: no check,
    # and so no host sync, in the kernels' wrappers
    with ops.rows_prechecked():
        hat = ef_compress_rows(comp, d2, new_err, rows, draws)
    if one:
        return hat.reshape(delta.shape), new_err.reshape(delta.shape)
    return hat, new_err


def ef_compress_masked(comp: Compressor, delta, error, participating,
                       rng=None):
    """Partial participation: ``participating`` is a bool (or 0/1) per
    client row — a scalar for (d,) inputs. Non-participating clients
    contribute zero to the aggregate and keep their stale error (paper
    lines 14-16)."""
    hat, new_err = ef_compress(comp, delta, error, rng)
    m = torch.as_tensor(participating, device=hat.device).bool()
    if hat.dim() == 2:
        m = m.reshape(-1, 1)
    return (torch.where(m, hat, torch.zeros_like(hat)),
            torch.where(m, new_err, error))
