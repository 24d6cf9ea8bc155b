"""Biased top-k compressors C: R^d -> R^d (paper §4.2, Assumption 4.14).

Counterpart of ``repro.core.compressors`` for the top-k family: ``topk``
(global) and ``blocktopk`` (exact top-k' inside fixed-size blocks of the
flat vector), each with ``compress`` (dense output) and ``select`` (the
compacted ``(vals, idx)`` :class:`Selection`). Selection order is
``lax.top_k``'s: descending |x|, ties to the lowest index — a stable
descending sort here, or ``argmax`` (first maximum) when k = 1. The
results are bitwise those of the JAX compressors
(tests/test_torch_compressors.py).

In the FedSim round the blocktopk selection runs through the
``topk_ef_sparse`` kernel (:mod:`repro_torch.kernels.ops`); ``select`` and
``compress`` serve the global top-k uplink and the γ diagnostic.

The sign, randk, int8 and identity compressors (the dense uplink) are not
ported yet; :func:`make_compressor` refuses them by name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Selection(NamedTuple):
    """A compacted top-k selection of a flat length-d vector.

    ``vals[j]`` is the kept value at flat position ``idx[j]``. For blockwise
    compressors the pairs are grouped per block in block order (``(nb, kb)``
    flattened row-major) and ``idx`` may point into the zero-padded tail of
    the last block (``idx >= d``); those entries carry value 0.0 and are
    dropped by :func:`selection_to_dense`."""

    vals: torch.Tensor   # (k,) float32 kept values
    idx: torch.Tensor    # (k,) int32 flat positions (padded domain for blocks)


def selection_to_dense(sel: Selection, d: int) -> torch.Tensor:
    """Dense length-``d`` vector carrying the selection; entries with
    ``idx >= d`` (a padded tail) are dropped."""
    out = torch.zeros(d + 1, dtype=torch.float32, device=sel.vals.device)
    safe = torch.where(sel.idx < d, sel.idx, d).long()
    out[safe] = sel.vals
    return out[:d]


@dataclass(frozen=True)
class Compressor:
    name: str
    compress: Callable                      # (x, rng=None) -> x_hat (dense)
    bits_per_message: Callable              # d -> wire bits
    q_bound: Callable                       # (x,) -> q (Assumption 4.14)
    ratio: float = 1.0
    # (x, rng=None) -> Selection; None for compressors whose messages are
    # not (value, index) pairs
    select: Optional[Callable] = None


def _top_idx(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of ``mag`` along the last axis, in
    ``lax.top_k`` order (descending, ties to the lowest index)."""
    if k == 1:
        return mag.argmax(dim=-1, keepdim=True)
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


def make_topk(ratio: float) -> Compressor:
    def k_of(d: int) -> int:
        return max(1, int(round(ratio * d)))

    def select(x, rng=None):
        flat = x.reshape(-1)
        idx = _top_idx(flat.abs(), k_of(flat.numel()))
        return Selection(vals=flat[idx], idx=idx.to(torch.int32))

    def compress(x, rng=None):
        flat = x.reshape(-1)
        sel = select(flat)
        return selection_to_dense(sel, flat.numel()).reshape(x.shape)

    return Compressor(
        name=f"topk_{ratio:g}",
        compress=compress,
        # value + index per kept coordinate (paper footnote 8: "roughly double")
        bits_per_message=lambda d: 64 * max(1, int(round(ratio * d))),
        q_bound=lambda x: math.sqrt(max(1.0 - ratio, 0.0)),
        ratio=ratio,
        select=select,
    )


def block_layout(d: int, block: int):
    """Shared block layout for the blockwise top-k paths: block size is a
    multiple of 128, capped at ``block``."""
    bs = min(block, ((d + 127) // 128) * 128)
    nb = -(-d // bs)
    return bs, nb


def make_blocktopk(ratio: float, block: int = 2048) -> Compressor:
    def _blocks(x):
        flat = x.reshape(-1)
        d = flat.numel()
        bs, nb = block_layout(d, block)
        xb = F.pad(flat, (0, nb * bs - d)).view(nb, bs)
        return xb, d, bs, nb, max(1, int(round(ratio * bs)))

    def select(x, rng=None):
        xb, d, bs, nb, k = _blocks(x)
        idx = _top_idx(xb.abs(), k)                  # (nb, k)
        kept = xb.gather(1, idx)
        gidx = idx.to(torch.int32) + (torch.arange(
            nb, dtype=torch.int32, device=xb.device) * bs)[:, None]
        return Selection(vals=kept.reshape(-1), idx=gidx.reshape(-1))

    def compress(x, rng=None):
        xb, d, bs, nb, k = _blocks(x)
        idx = _top_idx(xb.abs(), k)
        out = torch.zeros_like(xb).scatter(1, idx, xb.gather(1, idx))
        return out.reshape(-1)[:d].reshape(x.shape)

    return Compressor(
        name=f"blocktopk_{ratio:g}",
        compress=compress,
        bits_per_message=lambda d: 64 * max(1, int(round(ratio * d))),
        q_bound=lambda x: math.sqrt(max(1.0 - ratio, 0.0)),
        ratio=ratio,
        select=select,
    )


def make_compressor(name: str, ratio: float = 1 / 64,
                    block: int = 2048) -> Compressor:
    if name == "topk":
        return make_topk(ratio)
    if name == "blocktopk":
        return make_blocktopk(ratio, block)
    if name in ("sign", "packedsign", "randk", "int8", "none", "identity"):
        raise NotImplementedError(
            f"compressor {name!r} is not ported to repro_torch yet")
    raise ValueError(f"unknown compressor {name!r}")
