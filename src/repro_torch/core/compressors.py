"""Biased compressors C: R^d -> R^d (paper §4.2, Assumption 4.14).

Counterpart of ``repro.core.compressors``:

* the top-k family, ``topk`` (global) and ``blocktopk`` (exact top-k'
  inside fixed-size blocks of the flat vector), each with ``compress``
  (dense output) and ``select`` (the compacted ``(vals, idx)``
  :class:`Selection`). Each follows the JAX function's own path: where it
  calls ``lax.top_k(|x|, k)`` (``compress`` always, ``select`` at k > 1)
  the picks are a stable descending sort of |x| as its bit pattern
  (:func:`repro_torch.kernels.ref.magnitude_bits`: ties to the lowest
  index, NaNs above +inf and by payload); where it calls
  ``_argmax_select`` (``select`` at k = 1) they are ``argmax`` of the
  float |x|, where the first NaN wins. Bitwise the JAX compressors, NaNs
  included (tests/test_torch_compressors.py);
* ``sign`` (and ``packedsign``, the same numerics): ``‖x‖₁/d · sign(x)``
  with sign(0) := +1. The scale is summed by the fixed halving trees of the
  ``sign_ef`` kernel (:func:`repro_torch.kernels.ref.sign_scale`), so
  ``compress`` equals the kernel bitwise and ``jnp.mean``'s scale within a
  few ulp;
* ``int8`` (absmax scale, round half to even) and ``none``/``identity``,
  bitwise the JAX compressors;
* ``randk``: k coordinates drawn uniformly at random. The JAX compressor
  draws them from its PRNG key (``jax.random.permutation(rng, d)[:k]``), a
  stream the port does not reproduce, so the port's ``compress(x, idx)``
  takes the k drawn positions as its second argument, and
  :func:`randk_positions` draws a round's sets from a generator on the
  round's device. Bitwise the JAX compressor on the same positions.

In the FedSim round the blocktopk selection runs through the
``topk_ef_sparse`` kernel, and the dense uplink's error feedback through
``topk_ef`` and ``sign_ef`` (:mod:`repro_torch.core.error_feedback`).

"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref


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
    # (x, rng=None) -> x_hat (dense); randk's second argument is its drawn
    # positions (make_randk)
    compress: Callable
    bits_per_message: Callable              # d -> wire bits
    q_bound: Callable                       # (x,) -> q (Assumption 4.14)
    ratio: float = 1.0
    # (x, rng=None) -> Selection; None for compressors whose messages are
    # not (value, index) pairs
    select: Optional[Callable] = None
    # blocktopk's block cap (the ``block`` of make_blocktopk); the dense
    # uplink's topk_ef kernel cuts the same blocks. Not a JAX field.
    block: Optional[int] = None


def _top_idx(v: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(jnp.abs(v), k)``'s indices along the last axis: |v| as
    its bit pattern, descending, ties to the lowest index (NaNs above +inf,
    by payload)."""
    mag = ref.magnitude_bits(v)
    if k == 1:
        return mag.argmax(dim=-1, keepdim=True)
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


def _argmax_idx(v: torch.Tensor) -> torch.Tensor:
    """``_argmax_select``'s index along the last axis: the first maximum of
    the float |v|, so the first NaN wins whatever its payload."""
    return v.abs().argmax(dim=-1, keepdim=True)


def make_topk(ratio: float) -> Compressor:
    def k_of(d: int) -> int:
        return max(1, int(round(ratio * d)))

    def select(x, rng=None):
        flat = x.reshape(-1)
        k = k_of(flat.numel())
        idx = _argmax_idx(flat) if k == 1 else _top_idx(flat, k)
        return Selection(vals=flat[idx], idx=idx.to(torch.int32))

    def compress(x, rng=None):
        flat = x.reshape(-1)
        idx = _top_idx(flat, k_of(flat.numel()))
        out = torch.zeros_like(flat).scatter(0, idx, flat[idx])
        return out.reshape(x.shape)

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
        idx = _argmax_idx(xb) if k == 1 else _top_idx(xb, k)   # (nb, k)
        kept = xb.gather(1, idx)
        gidx = idx.to(torch.int32) + (torch.arange(
            nb, dtype=torch.int32, device=xb.device) * bs)[:, None]
        return Selection(vals=kept.reshape(-1), idx=gidx.reshape(-1))

    def compress(x, rng=None):
        xb, d, bs, nb, k = _blocks(x)
        idx = _top_idx(xb, k)
        out = torch.zeros_like(xb).scatter(1, idx, xb.gather(1, idx))
        return out.reshape(-1)[:d].reshape(x.shape)

    return Compressor(
        name=f"blocktopk_{ratio:g}",
        compress=compress,
        bits_per_message=lambda d: 64 * max(1, int(round(ratio * d))),
        q_bound=lambda x: math.sqrt(max(1.0 - ratio, 0.0)),
        ratio=ratio,
        select=select,
        block=block,
    )


def make_sign() -> Compressor:
    def compress(x, rng=None):
        # sign(0) = sign(-0.0) := +1 — the convention a 1-bit wire can carry
        flat = x.reshape(1, -1)
        scale = ref.sign_scale(flat)[:, None]
        return torch.where(flat >= 0, scale, -scale).reshape(x.shape)

    def q_bound(x):
        x = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
        l1 = x.abs().sum()
        l2sq = (x * x).sum()
        q = 1.0 - l1 * l1 / (x.numel() * l2sq.clamp_min(1e-30))
        return float(torch.sqrt(q.clamp_min(0.0)))

    return Compressor(
        name="sign",
        compress=compress,
        bits_per_message=lambda d: 32 + d,       # Table 1
        q_bound=q_bound,
    )


def make_randk(ratio: float) -> Compressor:
    """Keep k = max(1, round(ratio·d)) coordinates at positions drawn
    outside: ``compress(x, idx)`` with ``idx`` the (k,) drawn positions
    (distinct, in [0, d)) returns ``x`` on them and zeros elsewhere."""
    def compress(x, idx=None):
        if idx is None:
            raise ValueError("randk needs its drawn positions: "
                             "compress(x, idx) (see randk_positions)")
        flat = x.reshape(-1)
        out = torch.zeros_like(flat)
        out[idx] = flat[idx]
        return out.reshape(x.shape)

    return Compressor(
        name=f"randk_{ratio:g}",
        compress=compress,
        bits_per_message=lambda d: 64 * max(1, int(round(ratio * d))),
        q_bound=lambda x: 1.0,   # only contractive in expectation
        ratio=ratio,
    )


def randk_positions(rng: Optional[torch.Generator], d: int, k: int,
                    count: int, device) -> torch.Tensor:
    """``count`` sets of k distinct positions of [0, d), each the first k of
    a uniform random permutation: (count, k) int64 on ``device``. They are
    drawn on the device from a generator there, seeded by one draw from
    ``rng`` (the round's host generator), so a round's sets depend on its
    ``rng`` alone. FedSim asks for a round's n client sets, γ's set and the
    two-way downlink's in one call (the JAX round folds its key with the
    client position, 999983 and 10⁶)."""
    if rng is None:
        raise ValueError("compressor 'randk' draws its positions every "
                         "round: pass a torch.Generator")
    seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.rand((count, d), generator=gen, device=device)
    return keys.argsort(dim=1)[:, :k]


def make_int8() -> Compressor:
    def compress(x, rng=None):
        scale = ref.div_rn(x.abs().amax(), 127.0).clamp_min(1e-30)
        return torch.round(x / scale) * scale

    return Compressor(
        name="int8",
        compress=compress,
        bits_per_message=lambda d: 32 + 8 * d,
        q_bound=lambda x: 1.0 / 127.0 * math.sqrt(1.0),
    )


def make_identity() -> Compressor:
    return Compressor(
        name="none",
        compress=lambda x, rng=None: x,
        bits_per_message=lambda d: 32 * d,
        q_bound=lambda x: 0.0,
    )


def make_compressor(name: str, ratio: float = 1 / 64,
                    block: int = 2048) -> Compressor:
    if name in ("none", "identity"):
        return make_identity()
    if name == "topk":
        return make_topk(ratio)
    if name == "blocktopk":
        return make_blocktopk(ratio, block)
    if name in ("sign", "packedsign"):
        c = make_sign()
        if name == "packedsign":
            # identical numerics; the packed 1-bit wire format of the mesh
            return Compressor(name="packedsign", compress=c.compress,
                              bits_per_message=c.bits_per_message,
                              q_bound=c.q_bound)
        return c
    if name == "int8":
        return make_int8()
    if name == "randk":
        return make_randk(ratio)
    raise ValueError(f"unknown compressor {name!r}")
