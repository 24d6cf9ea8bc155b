"""Fault injection and deadline-robust rounds: the fault model, its
host-side planner, the wire damage and the server's validation before
ingest.

Counterpart of ``repro.comm.faults``:

* :class:`FaultConfig`, :class:`FaultPlan` and :class:`FaultInjector` are
  copies of the originals — numpy and the standard library only — so a
  plan is bitwise the JAX planner's for the same config, cohort, round and
  timing: every draw comes from ``default_rng((seed, 0xFA017, round))`` on
  the host, and the round needs no device sync to plan
  (tests/test_torch_faults.py holds the copies to the originals);
* :func:`corrupt_selection` / :func:`corrupt_dense` apply the wire damage
  to tensors and :func:`validate_selection` / :func:`validate_dense` are
  the server's gate: NaN/Inf and index-range rejection and the optional
  per-client norm clip. Non-survivors are replaced by ``where`` before any
  multiply (a NaN times 0 is still NaN), so one poisoned payload cannot
  reach the FedAMS m/v/v̂ state;
* :func:`mesh_fault_mask` / :func:`mesh_corruption_plan` are the mesh
  round's shared draws: every rank draws the same (m,) arrays from the
  round seed (:func:`mesh_draw`, one CPU generator per fold of the seed —
  JAX's ``0xFA017``–``0xFA01A`` folds, not its streams), so all ranks agree
  on who crashed and whose payload is damaged with no collective;
  :func:`mesh_draw` is the one function to patch to replay JAX's draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sampling import round_generator
from repro_torch.kernels import ref

#: Known payload corruption modes (validated at FaultConfig construction).
FAULT_CORRUPT_MODES = ("nan", "inf", "bitflip", "truncate")

#: Sentinel index for truncated-away selection entries: far outside any
#: leaf's padded block domain, so the range check rejects the client and
#: the scatter would drop the entry even if it slipped through.
INVALID_IDX = np.int32(2 ** 30)


@dataclass(frozen=True)
class FaultConfig:
    """Declarative fault model for one run (frozen).

    ``crash_prob`` — P(a sampled client crashes this round) — independent
    per (round, cohort slot), deterministic in ``(seed, round)``.
    ``crash_trace`` — scheduled outages: ``(client_id, from_round,
    to_round)`` half-open windows during which that client is dead; an
    open-ended entry (``to_round`` large) is a persistent crash.
    ``corrupt_prob``/``corrupt_mode`` — P(a *delivered* payload was
    damaged in transit) and how: ``nan``/``inf`` poison the values,
    ``bitflip`` XORs random bits into the value words (and knocks an
    index out of range, the checksum-less reality of a flipped header),
    ``truncate`` cuts a suffix of the entries (a short read — the length
    check rejects it).
    ``deadline_s`` — server-side round deadline: clients whose simulated
    finish time exceeds it are cut (FedSim wire mode only). 0 = wait for
    every survivor.
    ``max_update_norm`` — optional per-client L2 clip applied by the
    server to validated values before ingest. 0 = off.
    """

    crash_prob: float = 0.0
    crash_trace: Tuple[Tuple[int, int, int], ...] = ()
    corrupt_prob: float = 0.0
    corrupt_mode: str = "nan"
    deadline_s: float = 0.0
    max_update_norm: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.crash_prob <= 1.0:
            raise ValueError(
                f"FaultConfig.crash_prob={self.crash_prob} must be in [0, 1]")
        if not 0.0 <= self.corrupt_prob <= 1.0:
            raise ValueError(
                f"FaultConfig.corrupt_prob={self.corrupt_prob} must be in "
                f"[0, 1]")
        if self.corrupt_mode not in FAULT_CORRUPT_MODES:
            raise ValueError(
                f"FaultConfig.corrupt_mode={self.corrupt_mode!r} is not one "
                f"of {FAULT_CORRUPT_MODES}")
        if self.deadline_s < 0:
            raise ValueError(
                f"FaultConfig.deadline_s={self.deadline_s} must be >= 0")
        if self.max_update_norm < 0:
            raise ValueError(
                f"FaultConfig.max_update_norm={self.max_update_norm} must "
                f"be >= 0")
        for entry in self.crash_trace:
            if len(entry) != 3 or entry[1] > entry[2] or entry[0] < 0:
                raise ValueError(
                    f"FaultConfig.crash_trace entry {entry!r} must be "
                    f"(client_id >= 0, from_round, to_round) with "
                    f"from_round <= to_round")

    @property
    def any_faults(self) -> bool:
        return bool(self.crash_prob or self.crash_trace or self.corrupt_prob
                    or self.deadline_s or self.max_update_norm)


class FaultPlan(NamedTuple):
    """Per-client fault arrays for ONE round (host numpy).

    ``survivors`` (n,) f32 — 1.0 for clients whose payload reached the
    server (not crashed, not past the deadline); the validation mask
    multiplies into this. ``corrupt`` (n,) f32 — 1.0 where the delivered
    payload is damaged. ``xor_bits`` (n,) uint32 — the bit-flip masks (0
    for clean clients). ``trunc_keep`` (n,) f32 — kept fraction of the
    entries under truncation (1.0 for clean clients)."""

    survivors: np.ndarray
    corrupt: np.ndarray
    xor_bits: np.ndarray
    trunc_keep: np.ndarray


class FaultInjector:
    """Deterministic host-side fault planner (FedSim).

    Sits between :class:`~repro_torch.comm.transport.SimulatedNetwork` and
    the round: :meth:`plan` consumes the cohort ids, the round index and
    (when wire mode runs) the round's :class:`RoundTiming`, and returns
    the :class:`FaultPlan` plus a host-side info dict — survivor /
    crashed / deadline-cut counts and the deadline-truncated
    ``round_time_s`` (the cutoff turns the straggler max into a
    quantile). All draws come from ``default_rng((cfg.seed, 0xFA017,
    round))`` so a run is reproducible given the config alone."""

    def __init__(self, cfg: FaultConfig, num_clients: int):
        self.cfg = cfg
        self.num_clients = num_clients
        self._trace = tuple(cfg.crash_trace)

    def _trace_dead(self, idx: np.ndarray, round_idx: int) -> np.ndarray:
        dead = np.zeros(idx.size, bool)
        for cid, r0, r1 in self._trace:
            if r0 <= round_idx < r1:
                dead |= idx == cid
        return dead

    def plan(self, client_idx, round_idx: int,
             timing: Optional[object] = None):
        """(cohort ids, round, optional RoundTiming) -> (FaultPlan, info).

        ``info`` keys: ``survivors`` (delivered count before server
        validation), ``crashed``, ``deadline_cut``, and ``round_time_s``
        — the effective round wall-clock: with a deadline the server
        stops waiting at ``deadline_s`` whenever anyone failed to
        deliver; without one, crashed clients' connections reset (their
        times drop out of the max)."""
        cfg = self.cfg
        idx = np.asarray(client_idx, np.int64)
        n = idx.size
        rng = np.random.default_rng((cfg.seed, 0xFA017, int(round_idx)))
        crashed = rng.random(n) < cfg.crash_prob if cfg.crash_prob else \
            np.zeros(n, bool)
        crashed |= self._trace_dead(idx, int(round_idx))
        # corruption draws are burned even for crashed clients so the
        # stream per (seed, round) is independent of who crashed
        corrupt = rng.random(n) < cfg.corrupt_prob if cfg.corrupt_prob else \
            np.zeros(n, bool)
        xor_bits = rng.integers(1, 2 ** 32, size=n, dtype=np.uint32)
        trunc_keep = rng.random(n)
        late = np.zeros(n, bool)
        times = None if timing is None else np.asarray(timing.client_times_s)
        if cfg.deadline_s > 0:
            if times is None:
                raise ValueError(
                    "FaultConfig.deadline_s > 0 needs the round's "
                    "RoundTiming (wire mode) — without simulated client "
                    "times there is nothing to cut")
            late = ~crashed & (times > cfg.deadline_s)
        delivered = ~crashed & ~late
        corrupt &= delivered
        if times is not None and n:
            delivered_times = times[delivered]
            if cfg.deadline_s > 0 and not delivered.all():
                round_time = float(cfg.deadline_s)
            elif delivered_times.size:
                round_time = float(delivered_times.max())
            else:
                round_time = 0.0
        else:
            round_time = None if timing is None else 0.0
        plan = FaultPlan(
            survivors=delivered.astype(np.float32),
            corrupt=corrupt.astype(np.float32),
            xor_bits=np.where(corrupt, xor_bits, np.uint32(0)),
            trunc_keep=np.where(corrupt, trunc_keep, 1.0).astype(np.float32),
        )
        info = {
            "survivors": float(delivered.sum()),
            "crashed": float(crashed.sum()),
            "deadline_cut": float(late.sum()),
        }
        if round_time is not None:
            info["round_time_s"] = round_time
        return plan, info


# ---------------------------------------------------------------------------
# Tensor stages: wire corruption + server validation-before-ingest
# ---------------------------------------------------------------------------


def plan_to_device(plan: FaultPlan, device) -> FaultPlan:
    """The host plan as tensors on ``device``, ``xor_bits`` as the int32
    view of the uint32 masks (torch has no uint32 XOR)."""
    return FaultPlan(
        survivors=torch.from_numpy(plan.survivors).to(device),
        corrupt=torch.from_numpy(plan.corrupt).to(device),
        xor_bits=torch.from_numpy(
            np.ascontiguousarray(plan.xor_bits).view(np.int32)).to(device),
        trunc_keep=torch.from_numpy(plan.trunc_keep).to(device))


def _flip_bits(x, xor_bits):
    """XOR each row's fp32 bit pattern with its row's mask."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits ^ xor_bits[..., None]).view(torch.float32)


def corrupt_selection(vals, idx, plan: FaultPlan, mode: str):
    """Apply the configured wire damage to received ``(vals, idx)``
    selections. ``vals``/``idx``: (..., k) fp32 / int32; ``plan``: a
    :func:`plan_to_device` plan, whose (...,) tensors broadcast over the
    leading dims. Runs AFTER the client booked
    its EF residual — the client believes its clean send succeeded; the
    damage is in transit."""
    c = plan.corrupt[..., None] > 0
    if mode == "nan":
        return torch.where(c, torch.nan, vals), idx
    if mode == "inf":
        return torch.where(c, torch.inf, vals), idx
    if mode == "bitflip":
        vals = torch.where(c, _flip_bits(vals, plan.xor_bits), vals)
        # a flipped length/offset word knocks an index out of the padded
        # domain: a deterministic trigger for the range check on entry 0
        k = idx.shape[-1]
        hit = c & (torch.arange(k, device=idx.device) == 0)
        return vals, torch.where(hit, idx ^ (1 << 29), idx)
    if mode == "truncate":
        k = vals.shape[-1]
        cut = torch.floor(plan.trunc_keep[..., None] * k)  # in [0, k-1]
        dropped = c & (torch.arange(k, device=vals.device) >= cut)
        return (torch.where(dropped, 0.0, vals),
                torch.where(dropped, int(INVALID_IDX), idx))
    raise ValueError(f"unknown corrupt_mode {mode!r}")


def corrupt_dense(hats, plan: FaultPlan, mode: str):
    """Dense-path sibling of :func:`corrupt_selection` for (..., d) client
    rows. ``truncate`` zeroes the row's suffix; the server's length check
    (:func:`validate_dense` with ``truncated``) rejects it."""
    c = plan.corrupt[..., None] > 0
    if mode == "nan":
        return torch.where(c, torch.nan, hats)
    if mode == "inf":
        return torch.where(c, torch.inf, hats)
    if mode == "bitflip":
        return torch.where(c, _flip_bits(hats, plan.xor_bits), hats)
    if mode == "truncate":
        d = hats.shape[-1]
        cut = torch.floor(plan.trunc_keep[..., None] * d)
        return torch.where(c & (torch.arange(d, device=hats.device) >= cut),
                           0.0, hats)
    raise ValueError(f"unknown corrupt_mode {mode!r}")


def _clip(x, max_norm: float):
    """Each row of ``x`` scaled to L2 norm at most ``max_norm``: a correctly
    rounded sqrt and a true division (ROADMAP "Kernel numerics"); the sum of
    squares runs in PyTorch's order, not XLA's."""
    nrm = ref.sqrt_rn((x * x).sum(dim=-1, keepdim=True))
    ratio = torch.full_like(nrm, max_norm) / nrm.clamp_min(1e-30)
    return x * ratio.clamp_max(1.0)


def validate_selection(vals, idx, domain: int, max_norm: float = 0.0):
    """Server-side validation before ingest for ``(..., k)`` selections.

    Returns ``(vals', valid)``: ``valid`` (...,) f32 is 1.0 where every
    value is finite and every index sits inside ``[0, domain)`` (the
    zero-padded block domain — legitimate padded-tail entries pass, a
    flipped or truncated index does not); ``vals'`` has invalid clients'
    values replaced by 0 — never a NaN times a mask — and, when
    ``max_norm > 0``, each client's values clipped to that L2 norm."""
    finite = torch.isfinite(vals).all(dim=-1)
    inrange = ((idx >= 0) & (idx < domain)).all(dim=-1)
    valid = (finite & inrange).float()
    vals = torch.where(valid[..., None] > 0, vals, 0.0)
    if max_norm > 0:
        vals = _clip(vals, max_norm)
    return vals, valid


def validate_dense(hats, max_norm: float = 0.0, truncated=None):
    """Dense-path validation: finite check per (..., d) client row, the
    length check (``truncated`` — 1.0 where the payload arrived short),
    and the optional per-client norm clip."""
    valid = torch.isfinite(hats).all(dim=-1)
    if truncated is not None:
        valid &= truncated == 0
    valid = valid.float()
    hats = torch.where(valid[..., None] > 0, hats, 0.0)
    if max_norm > 0:
        hats = _clip(hats, max_norm)
    return hats, valid


# ---------------------------------------------------------------------------
# The mesh's shared draws
# ---------------------------------------------------------------------------


def mesh_draw(seed: int, fold: int, m: int, kind: str = "uniform"):
    """One of mesh round ``seed``'s shared fault draws, from
    ``round_generator(seed, fold)`` on the CPU: (m,) float32 uniforms in
    [0, 1) (``kind="uniform"``) or (m,) uint32 bit patterns held as int32
    (``kind="bits"``, the form ``corrupt_selection`` XORs with)."""
    gen = round_generator(seed, fold)
    if kind == "bits":
        u = torch.randint(0, 2 ** 32, (m,), generator=gen,
                          dtype=torch.int64)
        return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return torch.rand(m, generator=gen, dtype=torch.float32)


def mesh_fault_mask(cfg: FaultConfig, seed: int, m: int, round_idx: int):
    """(m,) f32 alive-mask for the mesh round, the same on every rank:
    crashes drawn with probability ``crash_prob`` (fold ``0xFA017``), and
    ``crash_trace`` windows evaluated against ``round_idx``. Semantics
    match the FedSim injector (different streams — the backends share the
    fault *model*, not the draws)."""
    alive = torch.ones(m, dtype=torch.float32)
    if cfg.crash_prob > 0:
        u = mesh_draw(seed, 0xFA017, m)
        alive = alive * (u >= cfg.crash_prob).float()
    for cid, r0, r1 in cfg.crash_trace:
        if r0 <= int(round_idx) < r1:
            alive[cid] = 0.0
    return alive


def mesh_corruption_plan(cfg: FaultConfig, seed: int, m: int) -> FaultPlan:
    """The mesh round's shared corruption draws as a :func:`plan_to_device`
    style plan of (m,) CPU tensors: every rank computes the same flag /
    xor / cut arrays (folds ``0xFA018``–``0xFA01A``); rank i damages its own
    payload with row i before the client-axis gather, so the server — and
    client i itself, for the NACK — sees the corrupted copy."""
    corrupt = (mesh_draw(seed, 0xFA018, m) < cfg.corrupt_prob).float()
    xor = mesh_draw(seed, 0xFA019, m, "bits")
    keep = mesh_draw(seed, 0xFA01A, m)
    return FaultPlan(
        survivors=torch.ones(m, dtype=torch.float32),
        corrupt=corrupt,
        xor_bits=torch.where(corrupt > 0, xor, 0),
        trunc_keep=torch.where(corrupt > 0, keep, 1.0),
    )
