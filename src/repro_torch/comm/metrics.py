"""Cumulative communication accounting for a training run.

A copy of ``repro.comm.metrics`` (NumPy and the standard library only);
tests/test_torch_imports.py holds it to the original.

``CommLog`` accumulates the measured per-round transport numbers (bytes on
the wire both directions, simulated wall-clock) that ``FedSim``'s wire mode
surfaces into ``FederatedTrainer.history`` — the measured counterpart of
the analytic ``bits`` counter the paper plots.

With two-level aggregation (``FedConfig.agg_groups > 1``, DESIGN.md
§scale-out) the uplink is billed per tier: tier 1 is the n client messages
(the codec bytes the transport times), tier 2 the g dense group partials
pushed to the root. ``wire_up_bytes`` then bills the tiers that actually
run (tier 1 + tier 2); the per-tier split is kept in
``wire_tier1_bytes`` / ``wire_tier2_bytes``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.comm.transport import RoundTiming


@dataclass
class CommLog:
    rounds: int = 0
    uplink_bytes: int = 0      # tier 1: DELIVERED client messages
    uplink_bytes_attempted: int = 0  # incl. crashed / deadline-cut sends
    edge_bytes: int = 0        # tier 2: group partial -> root (0 when flat)
    downlink_bytes: int = 0
    sim_time_s: float = 0.0

    @property
    def total_bytes(self) -> int:
        return self.uplink_bytes + self.edge_bytes + self.downlink_bytes

    def add(self, timing: RoundTiming, tier2_bytes: int = 0, *,
            round_time_s: float = None,
            delivered_uplink_bytes: int = None) -> None:
        """Book one round.

        ``round_time_s`` overrides ``timing.round_time_s`` with the
        EFFECTIVE server wall-clock (the fault injector's
        deadline-truncated value, or the async engine's flush delta) so
        ``sim_time_s`` always equals the sum of the recorded per-round
        times — the raw timing carries the untruncated straggler max.
        ``delivered_uplink_bytes`` bills only payloads that reached the
        server; ``timing.uplink_bytes`` (the full cohort's sends) then
        accumulates into the ``uplink_bytes_attempted`` diagnostic —
        crashed and deadline-cut clients consumed their own uplink but
        the server never saw those bytes."""
        if round_time_s is None:
            round_time_s = timing.round_time_s
        if delivered_uplink_bytes is None:
            delivered_uplink_bytes = timing.uplink_bytes
        self.rounds += 1
        self.uplink_bytes += delivered_uplink_bytes
        self.uplink_bytes_attempted += timing.uplink_bytes
        self.edge_bytes += tier2_bytes
        self.downlink_bytes += timing.downlink_bytes
        self.sim_time_s += round_time_s

    def record(self, timing: RoundTiming, tier2_bytes: int = 0, *,
               round_time_s: float = None,
               delivered_uplink_bytes: int = None) -> dict:
        """Add one round and return the history entries for it."""
        self.add(timing, tier2_bytes, round_time_s=round_time_s,
                 delivered_uplink_bytes=delivered_uplink_bytes)
        if round_time_s is None:
            round_time_s = timing.round_time_s
        if delivered_uplink_bytes is None:
            delivered_uplink_bytes = timing.uplink_bytes
        return {
            "wire_up_bytes": delivered_uplink_bytes + tier2_bytes,
            "wire_up_bytes_attempted": timing.uplink_bytes + tier2_bytes,
            "wire_tier1_bytes": delivered_uplink_bytes,
            "wire_tier2_bytes": tier2_bytes,
            "wire_down_bytes": timing.downlink_bytes,
            "wire_bytes": self.total_bytes,
            "round_time_s": round_time_s,
            "sim_time_s": self.sim_time_s,
        }
