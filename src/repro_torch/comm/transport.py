"""Simulated client-server network for federated rounds.

A copy of ``repro.comm.transport`` (NumPy only): the draws are keyed by
(seed, round, client id) with the same splitmix64 chain and per-client
``np.random.default_rng((seed, id))`` link draws, so the port's FedSim
books exactly the JAX FedSim's bytes and times
(tests/test_torch_imports.py holds the copy to the original).

Models the part of the system the paper's bit counts are a proxy for: how
long a round actually takes when m heterogeneous clients push their encoded
deltas up a slow, asymmetric last-mile link. Per client the model draws a
fixed uplink/downlink bandwidth (log-normal heterogeneity around configured
means — clients keep their link quality across rounds) and per round a
latency sample plus an optional straggler event that multiplies that
client's times.

A round is:  server broadcasts the (possibly compressed) model update down
every participating client's downlink, clients compute (``compute_s``, a
constant knob — compute is not what this module studies), then push their
encoded delta up the uplink; the server waits for the slowest client:

    T_round = max_i [ t_down(i) + compute_s + t_up(i) ]
    t_dir(i) = latency(i) + bytes_dir / bandwidth_dir(i)

Everything is host-side numpy — transport runs between jitted rounds, not
inside them — and deterministic given (seed, round index, client id).

The async buffered engine (comm/async_engine.py, DESIGN.md §11) reuses the
same per-client draws but drops the max: :class:`EventClock` orders the
per-client completion times globally so the server can react to each
delivery instead of the slowest one.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class NetworkConfig:
    """Last-mile link model (defaults: consumer uplink-constrained WAN)."""

    uplink_mbps: float = 20.0       # mean client->server bandwidth
    downlink_mbps: float = 100.0    # mean server->client bandwidth (asym.)
    bandwidth_sigma: float = 0.5    # log-normal spread across clients
    latency_ms: float = 50.0        # mean one-way link setup latency
    latency_jitter_ms: float = 10.0
    straggler_prob: float = 0.05    # P(client is a straggler this round)
    straggler_slowdown: float = 4.0
    compute_s: float = 0.0          # fixed local-training time per round
    seed: int = 0


# ---------------------------------------------------------------------------
# Counter-based per-(seed, round, client) draws.
#
# The per-round latency/straggler draws used to come from one Generator per
# round indexed by cohort POSITION, so a client's timing changed whenever
# the cohort was resampled or reordered. These are keyed by the identity
# triple instead — the per-round sibling of the (seed, id) link draws — via
# a vectorized splitmix64 chain (no per-client Generator construction on
# the warm path).
# ---------------------------------------------------------------------------


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (wraps mod 2^64)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def client_round_u01(seed: int, round_idx: int, ids: np.ndarray,
                     lane: int) -> np.ndarray:
    """U(0, 1) draw keyed by ``(seed, round, client_id, lane)``.

    Position-free and vectorized: permuting or resampling the cohort
    permutes the outputs exactly (regression-tested); ``lane`` separates
    independent draws for the same triple. Never returns exactly 0 (the
    Box–Muller log below needs u > 0)."""
    ids64 = np.asarray(ids, np.int64).astype(np.uint64)
    h = np.full(ids64.shape, np.uint64(seed % 2 ** 64))
    h = _splitmix64(h ^ np.uint64(round_idx % 2 ** 64))
    h = _splitmix64(h ^ ids64)
    h = _splitmix64(h ^ np.uint64(lane))
    return ((h >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0 ** -53


def _client_round_normal(seed: int, round_idx: int, ids: np.ndarray,
                         lane: int) -> np.ndarray:
    """Standard-normal draw per (seed, round, client_id) via Box–Muller
    over two hash lanes."""
    u1 = client_round_u01(seed, round_idx, ids, lane)
    u2 = client_round_u01(seed, round_idx, ids, lane + 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclass
class RoundTiming:
    """Timing/byte report for one simulated round.

    ``round_time_s`` is the server's wall-clock for the round — the
    straggler max, or the deadline-truncated value when a fault-tolerant
    round cuts stragglers (comm.faults). ``p50_client_time_s`` /
    ``p90_client_time_s`` are per-client completion-time quantiles over
    the cohort (0.0 for an empty round) — the deadline sweep picks its
    cutoffs from these."""

    round_time_s: float
    uplink_bytes: int
    downlink_bytes: int
    slowest_client: int
    mean_client_time_s: float
    client_times_s: np.ndarray
    p50_client_time_s: float = 0.0
    p90_client_time_s: float = 0.0


class SimulatedNetwork:
    """Per-client link state + per-round timing draws (deterministic).

    Link draws are LAZY over the participating index set (DESIGN.md
    §scale-out): each client's fixed bandwidth pair is drawn on first
    participation, keyed by ``(cfg.seed, client_id)`` and cached — so a
    client keeps its link across rounds, the draw is independent of
    participation order, two networks sharing a seed agree per client, and
    constructing a network for m = 10^6 clients allocates nothing."""

    def __init__(self, cfg: NetworkConfig, num_clients: int):
        self.cfg = cfg
        self.num_clients = num_clients
        self._links: dict = {}  # client id -> (up_bps, down_bps)
        # sorted snapshot of the cache for the vectorized warm path: the
        # per-round lookup is a numpy searchsorted over these, not a
        # Python loop over the cohort
        self._ids = np.empty(0, np.int64)
        self._ups = np.empty(0, np.float64)
        self._downs = np.empty(0, np.float64)

    def _draw_links(self, ids: np.ndarray) -> None:
        """Draw + cache the fixed link pair for uncached ids. The draw
        stays keyed by ``(cfg.seed, id)`` — one Generator per id, exactly
        the stream the original per-client loop consumed (bit-identical,
        regression-tested) — but only first-time participants ever reach
        this loop; warm rounds are pure numpy."""
        cfg = self.cfg
        mu = -0.5 * cfg.bandwidth_sigma ** 2
        raw = np.stack([
            np.random.default_rng((cfg.seed, int(c))).normal(
                mu, cfg.bandwidth_sigma, 2)
            for c in ids])
        lu, ld = np.exp(raw[:, 0]), np.exp(raw[:, 1])
        ups = cfg.uplink_mbps * 1e6 / 8.0 * lu
        downs = cfg.downlink_mbps * 1e6 / 8.0 * ld
        for c, u, d in zip(ids, ups, downs):
            self._links[int(c)] = (float(u), float(d))
        all_ids = np.concatenate([self._ids, ids])
        order = np.argsort(all_ids, kind="stable")
        self._ids = all_ids[order]
        self._ups = np.concatenate([self._ups, ups])[order]
        self._downs = np.concatenate([self._downs, downs])[order]

    def _links_for(self, idx: np.ndarray):
        """Fixed per-client heterogeneity for the given clients: a client
        on a bad link stays on it (cached, keyed by (seed, id)). O(n log
        cache) numpy once every cohort member has participated — no
        Python loop over the cohort (the loop at 10^5-client cohorts
        dominated the round)."""
        idx = np.asarray(idx, np.int64)
        if idx.size == 0:
            return np.empty(0), np.empty(0)
        pos = np.searchsorted(self._ids, idx)
        safe = np.minimum(pos, max(self._ids.size - 1, 0))
        hit = (self._ids[safe] == idx) if self._ids.size else \
            np.zeros(idx.size, bool)
        if not hit.all():
            self._draw_links(np.unique(idx[~hit]))
            pos = np.searchsorted(self._ids, idx)
        return self._ups[pos], self._downs[pos]

    def round(self, client_idx: Sequence[int], uplink_bytes_per_client: int,
              downlink_bytes_per_client: int, round_idx: int) -> RoundTiming:
        cfg = self.cfg
        idx = np.asarray(client_idx, np.int64)
        n = idx.size
        up_bps, down_bps = self._links_for(idx)
        # per-round draws keyed by (seed, round, client_id) — like the link
        # draws, a client's latency/straggler fate this round is a property
        # of the client, not of its position in a (re)sampled cohort
        z = _client_round_normal(cfg.seed, round_idx, idx, lane=0)
        latency = np.maximum(
            cfg.latency_ms + cfg.latency_jitter_ms * z, 1.0) / 1e3
        u = client_round_u01(cfg.seed, round_idx, idx, lane=2)
        slow = np.where(u < cfg.straggler_prob, cfg.straggler_slowdown, 1.0)
        t_down = latency + downlink_bytes_per_client / down_bps
        t_up = latency + uplink_bytes_per_client / up_bps
        per_client = slow * (t_down + cfg.compute_s + t_up)
        worst = int(np.argmax(per_client)) if n else -1
        return RoundTiming(
            round_time_s=float(per_client.max(initial=0.0)),
            uplink_bytes=int(uplink_bytes_per_client) * n,
            downlink_bytes=int(downlink_bytes_per_client) * n,
            slowest_client=int(idx[worst]) if n else -1,
            mean_client_time_s=float(per_client.mean()) if n else 0.0,
            client_times_s=per_client,
            p50_client_time_s=float(np.percentile(per_client, 50)) if n
            else 0.0,
            p90_client_time_s=float(np.percentile(per_client, 90)) if n
            else 0.0,
        )


class EventClock:
    """Host-side simulated event clock for the async engine (DESIGN.md
    §11): a priority queue of (absolute delivery time, payload) entries
    plus the server's current simulated time.

    ``push`` schedules a delivery; ``pop`` returns the earliest pending
    entry and advances ``now`` to its time (the server experiences
    deliveries in time order). Ties break on insertion order (a
    monotonically increasing sequence number), so the order — and
    everything downstream of it — is deterministic."""

    def __init__(self):
        self.now = 0.0
        self._heap: list = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time_s: float, payload) -> None:
        heapq.heappush(self._heap, (float(time_s), self._seq, payload))
        self._seq += 1

    def pop(self):
        """-> (time_s, payload) of the earliest pending delivery; advances
        ``now``. Pops are nondecreasing in time."""
        t, _, payload = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, payload
