"""Event-driven async buffered rounds (counterpart of
``repro.comm.async_engine``).

A FedBuff-style server loop on top of the simulated network: instead of
waiting for the slowest client (sync) or cutting stragglers at a deadline
(``comm.faults``), the server reacts to *deliveries*. Each staged cohort is
dispatched at the server's current simulated time; per-client completion
times (the same ``(seed, round, client_id)``-keyed transport draws the sync
round takes the maximum of) schedule delivery events on an
:class:`~repro_torch.comm.transport.EventClock`; every
``FedConfig.async_buffer`` deliveries the server flushes one buffered
aggregation, weighting each entry by its staleness τ (server versions
advanced since its dispatch).

The device work is the FedSim's: a dispatch is the select-once sparse
uplink (``FedSim._async_dispatch``; EF booked at dispatch, through the
``topk_ef_sparse`` kernel for blocktopk), a flush ingests a ``(B, k)``
masked buffer with a weight and a fill vector (``FedSim._async_flush``:
the fused ``fedams_ingest`` through an exact pre-scale, or the weighted
scatter-mean and ``fedams_update``). Each step is one program per shape,
as the reference jits each (``FedSim._dispatch``, ``FedSim._flush``: on
the card one captured CUDA graph each, replayed once a step; a partial
flush has the full flush's shapes). The payloads stay on the device; the
event loop itself is host-side Python, as the transport is, and runs
between the steps.

Determinism and the parity anchor: every draw is keyed by identity triples
and the event queue breaks time ties by insertion order, so a run is a
function of (config, seed). Buffered entries are ingested in canonical
``(dispatch cohort, slot)`` order, not arrival order. With ``async_buffer
== cohort size`` and unit weights the loop is dispatch → full-cohort flush
→ dispatch, and every flush is bitwise the port's sync round
(tests/test_torch_async.py).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.transport import EventClock, RoundTiming
from repro_torch.core.local import hetero_step_counts

# Staleness weight rules w(τ), τ = server versions advanced between an
# entry's dispatch and its ingest. All rules give w(0) = 1.0 exactly (in
# float64 AND after the float32 cast), which is what makes the
# buffer==cohort parity anchor hold for every rule, not just "uniform".
STALENESS_WEIGHTS = {
    "uniform": lambda tau: np.ones_like(tau),
    "inv_sqrt": lambda tau: 1.0 / np.sqrt(1.0 + tau),
    "inv_linear": lambda tau: 1.0 / (1.0 + tau),
    "exp": lambda tau: np.exp(-0.5 * tau),
}


def resolve_staleness_weight(name: str) -> Callable[[np.ndarray], np.ndarray]:
    """Look up a staleness rule by ``FedConfig.staleness_weight`` name."""
    try:
        return STALENESS_WEIGHTS[name]
    except KeyError:
        raise ValueError(
            f"unknown staleness weight {name!r}; known: "
            f"{sorted(STALENESS_WEIGHTS)}") from None


class _Delivery(NamedTuple):
    """One client payload in flight (rows of the dispatch's device
    tensors)."""
    cohort: int           # staged dispatch index r — canonical sort key 1
    slot: int             # position in its cohort — canonical sort key 2
    client: int           # global client id (diagnostics)
    vals: torch.Tensor    # (k,) received selection values
    idx: torch.Tensor     # (k,) flat coordinate indices
    loss: torch.Tensor    # () this client's local training loss
    t_sent: float         # server sim-time at dispatch
    version: int          # server version at dispatch (staleness base)


class AsyncRoundEngine:
    """Host-side event loop driving a FedSim's dispatch and flush steps.

    ``weight_fn`` (optional) overrides the configured staleness rule with
    any ``τ-array -> weight-array`` callable."""

    def __init__(self, sim, weight_fn: Optional[Callable] = None):
        self.sim = sim
        self.buffer = int(sim.fed.async_buffer)
        self.weight_fn = weight_fn or resolve_staleness_weight(
            sim.fed.staleness_weight)

    def run(self, state, client_batches, client_idx, rngs=None):
        """Consume ALL staged cohorts; return ``(new_state, mets)``.

        ``client_batches``: leading (R, n, K, ...); ``client_idx``: (R, n)
        staged cohorts; ``rngs``: R generators or None (heterogeneous step
        counts draw from them). One metric dict per FLUSH —
        ``ceil(total deliveries / B)`` of them, which equals R only when
        ``B == n`` and nobody crashes. ``state.round`` advances per flush
        (the server-version counter staleness is measured against). The
        state's EF buffer is updated in place."""
        sim = self.sim
        B = self.buffer
        dev = sim.device
        if isinstance(client_idx, torch.Tensor):
            client_idx = client_idx.cpu().numpy()
        idx_host = np.asarray(client_idx, dtype=np.int64)
        R, n = int(idx_host.shape[0]), int(idx_host.shape[1])
        sim._check_ids(idx_host)   # so the dispatches' row checks are off
        if B > n:
            raise ValueError(
                f"async_buffer={B} exceeds the staged cohort size n={n} — "
                f"a flush could never fill")
        up_pc = sim.codec.nbytes(sim._d)
        down_pc = sim._down_codec.nbytes(sim._d)
        bpm = int(sim.comp.bits_per_message(sim._d))
        clock = EventClock()
        cur = state           # params/opt/x_client advance per flush
        version = 0           # server flushes so far == len(mets)
        next_r = 0            # next staged cohort to dispatch
        # byte/fault tallies accumulated since the last flush (a flush
        # bills everything dispatched on its watch)
        pend = {"attempted": 0, "down": 0, "crashed": 0.0}
        bits = state.bits
        t_prev = 0.0
        mets = []

        def dispatch(r: int) -> None:
            ridx = state.round + r  # absolute round: the transport/fault
            # draw key AND the local-LR schedule index, as in sync staging
            ids = idx_host[r]
            timing = sim.network.round(ids, up_pc, down_pc, ridx)
            delivered = np.ones(n, bool)
            fplan = None
            if sim.faults is not None:
                fplan, finfo = sim.faults.plan(ids, ridx, timing)
                delivered = fplan.survivors > 0  # crashed never deliver
                pend["crashed"] += finfo["crashed"]
            batches, rows, fplan = sim._host_to_device(
                {k: v[r] for k, v in client_batches.items()}, ids, fplan)
            k_all = hetero_step_counts(sim.fed,
                                       None if rngs is None else rngs[r], n)
            vals, sidx, losses = sim._dispatch(
                cur.errors, cur.x_client, batches, rows, ridx, k_all, fplan)
            t0 = clock.now  # dispatched at the server's current sim time
            for i in range(n):
                if delivered[i]:
                    clock.push(t0 + float(timing.client_times_s[i]),
                               _Delivery(r, i, int(ids[i]), vals[i], sidx[i],
                                         losses[i], t0, version))
            pend["attempted"] += timing.uplink_bytes
            pend["down"] += timing.downlink_bytes

        high_water = max(B, n)
        while True:
            # dispatch-ahead up to the high-water mark: keep a full
            # cohort's worth of deliveries in flight so a straggler from
            # cohort r never starves the buffer. At B == n the mark equals
            # the buffer, so the loop is exactly the sync cadence
            # (dispatch → full-cohort flush → dispatch): the parity anchor
            while len(clock) < high_water and next_r < R:
                dispatch(next_r)
                next_r += 1
            if len(clock) == 0:
                break  # every staged cohort dispatched and drained
            take = min(B, len(clock))
            popped = [clock.pop() for _ in range(take)]  # time-ordered
            t_now = clock.now
            # canonical buffer order (dispatch cohort, slot), NOT arrival
            # order: the flush's scatter order — and so its bits — is
            # independent of arrival-time ties, and at B == n it is the
            # sync cohort order
            entries = sorted((e for _, e in popped),
                             key=lambda e: (e.cohort, e.slot))
            k = entries[0].vals.shape[0]
            # a partial flush leaves its empty slots at idx = 0, vals = +0.0
            # (the reference's buffer); w and fill are 0 there
            vals_buf = torch.zeros((B, k), dtype=torch.float32, device=dev)
            idx_buf = torch.zeros((B, k), dtype=torch.int32, device=dev)
            loss_buf = torch.zeros((B,), dtype=torch.float32, device=dev)
            vals_buf[:take] = torch.stack([e.vals for e in entries])
            idx_buf[:take] = torch.stack([e.idx for e in entries])
            loss_buf[:take] = torch.stack([e.loss for e in entries])
            fill = np.zeros((B,), np.float32)
            fill[:take] = 1.0
            tau = np.zeros((B,), np.float64)
            tau[:take] = [version - e.version for e in entries]
            w = (fill.astype(np.float64)
                 * self.weight_fn(tau)).astype(np.float32)
            cur, met = sim._flush(
                cur, vals_buf, idx_buf, torch.from_numpy(w).to(dev),
                torch.from_numpy(fill).to(dev), loss_buf)
            version += 1
            bits += take * bpm
            # per-flush wall-clock is the event-time delta; the sojourn of
            # each ingested payload plays the per-client-time role
            sojourn = np.array([t - e.t_sent for t, e in popped])
            dt = t_now - t_prev
            t_prev = t_now
            timing = RoundTiming(
                round_time_s=dt,
                uplink_bytes=pend["attempted"],
                downlink_bytes=pend["down"],
                slowest_client=popped[-1][1].client,
                mean_client_time_s=float(sojourn.mean()),
                client_times_s=sojourn,
                p50_client_time_s=float(np.percentile(sojourn, 50)),
                p90_client_time_s=float(np.percentile(sojourn, 90)),
            )
            met.update(sim.comm_log.record(
                timing, delivered_uplink_bytes=take * up_pc))
            met["bits"] = bits
            met["staleness_mean"] = float(tau[:take].mean())
            met["staleness_max"] = float(tau[:take].max())
            met["buffer_fill"] = float(take)
            met["survivors"] = float(take) - float(met["rejected"])
            met["crashed"] = pend["crashed"]
            pend.update(attempted=0, down=0, crashed=0.0)
            mets.append(met)

        return cur._replace(bits=bits, round=state.round + len(mets)), mets
