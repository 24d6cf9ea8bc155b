"""Where a FedCAMS round of the PyTorch port spends its time on the card.

    python3 scripts/profile_round.py [route ...]

Runs the configuration of ``chip_smoke.py`` (ConvMixer-256-8, fedcams,
m = 100, n = 10, K = 3, batch 20, TF32 off) on the named routes of
``chip_smoke.py`` (default: all of them), each built by its
``_route_cfg`` (and, for h and i, its ``route_fault``, from this run's
cohorts):

    a  blocktopk 1/64, track_gamma=False: topk_ef_sparse + fedams_ingest
    b  blocktopk 1/64, track_gamma=True: topk_ef_sparse + fedams_update
    c  sign, in memory: sign_ef + fedams_update
    d  sign over the packed wire: pack_uint/unpack_uint (n = 1, fused)
    e  blocktopk 1/64, dense uplink: topk_ef + fedams_update
    f  as e over the packed wire: pack_uint/unpack_uint (n = 11)
    g  sign over the wire with the two-way downlink and
       ``examples/quickstart_wire.py``'s network: pack_uint/unpack_uint
       twice a round (uplink block, downlink message). ``chip_smoke.py``
       drives it through ``FederatedTrainer.run``; here its FedSim rounds
       are driven directly (the trainer adds the host-side draw of the ids
       and batches, outside the round)
    h  blocktopk 1/64 over the wire with crashes, bit flips and a deadline:
       topk_ef_sparse + the survivor-masked aggregate + fedams_update
    i  sign in memory with a scheduled crash, NaN payloads and a norm
       clip: sign_ef + validation + fedams_update
    j  blocktopk 1/64 over the wire through the async buffered engine
       (B = 5 of n = 10): topk_ef_sparse once a cohort, fedams_ingest once
       a flush. Each step here is a ``run_rounds`` call over the step's
       cohorts, which drains them, so per-round numbers are per cohort
    k  blocktopk 1/64 over the wire, m = 1,000 with the host-side EF
       store, client_chunk=5 and agg_groups=2: topk_ef_sparse twice a
       round, the grouped scatter + fedams_update; the store's gather and
       scatter run in the ``ef_store`` ranges
    l  randk 1/64 in memory, γ on, client_chunk=5: fedams_update

After a warm-up round:

* rounds 1-3 unprofiled: wall ms per round (host clock, synchronized);
* rounds 4-6 under ``torch.profiler``, per round: for each stage that
  ``FedSim`` marks with a ``fedsim.<stage>`` range (host → device, local
  training, uplink — with ``encode``/``decode`` nested inside it on the
  wire routes — server ingest, or aggregate + γ + ``server_update``,
  downlink), the device time of the kernels launched while the range was
  open — the innermost open range, from any host thread, so the autograd
  engine's backward kernels count for local training — and the host time
  of the range (inflated by the profiler); device time by kernel, the top
  15 and each of the port's own (``csrc/``) kernels; and the device's busy
  time (summed kernel time; one stream, so kernels do not
  overlap) against the unprofiled round.

Kernels are matched to their launches through the trace's correlation ids
(``export_chrome_trace``), which also covers the kernels the port launches
through ctypes. Prints a summary and writes
``chiprun_out/profile_round.json``. Needs CUDA.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

M, N_CLI, K_STEPS, BATCH = (chip_smoke.M, chip_smoke.N_CLI, chip_smoke.K_STEPS,
                            chip_smoke.BATCH)
#: the __global__ functions of src/repro_torch/kernels/csrc/
PORT_KERNELS = ("topk_ef_sparse_kernel", "topk_ef_kernel", "sign_ef_kernel",
                "pack_bits_kernel", "pack_groups_kernel",
                "unpack_bits_kernel", "unpack_groups_kernel",
                "fedams_ingest_kernel", "fedams_update_kernel")
WARMUP, TIMED, PROFILED = 1, 3, 3


def _sim(route: str, plan, m: int):
    from repro_torch.core.sim import FedSim
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import count_params, init_params
    cfg = cm.ConvMixerConfig()
    defs = cm.convmixer_defs(cfg)
    loss = lambda p, b: cm.convmixer_loss(p, b, cfg)
    p0 = init_params(defs, torch.Generator().manual_seed(0))
    fault = chip_smoke.route_fault(route, plan, m, N_CLI, K_STEPS,
                                   count_params(defs), loss, p0, "cuda")
    sim = FedSim(loss, chip_smoke._route_cfg(route, m, N_CLI, K_STEPS, fault),
                 network=chip_smoke.wire_network(m) if route in ("g", "j")
                 else None)
    return sim, sim.init(p0), fault


def _run(sim, st, plan):
    """The rounds of ``plan`` from ``st``: one ``run_rounds`` call through
    the async engine on route j, else a ``FedSim.round`` a round with a
    generator (randk's draws) and the next round's ids (the EF store's
    prefetch)."""
    if sim._async is not None:
        ids, batches = chip_smoke.stacked(plan)
        return sim.run_rounds(st, batches, ids)[0]
    for r, (idx, b) in enumerate(plan):
        st, _ = sim.round(st, b, idx, torch.Generator().manual_seed(r),
                          prefetch_idx=plan[r + 1][0] if r + 1 < len(plan)
                          else None)
    return st


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _breakdown(events, rounds: int):
    """Per stage: summed device time of the kernels launched inside it (the
    innermost range open at the launch) and the host time of its range;
    per kernel name: count and device time. All per round."""
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("fedsim."):])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith("fedsim."))
    starts = [s[0] for s in stages]

    def innermost(ts):
        """The latest-starting range that is still open at ``ts``."""
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and stages[i][1] < ts:
            i -= 1
        return stages[i][2] if i >= 0 else "(outside the stages)"

    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    stage_dev = defaultdict(float)
    stage_host = defaultdict(float)
    for t0, t1, name in stages:
        stage_host[name] += (t1 - t0) / 1e3
    by_kernel = defaultdict(lambda: [0, 0.0])
    busy = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ms = e["dur"] / 1e3
        busy += ms
        by_kernel[e["name"]][0] += 1
        by_kernel[e["name"]][1] += ms
        ts = launch_ts.get(e["args"].get("correlation"))
        stage_dev[innermost(ts) if ts is not None
                  else "(outside the stages)"] += ms
    stage_ms = {name: {"device_ms": stage_dev.get(name, 0.0) / rounds,
                       "host_ms": stage_host.get(name, 0.0) / rounds}
                for name in dict.fromkeys(s[2] for s in stages)}
    if "(outside the stages)" in stage_dev:
        stage_ms["(outside the stages)"] = {
            "device_ms": stage_dev["(outside the stages)"] / rounds,
            "host_ms": None}
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    per_round = lambda kv: {"name": kv[0][:90], "count": kv[1][0] / rounds,
                            "device_ms": kv[1][1] / rounds}
    return stage_ms, busy / rounds, [per_round(kv) for kv in rows[:15]], [
        per_round(kv) for kv in rows if any(f in kv[0] for f in PORT_KERNELS)]


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_round.py needs CUDA")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sampling import sample_clients
    from repro_torch.data.synthetic import FederatedClassification
    torch.backends.cudnn.allow_tf32 = False     # as chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    datasets = {m: FederatedClassification(num_clients=m,
                                           image_shape=(32, 32, 3),
                                           alpha=0.3, seed=0)
                for m in (M, chip_smoke.M_K)}
    gen = torch.Generator().manual_seed(1)
    routes = sys.argv[1:] or list(chip_smoke.ROUTES)
    unknown = [r for r in routes if r not in chip_smoke.ROUTES]
    if unknown:
        sys.exit(f"profile_round.py: unknown route(s) {unknown}; "
                 f"routes are {list(chip_smoke.ROUTES)}")
    out = {"card": chip_smoke.card_line()}
    print(out["card"])
    for route in routes:
        m = chip_smoke.M_K if route == "k" else M
        plan = []
        for r in range(WARMUP + TIMED + PROFILED):
            idx = sample_clients(gen, m, N_CLI).numpy()
            plan.append((idx, datasets[m].round_batches(idx, r, K_STEPS,
                                                        BATCH)))
        sim, st, fault = _sim(route, plan, m)
        if fault is not None:
            print(f"route {route}: {fault}")
        st = _run(sim, st, plan[:WARMUP])
        torch.cuda.synchronize()
        wall = []
        for step in plan[WARMUP:WARMUP + TIMED]:
            t0 = time.perf_counter()
            st = _run(sim, st, [step])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = _run(sim, st, plan[WARMUP + TIMED:])
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        stage_ms, busy, top, port = _breakdown(_trace_events(prof), PROFILED)
        round_ms = statistics.median(wall)
        out[route] = {
            "round_ms": wall, "round_ms_median": round_ms,
            "rounds_profiled": PROFILED, "profiled_round_wall_ms": prof_wall,
            "stage_ms": stage_ms, "device_busy_ms": busy,
            "device_busy_share_of_unprofiled_round": busy / round_ms,
            "top_kernels": top, "port_kernels": port}
        print(f"route {route}: unprofiled round ms {wall} (median "
              f"{round_ms:.1f}); profiled {prof_wall:.1f} ms")
        for name, t in stage_ms.items():
            print(f"  stage {name:22s} device {t['device_ms']:9.3f} ms  "
                  f"host {t['host_ms']} ms")
        print(f"route {route}: device busy {busy:.1f} ms per round, "
              f"{100 * busy / round_ms:.1f} % of the unprofiled round")
        for row in top:
            print(f"  {row['device_ms']:9.3f} ms  x{row['count']:<7g} "
                  f"{row['name']}")
        print(f"route {route}: the port's own kernels, per round")
        for row in port:
            print(f"  {row['device_ms']:9.4f} ms  x{row['count']:<7g} "
                  f"{row['name']}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "profile_round.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
