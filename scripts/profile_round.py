"""Where a FedCAMS round of the PyTorch port spends its time on the card.

    python3 scripts/profile_round.py

Runs the configuration of ``chip_smoke.py`` (ConvMixer-256-8, fedcams +
blocktopk 1/64, m = 100, n = 10, K = 3, batch 20, TF32 off) on both server
routes. After a warm-up round:

* rounds 1-3 unprofiled: wall ms per round (host clock, synchronized);
* rounds 4-6 under ``torch.profiler``, per round: for each stage that
  ``FedSim`` marks with a ``fedsim.<stage>`` range (host → device, local
  training, uplink → ``topk_ef_sparse``, server → ``fedams_ingest`` or
  scatter-mean + γ + ``server_update`` → ``fedams_update``, downlink), the
  device time of the kernels launched while the range was open — from any
  host thread, so the autograd engine's backward kernels count for local
  training — and the host time of the range (inflated by the profiler);
  device time by kernel; and the device's busy time (summed kernel time;
  one stream, so kernels do not overlap) against the unprofiled round.

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

import torch  # noqa: E402

M, N_CLI, K_STEPS, BATCH = 100, 10, 3, 20
WARMUP, TIMED, PROFILED = 1, 3, 3


def _sim(route: str):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.sim import FedSim
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import init_params
    cfg = cm.ConvMixerConfig()
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=K_STEPS, num_clients=M, participating=N_CLI,
              compressor="blocktopk", compress_ratio=1 / 64)
    if route == "a":
        kw.update(track_gamma=False)
    sim = FedSim(lambda p, b: cm.convmixer_loss(p, b, cfg), FedConfig(**kw))
    st = sim.init(init_params(cm.convmixer_defs(cfg),
                              torch.Generator().manual_seed(0)))
    return sim, st


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _breakdown(events, rounds: int):
    """Per stage: summed device time of the kernels launched inside it and
    the host time of its range; per kernel name: count and device time.
    All per round."""
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("fedsim."):])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith("fedsim."))
    starts = [s[0] for s in stages]
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
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        inside = i >= 0 and ts <= stages[i][1]
        stage_dev[stages[i][2] if inside else "(outside the stages)"] += ms
    stage_ms = {name: {"device_ms": stage_dev.get(name, 0.0) / rounds,
                       "host_ms": stage_host.get(name, 0.0) / rounds}
                for name in dict.fromkeys(s[2] for s in stages)}
    if "(outside the stages)" in stage_dev:
        stage_ms["(outside the stages)"] = {
            "device_ms": stage_dev["(outside the stages)"] / rounds,
            "host_ms": None}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    return stage_ms, busy / rounds, [
        {"name": k[:90], "count": c / rounds, "device_ms": ms / rounds}
        for k, (c, ms) in top]


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_round.py needs CUDA")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sampling import sample_clients
    from repro_torch.data.synthetic import FederatedClassification
    torch.backends.cudnn.allow_tf32 = False     # as chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    data = FederatedClassification(num_clients=M, image_shape=(32, 32, 3),
                                   alpha=0.3, seed=0)
    gen = torch.Generator().manual_seed(1)
    out = {"card": torch.cuda.get_device_name(0)}
    for route in ("a", "b"):
        sim, st = _sim(route)
        plan = []
        for r in range(WARMUP + TIMED + PROFILED):
            idx = sample_clients(gen, M, N_CLI).numpy()
            plan.append((idx, data.round_batches(idx, r, K_STEPS, BATCH)))
        for idx, b in plan[:WARMUP]:
            st, _ = sim.round(st, b, idx)
        torch.cuda.synchronize()
        wall = []
        for idx, b in plan[WARMUP:WARMUP + TIMED]:
            t0 = time.perf_counter()
            st, _ = sim.round(st, b, idx)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for idx, b in plan[WARMUP + TIMED:]:
                st, _ = sim.round(st, b, idx)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        stage_ms, busy, top = _breakdown(_trace_events(prof), PROFILED)
        round_ms = statistics.median(wall)
        out[route] = {
            "round_ms": wall, "round_ms_median": round_ms,
            "rounds_profiled": PROFILED, "profiled_round_wall_ms": prof_wall,
            "stage_ms": stage_ms, "device_busy_ms": busy,
            "device_busy_share_of_unprofiled_round": busy / round_ms,
            "top_kernels": top}
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
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "profile_round.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
