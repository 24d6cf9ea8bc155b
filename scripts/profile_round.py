"""Where a FedCAMS round of the PyTorch port spends its time on the card.

    python3 scripts/profile_round.py [route ...]

Runs the configuration of ``chip_smoke.py`` (ConvMixer-256-8, fedcams,
m = 100, n = 10, K = 3, batch 20, TF32 off) on the named routes of
``chip_smoke.py`` (default: all of them):

    a  blocktopk 1/64, track_gamma=False: topk_ef_sparse + fedams_ingest
    b  blocktopk 1/64, track_gamma=True: topk_ef_sparse + fedams_update
    c  sign, in memory: sign_ef + fedams_update
    d  sign over the packed wire: pack_uint/unpack_uint (n = 1, fused)
    e  blocktopk 1/64, dense uplink: topk_ef + fedams_update
    f  as e over the packed wire: pack_uint/unpack_uint (n = 11)

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

import torch  # noqa: E402

M, N_CLI, K_STEPS, BATCH = 100, 10, 3, 20
#: the __global__ functions of src/repro_torch/kernels/csrc/
PORT_KERNELS = ("topk_ef_sparse_kernel", "topk_ef_kernel", "sign_ef_kernel",
                "pack_bits_kernel", "pack_groups_kernel",
                "unpack_bits_kernel", "unpack_groups_kernel",
                "fedams_ingest_kernel", "fedams_update_kernel")
WARMUP, TIMED, PROFILED = 1, 3, 3


ROUTES = {
    "a": dict(track_gamma=False),
    "b": {},
    "c": dict(compressor="sign"),
    "d": dict(compressor="sign", wire=True),
    "e": dict(sparse_uplink=False),
    "f": dict(sparse_uplink=False, wire=True),
}


def _sim(route: str):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.sim import FedSim
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import init_params
    cfg = cm.ConvMixerConfig()
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=K_STEPS, num_clients=M, participating=N_CLI,
              compressor="blocktopk", compress_ratio=1 / 64)
    kw.update(ROUTES[route])
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
    data = FederatedClassification(num_clients=M, image_shape=(32, 32, 3),
                                   alpha=0.3, seed=0)
    gen = torch.Generator().manual_seed(1)
    routes = sys.argv[1:] or list(ROUTES)
    unknown = [r for r in routes if r not in ROUTES]
    if unknown:
        sys.exit(f"profile_round.py: unknown route(s) {unknown}; "
                 f"routes are {sorted(ROUTES)}")
    out = {"card": torch.cuda.get_device_name(0)}
    for route in routes:
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
