"""One run of one cell: set-up, the measured window, the traced rounds, the
check of what the timed path produced, and the result's line.

Everything that belongs to one cell is found by name under ``perfbench/``:
the cell (``workloads/<cell>.json``: its configuration, traffic mix,
driver, chips, the end-to-end metrics it reports, the rounds its traced
run profiles and the limits of its check), the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``),
the driver (``drivers/<driver>.py``) and each per-layer metric
(``metrics/<metric>.py``, a reader of the traced run that returns None
where it finds nothing to read). Which per-layer metrics a cell reports
is ``BENCHMARK.json``'s to say, and nothing else's: each entry of
``per_layer`` with the cell in its ``workloads``, or without that key and
moving an end-to-end metric the cell reports.

A driver is built from the cell, the seed and the device: building it is
the set-up (weights, the traffic's pool, the program, its first rounds).
``call()`` runs one round, the window's timed call, and ``read(result)``
reads its metrics on the host; ``release()`` frees the program and its
state, ``check()`` then runs the reference and returns the numbers
compared, ``flops_per_round()`` gives the model FLOPs of a round and, where
the cell reads the port's kernels' roofline, ``kernel_bytes_per_round()``
the bytes those kernels must move in a round.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent

#: top-level module names that may not be loaded in a run: the JAX stack
#: and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the host-side range the traced run puts around each profiled round
ROUND_RANGE = "perfbench.round"

#: how many entries each list of ``breakdown`` keeps
BREAKDOWN_ENTRIES = 10


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict


def _load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_cell(name: str) -> Cell:
    wl = _load("workloads", name)
    return Cell(name, wl, _load("configs", wl["config"]),
                _load("traffic", wl["traffic"]))


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Window:
    """The measured window: each round's host time from the previous
    round's read to its own, each call's host time from entry to return,
    and the window's length."""
    round_s: list = field(default_factory=list)
    call_s: list = field(default_factory=list)
    failed: int = 0
    seconds: float = 0.0


def measure(drv, seconds: float) -> Window:
    """Rounds, each a call and its read, until ``seconds`` have passed; the
    window ends with the last round's read."""
    w = Window()
    start = last = time.perf_counter()
    while last - start < seconds:
        t0 = time.perf_counter()
        out = drv.call()
        t1 = time.perf_counter()
        ok = drv.read(out)
        t2 = time.perf_counter()
        w.call_s.append(t1 - t0)
        w.round_s.append(t2 - last)
        w.failed += not ok
        last = t2
    w.seconds = last - start
    return w


@dataclass
class Trace:
    """What the traced rounds left, in the profiler's nanoseconds: the
    device's operations (kernels, copies, sets) and the host's, the
    profiled rounds' ranges, and beside them what the readers divide by."""
    device: list            # (name, start, end)
    host: list              # (name, start, end)
    rounds: list            # (start, end) of each profiled round
    call_s: list            # host seconds of each call of the window
    round_s: float          # the window's seconds a round
    flops_per_round: Optional[float]
    peaks: Optional[dict]
    precision: str
    kernel_bytes: Optional[dict] = None   # bytes a round by device function

    @property
    def window(self):
        return self.rounds[0][0], self.rounds[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's operations inside the window, as
        sorted disjoint (start, end) intervals."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9


def profile(drv, rounds: int, device) -> tuple:
    """``rounds`` rounds under ``torch.profiler``, each a call and its read
    inside :data:`ROUND_RANGE`. Returns (device events, host events, round
    ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        for _ in range(rounds):
            with record_function(ROUND_RANGE):
                drv.read(drv.call())
        if device.type == "cuda":
            torch.cuda.synchronize()
    dev, host, ranges = [], [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a host range shows on the device's timeline too: not work
            if not e.is_user_annotation() and e.name() != ROUND_RANGE:
                dev.append((e.name(),) + span)
        elif e.name() == ROUND_RANGE:
            ranges.append(span)
        else:
            host.append((e.name(),) + span)
    ranges.sort()
    return dev, host, ranges


def _reports(metric: dict, cell: Cell) -> bool:
    """Whether ``BENCHMARK.json``'s per-layer ``metric`` is ``cell``'s."""
    if "workloads" in metric:
        return cell.name in metric["workloads"]
    return metric["moves"] in cell.workload["end_to_end"]


def readers(cell: Optional[Cell] = None) -> dict:
    """The per-layer metrics' readers, ``perfbench/metrics/<name>.py``, by
    name: those ``BENCHMARK.json`` gives ``cell``, or all it names."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]
             if cell is None or _reports(m, cell)]
    return {name: importlib.import_module(f"perfbench.metrics.{name}")
            for name in names}


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the device inside the window, each named by the
    innermost host operation running at its middle."""
    by_name = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    lo, hi = trace.window
    busy = trace.busy_intervals()
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    named = []
    for length, start in gaps[:BREAKDOWN_ENTRIES]:
        mid = start + length / 2
        under = [(s, name) for name, s, e in trace.host if s <= mid < e]
        what = max(under)[1] if under else "no host operation"
        named.append([_short(f"idle during {what}"), length / 1e9])
    return {"device_ops": [[_short(n), t / 1e9] for n, t in ops],
            "idle_gaps": named}


def end_to_end(wanted: list, w: Window, setup_s: float,
               peak_bytes: int) -> dict:
    """The cell's end-to-end metrics, as the benchmark measures them."""
    values = {
        "round_ms": ("ms", lambda: w.seconds * 1e3 / len(w.round_s)),
        "round_p90_ms": ("ms", lambda: (statistics.quantiles(
            w.round_s, n=10, method="inclusive")[-1] if len(w.round_s) > 1
            else w.round_s[0]) * 1e3),
        "peak_mem_gb": ("GB", lambda: peak_bytes / 1e9),
        "setup_s": ("s", lambda: setup_s),
    }
    return {name: {"value": values[name][1](), "unit": values[name][0]}
            for name in wanted}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        started: float, device="cuda", driver_cls=None) -> dict:
    """One run of ``cell``; ``started`` is the process's start on the host
    clock. Returns the result (its ``checks`` last). ``device`` is where
    the program runs: the card (a run on the command line) or the CPU (the
    tests, which also may hand in another driver class)."""
    import torch

    device = torch.device(device)
    if driver_cls is None:
        driver_cls = importlib.import_module(
            f"perfbench.drivers.{cell.workload['driver']}").Driver
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv = driver_cls(cell, seed, device)
    setup_s = time.perf_counter() - started
    print("perfbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in getattr(drv, "setup_parts", {}).items())
        + f"; all {setup_s:.3f} s", file=sys.stderr)
    w = measure(drv, seconds)
    tr = None
    if trace:
        dev, host, ranges = profile(drv, cell.workload["trace_rounds"],
                                    device)
        peaks = None
        kind = "cpu"
        if device.type == "cuda":
            from perfbench.counts.peaks import device_peaks
            kind = torch.cuda.get_device_name(device)
            peaks = device_peaks(kind)
        tr = Trace(dev, host, ranges, w.call_s, w.seconds / len(w.round_s),
                   drv.flops_per_round(), peaks,
                   cell.config["compute_dtype"],
                   getattr(drv, "kernel_bytes_per_round", dict)())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    drv.release()
    # the cell's limits name the numbers it compares; a number the check
    # gives beside them is not compared there (PERF.md says why)
    limits = cell.workload["limits"]
    numbers = drv.check()
    numbers = {k: numbers[k] for k in limits}
    checks = {k: {"value": v if math.isfinite(v) else str(v),
                  "limit": limits[k]} for k, v in numbers.items()}
    correct = w.failed == 0 and all(math.isfinite(v) and v <= limits[k]
                                    for k, v in numbers.items())
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.workload["chips"],
                "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(w.round_s),
              "failed": w.failed}
    if tr is None:
        result["metrics"] = end_to_end(cell.workload["end_to_end"], w,
                                       setup_s, peak)
    else:
        metrics = {}
        for name, mod in readers(cell).items():
            value = mod.read(tr)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        result["metrics"] = metrics
        if tr.device:
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
            result["breakdown"] = breakdown(tr)
    result["device"] = dev_info
    result["checks"] = checks
    return result
