"""The benchmark's cells cut to a size a CPU test run holds: the same
files, with the model's widths and the traffic's sizes made small. Used by
the tests only; no cell runs at these sizes on the card."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from perfbench import harness  # noqa: E402

#: each driver's smoke cut: model keys and traffic keys replaced
SMOKE = {
    "fedsim_round": dict(
        model=dict(dim=16, depth=2, kernel=3, patch=4, image=16),
        data=dict(image_shape=[16, 16, 3]),
        fed=dict(num_clients=8, participating=3, local_steps=2),
        traffic=dict(batch=4, pool_rounds=5)),
    "mesh_round": dict(
        model=dict(d_model=64, vocab_size=256),
        config=dict(compute_dtype="float32", reference_rows=1),
        data=dict(vocab_size=256),
        fed={},
        traffic=dict(batch=2, seq_len=16, pool_rounds=3)),
}


def smoke_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cut = SMOKE[cell.workload["driver"]]
    cell.config["model"].update(cut["model"])
    cell.config.update(cut.get("config", {}))
    cell.traffic["data"].update(cut["data"])
    cell.traffic["fed"].update(cut["fed"])
    cell.traffic.update(cut["traffic"])
    cell.workload["trace_rounds"] = 2
    return cell


def run_smoke(name: str, seed: int, trace: bool = False,
              seconds: float = 0.3) -> dict:
    import time
    return harness.run(smoke_cell(name), seed, seconds, trace,
                       started=time.perf_counter(), device="cpu")
