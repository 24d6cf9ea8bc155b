"""A run of the benchmark, driven on the CPU at a smoke size with the look
for a card skipped: its result line, that the port agrees with the plain
reference there, that the control and the planted faults come out not
correct, that no JAX module is loaded, and that a run on the command line
without a card fails."""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from smoke_cells import ROOT, harness, run_smoke, smoke_cell

CELL = "convmixer-256-8.sync"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    out = run_smoke(CELL, 2**31 + 11, trace)
    keys = KEYS + (["breakdown"] if trace and "breakdown" in out else [])
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = (["host_call_ms"] if trace else
            smoke_cell(CELL).workload["end_to_end"])
    assert sorted(out["metrics"]) == sorted(want)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(smoke_cell(CELL).workload["limits"])
    json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_port_agrees_with_reference(seed):
    out = run_smoke(CELL, seed)
    assert out["correct"], out["checks"]


def test_control_is_not_correct():
    """The reference in TF32, in the program's place, fails a limit."""
    cell = smoke_cell(CELL)
    drv = harness.importlib.import_module(
        "perfbench.drivers.fedsim_round").Driver(cell, 5, torch.device("cpu"))
    drv.release()
    numbers = drv.control()
    limits = cell.workload["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@contextlib.contextmanager
def state_unchanged():
    """Every round returns the state it was given."""
    from repro_torch.core.sim import FedSim
    whole = FedSim.round

    def round_(self, state, *a, **k):
        _, met = whole(self, state, *a, **k)
        return state, met

    FedSim.round = round_
    try:
        yield
    finally:
        FedSim.round = whole


@contextlib.contextmanager
def error_rows_lost():
    """Every round leaves its cohort's error rows at zero, as a top-k that
    wrote no residual would."""
    from repro_torch.core.sim import FedSim
    whole = FedSim.round

    def round_(self, state, batches, ids, *a, **k):
        st, met = whole(self, state, batches, ids, *a, **k)
        rows = torch.as_tensor(ids, device=st.errors.device)
        return st._replace(errors=st.errors.index_fill(0, rows, 0.0)), met

    FedSim.round = round_
    try:
        yield
    finally:
        FedSim.round = whole


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "error_rows_lost"])
def test_fault_is_not_correct(fault):
    from perfbench.tools.readings import half_batch
    plant = {"state_unchanged": state_unchanged,
             "error_rows_lost": error_rows_lost,
             "half_batch": lambda: half_batch(smoke_cell(CELL))}[fault]()
    with plant:
        out = run_smoke(CELL, 9)
    assert out["correct"] is False, out["checks"]


def test_no_jax_module_loaded():
    code = (
        "import sys, json\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from smoke_cells import run_smoke, harness\n"
        "run_smoke('convmixer-256-8.sync', 4, True)\n"
        "print(json.dumps({'forbidden': harness.forbidden_modules(),\n"
        "    'port': 'repro_torch' in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "perfbench" / "tests"),
         str(ROOT)], capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    seen = json.loads(done.stdout.strip().splitlines()[-1])
    assert seen == {"forbidden": [], "port": True}


def test_forbidden_names_compared_whole():
    before = harness.forbidden_modules()
    fakes = ("reproduce_x", "jaxtyping", "repro_torch_x.sub")
    try:
        for name in fakes:
            sys.modules[name] = sys
        assert harness.forbidden_modules() == before
        sys.modules["jax.perfbench_fake"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        for name in fakes + ("jax.perfbench_fake",):
            sys.modules.pop(name, None)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks a machine without one")
    done = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "needs 1 CUDA card" in done.stderr
