"""The language-model cell's run on the CPU at a smoke size (gloo, one
rank): its result line, the port's step against the plain xLSTM FedCAMS
reference, the float8 control and the planted faults coming out not
correct, and the reference model's layout against the port's. The cell is
held out of BENCHMARK.json (PERF.md says why); its files stay, and these
tests keep them honest."""
from __future__ import annotations

import contextlib
import dataclasses
import math

import pytest
import torch

from smoke_cells import harness, run_smoke, smoke_cell

CELL = "xlstm-350m-2l.train4k"


def test_result_line_and_agreement():
    out = run_smoke(CELL, 2**31 + 3, trace=True, seconds=0.5)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    # held out of BENCHMARK.json (PERF.md): no per-layer metric is its
    assert out["metrics"] == {}
    assert set(out["checks"]) == set(smoke_cell(CELL).workload["limits"])


def test_control_is_not_correct():
    from perfbench.drivers.mesh_round import Driver
    cell = smoke_cell(CELL)
    drv = Driver(cell, 5, torch.device("cpu"))
    drv.release()
    numbers, limits = drv.control(), cell.workload["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@contextlib.contextmanager
def state_unchanged():
    """Every round hands back a copy of the state it was given."""
    from repro_torch.launch.programs import TrainStep
    whole = TrainStep.__call__

    def call(self, state, *a, **k):
        kept = type(state)(*(_clone(t) for t in state))
        _, met = whole(self, state, *a, **k)
        return kept, met

    TrainStep.__call__ = call
    try:
        yield
    finally:
        TrainStep.__call__ = whole


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.clone() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_is_not_correct(fault):
    from perfbench.tools.readings import half_batch
    plant = (state_unchanged() if fault == "state_unchanged"
             else half_batch(smoke_cell(CELL)))
    with plant:
        out = run_smoke(CELL, 9, seconds=0.2)
    assert out["correct"] is False, out["checks"]


def test_reference_layout_is_the_ports():
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.params import leaves_with_paths
    from perfbench.drivers.mesh_round import port_config
    from perfbench.reference import xlstm
    config = harness.load_cell(CELL).config
    cfg = port_config(config)
    assert dataclasses.replace(cfg, num_layers=24, dtype="bfloat16") == \
        get_arch("xlstm-350m").model
    port = [(p, tuple(d.shape)) for p, d in
            leaves_with_paths(Model(cfg).defs())]
    mine = [(p, s) for p, s, _, _ in xlstm.layout(config["model"])]
    assert mine == port
    assert sum(math.prod(s) for _, s in mine) == config["params"] \
        == 123_092_992
