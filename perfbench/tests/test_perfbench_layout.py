"""``BENCHMARK.json`` against the files of ``perfbench/``: every cell,
configuration, traffic mix, driver and per-layer metric is found by name,
and the names and entries keep the benchmark's format."""
from __future__ import annotations

import json
import re

import pytest

from smoke_cells import ROOT, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.load_cell(cell)
    assert wl.workload["config"] == entry["config"]
    assert wl.workload["traffic"] == entry["traffic"]
    assert wl.workload["chips"] == entry["chips"] == 1
    assert wl.workload["why"] == entry["why"]
    assert (ROOT / "perfbench" / "drivers"
            / f"{wl.workload['driver']}.py").is_file()
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"perfbench/configs/{entry['config']}.json"
    family = wl.config["family"]
    parts = ("reference", "counts") + (
        ("ports",) if wl.workload["driver"] == "fedsim_round" else ())
    for part in parts:
        assert (ROOT / "perfbench" / part / f"{family}.py").is_file()
    for text in (entry["why"], config["why"], config["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_metrics(cell):
    wl = harness.load_cell(cell).workload
    for name in wl["end_to_end"]:
        entry = next(m for m in BENCH["end_to_end"] if m["name"] == name)
        assert cell in entry.get("workloads", CELLS)
    for m in BENCH["end_to_end"]:
        if cell in m.get("workloads", CELLS):
            assert m["name"] in wl["end_to_end"]
    assert "setup_s" in wl["end_to_end"] and len(wl["end_to_end"]) >= 2
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


def test_every_per_layer_metric_has_a_reader():
    readers = harness.readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in readers
        assert readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reads_what_benchmark_json_gives_it(cell):
    """The harness runs a cell's per-layer readers from BENCHMARK.json's
    ``workloads`` lists alone."""
    want = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert want and set(harness.readers(harness.load_cell(cell))) == want


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
