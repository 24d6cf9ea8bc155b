"""``python -m repro_torch.launch.dryrun`` as a user runs it: one case
(gemma2-2b, decode_32k, the 16 × 16 production mesh) in a subprocess,
its JSON held to ``tests/test_artifacts.py``'s checks (status, compute_s
> 0, memory_s > 0, the dominant term, 0 < useful_ratio < 10) and to the
port's own fields (trace time, memory, collectives, ops); a second
invocation skips the cached case."""
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KEY = "baseline/pod16x16/gemma2-2b/decode_32k"


def _run(out):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "decode_32k", "--mesh", "single", "--out",
         out], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))


def test_dryrun_cli_one_case_and_resume(tmp_path):
    out = str(tmp_path / "results" / "dryrun_torch.json")
    first = _run(out)
    assert first.returncode == 0, first.stderr[-3000:]
    assert f"[ok] {KEY}" in first.stdout, first.stdout
    res = json.load(open(out))
    assert list(res) == [KEY]
    v = res[KEY]
    assert v["status"] == "ok" and v["description"] == "decode"
    rl = v["roofline"]
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert 0 < rl["useful_ratio"] < 10
    assert rl["chips"] == 256 and v["trace_s"] >= 0 and v["ops"] > 0
    mem = v["memory"]
    assert mem["argument_size"] > 0 and mem["temp_size"] > 0
    assert mem["generated_code_size"] is None
    # decode at tp 16 all-reduces every branch's output over "model"
    assert v["collectives"]["bytes_by_kind"]["all-reduce"] > 0
    assert rl["collective_s"] > 0
    second = _run(out)
    assert second.returncode == 0, second.stderr[-3000:]
    assert f"[skip-cached] {KEY}" in second.stdout
    assert json.load(open(out)) == res
