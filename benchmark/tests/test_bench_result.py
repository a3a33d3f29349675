"""The result line and the exits: its keys, its metrics, the checks as the
last lines of standard error, and no result where the process holds JAX or
where the card is missing."""

import io
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.conftest import ROOT

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _emit(result):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.emit(result, out, err)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(trace, small_cells):
    spec, tmp = small_cells
    r = harness.run("s2m.b8", 2**31 + 7, 0.1, trace, device=CPU, spec=spec, traffic_dir=tmp)
    rc, out, err = _emit(r)
    assert rc == 0
    line = json.loads(out[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) <= set(KEYS) | {"checks", "breakdown"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec[kind] if "s2m.b8" in m.get("workloads", ["s2m.b8"])}
    assert set(line["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "vfm_icp.ms" in line["metrics"] and "match.ms" in line["metrics"]
    else:
        # The device's busy time has no device to read here.
        device = {m["name"] for m in spec[kind] if m["source"] == "device_trace"}
        assert set(line["metrics"]) == names - device
        assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    checks = [e for e in err if e.startswith("check ")]
    assert checks == err[-len(line["checks"]):]
    assert [c.split()[1] for c in checks] == list(line["checks"])


def test_no_result_where_jax_is_loaded():
    sys.modules["jax"] = types.ModuleType("jax")
    try:
        rc, out, err = _emit({"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
                              "checks": {}})
    finally:
        del sys.modules["jax"]
    assert rc != 0 and out == [] and "jax" in err[-1]


def test_the_banned_names_are_compared_whole():
    sys.modules["vfmreg_tpu_torch_probe"] = types.ModuleType("vfmreg_tpu_torch_probe")
    try:
        assert "vfmreg_tpu" not in harness.banned_modules()
    finally:
        del sys.modules["vfmreg_tpu_torch_probe"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Where torch sees no card (this machine), and in a directory that holds
    only BENCHMARK.json and the benchmark's files (the card's machine too):
    a nonzero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the first case does not arise")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "s2m.b8", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                           timeout=300, env=dict(os.environ, BENCH_RUN="x"))
        assert p.returncode != 0
        assert not any(ln.startswith("{") for ln in p.stdout.splitlines())
