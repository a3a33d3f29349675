"""A new cell and new metrics, per layer and end to end, are found by name,
from files of their own and entries of the spec, with no file of the
harness edited."""

import json
import shutil

import pytest
import torch

from benchmark import harness
from benchmark.conftest import ROOT, write_small_cells

CPU = torch.device("cpu")
NEW_END_TO_END = '''
def read(ctx):
    return len(ctx["outputs"]) / ctx["window_s"]
'''
NEW_METRIC = '''
def read(ctx):
    return ctx["trace_attempted"] / ctx["trace_calls"] if ctx["trace_calls"] else None
'''


def test_a_new_cell_and_a_new_metric(tmp_path):
    spec = write_small_cells(tmp_path)
    traffic = json.loads((tmp_path / "offset.b8.json").read_text())
    traffic.update(batch=3, batches=1)
    (tmp_path / "offset.b3.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": "s2m.b3", "config": "vfm-scan-to-map", "traffic": "offset.b3", "chips": 1,
                              "why": "a cell added by files alone"})
    metrics = tmp_path / "metrics"
    shutil.copytree(ROOT / "benchmark" / "metrics", metrics)
    (metrics / "entry.scans_per_call.py").write_text(NEW_METRIC)
    spec["per_layer"].append({"name": "entry.scans_per_call", "unit": "scans", "better": "higher",
                              "source": "program_counter", "layer": "entry", "moves": "scans_per_s",
                              "workloads": ["s2m.b3"]})
    (metrics / "calls_per_s.py").write_text(NEW_END_TO_END)
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["s2m.b3"]})
    r = harness.run("s2m.b3", 5, 0.1, True, device=CPU, spec=spec, traffic_dir=tmp_path, metrics_dir=metrics)
    assert r["correct"]
    assert r["metrics"]["entry.scans_per_call"]["value"] == 3
    assert "vfm_icp.ms" not in r["metrics"]  # its entry lists the cells it is read in
    assert r["attempted"] % 3 == 0
    r = harness.run("s2m.b3", 5, 0.1, False, device=CPU, spec=spec, traffic_dir=tmp_path, metrics_dir=metrics)
    assert r["metrics"]["calls_per_s"]["value"] == pytest.approx(r["metrics"]["scans_per_s"]["value"] / 3)
