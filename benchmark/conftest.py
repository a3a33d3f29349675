"""Pytest settings of the benchmark's tests (`python -m pytest benchmark/tests -q`).

The `card` marker marks a test that needs an NVIDIA card: its `card`
fixture skips it where there is none, deciding when the test runs, never
when a module is imported. `small_cells` writes the benchmark's two cells
at CPU sizes into a temporary directory: a spec in BENCHMARK.json's layout
and its configuration and traffic files.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# CPU sizes of each configuration and traffic mix (the published widths stay in the real files).
SMALL_CONFIGS = {
    "vfm-scan-to-map": {"n_map": 8192, "n_scan": 1024, "descriptor_dim": 32, "n_vfm": 64},
    "eval-method-row": {"n_map": 32768, "n_scan": 2048, "descriptor_dim": 24},
}
SMALL_TRAFFIC = {"batch": 2, "batches": 2, "trace_calls": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this machine has no CUDA device")
    return torch.device("cuda", 0)


def write_small_cells(tmp: Path, configs=None, traffic=None) -> dict:
    """BENCHMARK.json with its configurations and traffic files cut to CPU
    sizes under `tmp`; `configs` / `traffic` update a configuration's or a
    traffic mix's keys by name. Returns the spec."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(SMALL_CONFIGS.get(c["name"], {}), **(configs or {}).get(c["name"], {}))
        c["file"] = str(tmp / f"{c['name']}.json")
        Path(c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        t.update(SMALL_TRAFFIC, **(traffic or {}).get(w["traffic"], {}))
        t["checked_batches"] = min(t.get("checked_batches", t["batches"]), t["batches"])
        (tmp / f"{w['traffic']}.json").write_text(json.dumps(t))
    return spec


@pytest.fixture
def small_cells(tmp_path):
    return write_small_cells(tmp_path), tmp_path
