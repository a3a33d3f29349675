"""Nothing the benchmark runs imports JAX or the JAX package (top-level names
compared whole: vfmreg_tpu_torch is the port), and nothing under
benchmark/ reads the JAX package's benchmark."""

import ast
import subprocess
import sys

from benchmark import harness
from benchmark.conftest import ROOT

BENCH = ROOT / "benchmark"


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.BANNED, f"{path}: imports {n}"
        assert "bench" + ".py" not in path.read_text(), path


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
from benchmark.conftest import write_small_cells
from pathlib import Path
tmp = Path({str(tmp_path)!r})
spec = write_small_cells(tmp)
for cell in ("s2m.b8", "row.b8"):
    harness.run(cell, 3, 0.05, False, device=torch.device("cpu"), spec=spec, traffic_dir=tmp)
print("BANNED", harness.banned_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[-1] == "BANNED []"
