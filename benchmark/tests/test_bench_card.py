"""On the card: one short run of each cell through the command, as the
check runs it; skipped where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_a_short_run_on_the_card(cell, card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
