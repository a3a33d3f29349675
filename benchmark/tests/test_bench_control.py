"""The comparison's control: the plain reference computed on TF32-rounded
operands, standing in the program's place, fails the comparison, while the
reference in f32 passes against itself. CPU sizes, a short ICP budget."""

import pytest
import torch

from benchmark import harness
from benchmark.conftest import write_small_cells
from benchmark.reference import plain
from benchmark.traffic import generator

CPU = torch.device("cpu")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 100.123456], dtype=torch.float32)
    r = plain.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0  # a tie goes to the even mantissa
    assert r[3] == 1.0 + 2**-9
    assert abs(float(r[4]) - 100.123456) <= 2**6 * 2**-11


@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_the_tf32_control_fails_and_f32_passes(cell, tmp_path, monkeypatch):
    spec = write_small_cells(tmp_path, configs={"vfm-scan-to-map": {"max_iterations": 60}})
    c = harness.Cell.load(cell, spec, tmp_path)
    reference = __import__(f"benchmark.reference.{c.config['entry']}", fromlist=["answers"])
    if hasattr(reference, "MAX_ITERATIONS"):
        monkeypatch.setattr(reference, "MAX_ITERATIONS", 60)
    limits = c.config["limits"]
    for seed in (11, 12, 13):
        state = reference.prepare(generator.make(c.config, c.traffic, seed, CPU), c.config)
        ref = reference.answers(state)
        same = reference.judge(state, [dict(a, batch=k) for k, a in enumerate(ref)], ref)
        assert all(v == 0 for v in same.values()), same
        control = reference.answers(state, tf32=True)
        numbers = reference.judge(state, [dict(a, batch=k) for k, a in enumerate(control)], ref)
        assert set(numbers) == set(limits)
        assert any(numbers[k] > limits[k] for k in numbers), numbers
