"""The plain reference against the port's entries, at CPU sizes: a whole run
of each cell (set-up, window, reference, comparison) comes out correct."""

import pytest
import torch

from benchmark import harness
from benchmark.conftest import write_small_cells

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_the_port_agrees_with_the_reference(cell, tmp_path):
    # Eight scans a batch, as the cells run them: a median over the scans needs them.
    spec = write_small_cells(tmp_path, traffic={t: {"batch": 8} for t in ("offset.b8", "regions.b8")})
    r = harness.run(cell, 2**33 + 17, 0.2, False, device=CPU, spec=spec, traffic_dir=tmp_path)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # The pose gaps are rounding's, far inside their limits.
    gaps = {k: v for k, v in r["checks"].items() if k.endswith(("_m", "_deg"))}
    assert gaps and all(v["value"] <= v["limit"] / 10 for v in gaps.values()), gaps


@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_a_seed_gives_the_same_inputs(cell, small_cells):
    from benchmark.traffic import generator

    spec, tmp = small_cells
    c = harness.Cell.load(cell, spec, tmp)
    a, b = (generator.make(c.config, c.traffic, 2**31 + 5, CPU) for _ in range(2))
    other = generator.make(c.config, c.traffic, 2**31 + 6, CPU)
    first = (lambda d: d.map_points) if cell.startswith("s2m") else (lambda d: d.local_map)
    assert torch.equal(first(a), first(b))
    assert not torch.equal(first(a), first(other))
