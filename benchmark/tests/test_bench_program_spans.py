"""The readers of the program's own spans (`benchmark/program_spans.py` and
the metrics that use it) on a made-up trace: idle time put down to a span
by intersection (a gap that straddles a span's end counts in part, a span
that occurs twice in a call counts twice), kernel-launch calls counted
where they start inside a span, nested or not, and every such metric None
where the trace has no device operation or no such span, and on the CPU
small cells."""

import json

import pytest

from benchmark import harness, program_spans

NEW = ["voxel.idle_ms", "vfm_icp.phase1.idle_ms", "vfm_icp.phase2.idle_ms", "vfm_icp.phase1.launches_per_scan",
       "icp_rows.idle_ms", "ransac.idle_ms"]

# Busy on the card: [50, 100], [200, 350] (two overlapping kernels), [500, 520] (a copy), [700, 800];
# idle in the window [0, 1000]: [0, 50], [100, 200], [350, 500], [520, 700], [800, 1000].
OPS = [("k1", 50.0, 100.0, True), ("k2", 200.0, 300.0, True), ("k3", 280.0, 350.0, True),
       ("Memcpy DtoH", 500.0, 520.0, False), ("k4", 700.0, 800.0, True)]
S2M_HOST = [
    ("bench.window", 0.0, 1000.0),
    ("vfmreg.scan_to_map", 40.0, 990.0),
    ("vfmreg.queries", 60.0, 180.0),  # idle [100, 180]: 80
    ("vfmreg.vfm_icp", 300.0, 850.0),
    ("vfmreg.vfm_icp.phase1", 300.0, 420.0),  # idle [350, 420]: 70 of a gap that runs on to 500
    ("cudaLaunchKernel", 305.0, 306.0),
    ("cudaLaunchKernel", 310.0, 311.0),
    ("aten::mul", 312.0, 330.0),
    ("cudaLaunchKernel", 315.0, 316.0),  # nested in aten::mul
    ("cudaMemcpyAsync", 320.0, 321.0),  # not a launch
    ("vfmreg.vfm_icp.phase1", 600.0, 650.0),  # the same span again in the call: idle 50
    ("cuLaunchKernel", 610.0, 611.0),
    ("vfmreg.vfm_icp.phase2", 650.0, 850.0),  # idle [650, 700] and [800, 850]: 100
    ("cudaLaunchKernel", 660.0, 661.0),
]
ROW_HOST = [
    ("bench.window", 0.0, 1000.0),
    ("vfmreg.row", 0.0, 980.0),
    ("vfmreg.row.gt_refine_icp", 100.0, 360.0),  # idle [100, 200], [350, 360]: 110
    ("vfmreg.icp.loop", 120.0, 340.0),
    ("vfmreg.row.vanilla_icp", 360.0, 520.0),  # idle [360, 500]: 140
    ("vfmreg.row.snap", 520.0, 560.0),  # with ransac: idle [520, 640]: 120
    ("vfmreg.row.ransac", 560.0, 640.0),
    ("vfmreg.row.preprocess", 900.0, 950.0),  # idle 50
]


def _ctx(host, **kw):
    ctx = {"ops": OPS, "host": host, "trace_calls": 2, "trace_attempted": 16}
    ctx.update(kw)
    return ctx


def read(name, ctx):
    return harness.load_metric(name).read(ctx)


def test_idle_intervals_and_their_overlap():
    assert program_spans.idle(_ctx(S2M_HOST)) == [(0.0, 50.0), (100.0, 200.0), (350.0, 500.0), (520.0, 700.0),
                                                  (800.0, 1000.0)]
    spans = program_spans.extents(_ctx(S2M_HOST), ["vfm_icp.phase1", "vfm_icp.phase2"])
    assert spans == [(300.0, 420.0), (600.0, 850.0)]
    assert program_spans.overlap(program_spans.idle(_ctx(S2M_HOST)), spans) == 220.0


def test_idle_is_put_down_by_intersection():
    ctx = _ctx(S2M_HOST)
    assert read("voxel.idle_ms", ctx) == pytest.approx(80e-3 / 2)
    assert read("vfm_icp.phase1.idle_ms", ctx) == pytest.approx(120e-3 / 2)
    assert read("vfm_icp.phase2.idle_ms", ctx) == pytest.approx(100e-3 / 2)
    # By a gap's middle, [350, 500] (middle 425) would give phase 1 nothing.
    assert program_spans.idle_ms(ctx, ["vfm_icp.phase1"]) > 50e-3 / 2
    ctx = _ctx(ROW_HOST)
    assert read("icp_rows.idle_ms", ctx) == pytest.approx(250e-3 / 2)
    assert read("ransac.idle_ms", ctx) == pytest.approx(120e-3 / 2)
    assert read("voxel.idle_ms", ctx) == pytest.approx(50e-3 / 2)
    # A nested span adds nothing to its stage's union.
    assert program_spans.idle_ms(ctx, ["row.gt_refine_icp", "icp.loop"]) == pytest.approx(110e-3 / 2)


def test_launches_nested_in_a_span():
    ctx = _ctx(S2M_HOST)
    assert program_spans.launches(ctx, ["vfm_icp.phase1"]) == 4
    assert read("vfm_icp.phase1.launches_per_scan", ctx) == pytest.approx(4 / 16)
    assert program_spans.launches(ctx, ["vfm_icp.phase2"]) == 1
    assert read("vfm_icp.phase1.launches_per_scan", _ctx(S2M_HOST, trace_attempted=0)) is None


def test_none_without_device_operations_or_spans():
    for name in NEW:
        assert read(name, _ctx([("bench.window", 0.0, 1000.0)])) is None, name
        assert read(name, _ctx([], ops=[])) is None, name
    for name in ("icp_rows.idle_ms", "ransac.idle_ms"):
        assert read(name, _ctx(S2M_HOST)) is None
    for name in ("vfm_icp.phase1.idle_ms", "vfm_icp.phase2.idle_ms", "vfm_icp.phase1.launches_per_scan"):
        assert read(name, _ctx(ROW_HOST)) is None
    # Idle time needs the device's operations; a launch count only the host's calls.
    assert [read(n, _ctx(S2M_HOST, ops=[])) for n in NEW[:3]] == [None] * 3
    assert read("vfm_icp.phase1.launches_per_scan", _ctx(S2M_HOST, ops=[])) == pytest.approx(4 / 16)
    # No window mark: nothing to measure against.
    assert read("vfm_icp.phase1.idle_ms", _ctx(S2M_HOST[1:])) is None


def test_the_metrics_are_declared():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["moves"] == "scans_per_s", name
        assert (harness.BENCH / "metrics" / f"{name}.py").exists()


@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_none_on_the_cpu_small_cells(cell, small_cells):
    import torch

    spec, tmp = small_cells
    r = harness.run(cell, 2**31 + 11, 0.05, True, device=torch.device("cpu"), spec=spec, traffic_dir=tmp)
    assert not set(NEW) & set(r["metrics"])
