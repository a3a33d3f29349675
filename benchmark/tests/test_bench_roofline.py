"""The yardstick's arithmetic: kernel B1's least time against PERF.md's
slice row, and the per-layer readers on a made-up trace."""

import pytest

from benchmark import harness, roofline


def test_b1_bound_matches_the_slice_row():
    # 4,096 live queries x 524,288 valid map rows x 384: 9.99556 ms, bound by operations (3xTF32).
    s = roofline.cosine_argmax_seconds(4096, 524288, 384, 524288)
    assert s * 1e3 == pytest.approx(9.99556, abs=5e-6)
    flops, nbytes = roofline.cosine_argmax_work(4096, 524288, 384, 524288)
    assert 3 * flops / roofline.TF32_FLOPS > nbytes / roofline.HBM_BYTES_PER_S


def test_the_peaks_are_the_sxm_data_sheets():
    assert (roofline.HBM_BYTES_PER_S, roofline.TF32_FLOPS, roofline.F32_FLOPS) == (3.35e12, 495e12, 67e12)


def _ctx(**kw):
    ctx = {"trace_window_s": 1.0, "busy_s": 0.25,
           "ops": [("k", 100.0, 20100.0, True), ("Memcpy HtoD", 30000.0, 30010.0, False)],
           "host": [], "trace_calls": 2, "trace_attempted": 16, "device_spans": {"match": [(50.0, 25000.0)]},
           "notes": {"match": [(4096, 524288, 384, 524288)]}, "stage_ms": {"match": [30.0, 32.0]},
           "counters": {"vfm_steps": 8, "step_calls": 16}, "attempted": 16, "window_s": 2.0,
           "latencies_s": [0.1] * 9 + [0.2], "peak_bytes": 2**31, "setup_s": 9.5,
           "post_busy_s": 0.4, "post_scans": 16}
    ctx.update(kw)
    return ctx


def test_the_readers():
    read = lambda name, ctx: harness.load_metric(name).read(ctx)
    assert read("device.idle_share", _ctx()) == pytest.approx(0.75)
    assert read("entry.launches_per_scan", _ctx()) == pytest.approx(1 / 16)
    assert read("match.ms", _ctx()) == pytest.approx(31.0)
    # 9.99556 ms of least time over the 20 ms kernel inside the span.
    assert read("match_roofline", _ctx()) == pytest.approx(100 * 9.99556e-3 / 20e-3, rel=1e-5)
    assert read("vfm_icp.steps_per_scan", _ctx()) == pytest.approx(1.5)
    assert read("vfm_icp.ms", _ctx()) is None
    assert read("match_roofline", _ctx(device_spans={})) is None
    assert read("device_ms_per_scan", _ctx()) == pytest.approx(25.0)
    assert read("device_ms_per_scan", _ctx(post_busy_s=None)) is None
    assert read("scans_per_s", _ctx()) == pytest.approx(8.0)
    assert read("call_p90_ms", _ctx()) == pytest.approx(110.0)
    assert read("peak_mem_gib", _ctx()) == pytest.approx(2.0)
    assert read("setup_s", _ctx()) == 9.5


def test_the_breakdown_names_the_host_op_of_each_gap():
    ops = [("a", 10.0, 20.0, True), ("b", 30.0, 40.0, True)]
    host = [("outer", 0.0, 100.0), ("inner", 22.0, 28.0), ("bench.match", 41.0, 49.0)]
    b = harness.breakdown(ops, host, (0.0, 50.0))
    assert dict((k, round(v * 1e6, 6)) for k, v in b["idle_gaps"]) == {"outer": 20.0, "inner": 10.0}
    assert dict(b["device_ops"]) == pytest.approx({"a": 1e-5, "b": 1e-5})
