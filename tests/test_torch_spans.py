"""The port's spans at its layer boundaries (`utils.profiling.span`).

* `span` alone: with neither a recording profiler nor a timer it enters no
  profiler range and calls no synchronize; with a timer it adds the block's
  seconds under its name after a synchronize of a CUDA device (none for the
  CPU); under a profiler it is a `vfmreg.<name>` function range nested in
  the span around it, and a user annotation around the program stays the
  only annotation;
* under `torch.profiler` on the CPU, `scan_to_map` (the slice test's sizes)
  and `precompute_scene_batched` (the driver test's scene) emit every span
  of their layers, once per call where a layer runs once, nested as the
  layers are: the root encloses every span; VFM-ICP's two phases lie inside
  it, the ICP lane loop inside phase 2 and inside the row's ICP stages; the
  row's eight stages follow one another and cover the call;
* without a profiler or a timer neither entry enters a profiler range or
  calls a synchronize, and their poses, counts and stats are the same bit
  for bit with and without the profiler;
* `create_descriptors` over a batch of 8 rig scans (5 images of 1232 x
  1616 each, a ViT-g/14-reg-shaped model cut to 48 wide and 2 blocks): one
  root `vfmreg.descriptors` a scan, inside it one `vfmreg.vit` an image and
  one `vfmreg.descriptors.assemble` an image plus one for the scatter, the
  ViT counter at 40 images and 40 x 325 tokens, and the generator's timer
  clocking the same spans.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu_torch.models import vit  # noqa: E402
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud, make_synthetic_scene  # noqa: E402
from vfmreg_tpu_torch.scan_to_map import scan_to_map, shared_map_batch  # noqa: E402
from vfmreg_tpu_torch.utils import profiling  # noqa: E402

ROW_STAGES = ["row.grid_build", "row.preprocess", "row.match", "row.snap", "row.ransac", "row.gt_refine_icp",
              "row.vanilla_icp", "row.final_read"]
S2M_ONCE = ["scan_to_map", "grid_build", "queries", "match", "vfm_icp", "vfm_icp.phase1", "vfm_icp.phase2",
            "icp.loop"]
ROW_KEYS = ("gt", "vfm_ransac_raw", "vfm_ransac_ortho", "vfm_ransac_icp", "icp", "corr_counts", "snap_counts",
            "map_size", "scan_sizes", "retried")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_node.py sets it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Counting:
    """The profiler's record-function entries (`record_function` and the
    function-scope `_RecordFunctionFast` that spans enter) and
    `torch.cuda.synchronize` replaced by wrappers that count the program's
    marks and every synchronize."""

    def __init__(self, mp):
        self.marks, self.syncs = [], []

        def counted(make):
            def mark(name, *args, **kwargs):
                if name.startswith(profiling.SPAN_PREFIX):
                    self.marks.append(name)
                return make(name, *args, **kwargs)
            return mark

        mp.setattr(torch.profiler, "record_function", counted(torch.profiler.record_function))
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", counted(torch._C._profiler._RecordFunctionFast))
        mp.setattr(torch.cuda, "synchronize", lambda device=None: self.syncs.append(device))


def _spans(prof):
    """The program's spans of a finished CPU profile: [(name, start_us, end_us)] in start order."""
    out = [(e.name[len(profiling.SPAN_PREFIX):], e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _both(fn):
    """`fn` without the profiler, counting marks and synchronizes, then under
    it: (plain result, its counts, profiled result, its marks, its spans)."""
    with pytest.MonkeyPatch.context() as mp:
        c = Counting(mp)
        plain = fn()
        counts = (list(c.marks), list(c.syncs))
        c.marks.clear()
        profiled, spans = _profiled(fn)
        return plain, counts, profiled, list(c.marks), spans


@pytest.fixture(scope="module")
def s2m_runs():
    scene = shared_map_batch(2, 8192, 1024, 32, seed=0)
    return _both(lambda: scan_to_map(scene.map_points, scene.map_feats, scene.scans, scene.scan_feats,
                                     device="cpu"))


@pytest.fixture(scope="module")
def row_runs():
    scene, local_map = make_synthetic_scene(3, 16384, 1024, 24, seed=0, extent=60.0)[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VFMREG_PROFILE_DRIVER", raising=False)
        mp.delenv("VFMREG_PROFILE_ICP_ITERS", raising=False)
        return _both(lambda: trn.precompute_scene_batched(scene, local_map, device="cpu"))


def test_span_without_profiler_or_timer_does_nothing(monkeypatch):
    c = Counting(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("a"):
        with profiling.span("a.b", device=torch.device("cuda")):
            pass
    assert c.marks == [] and c.syncs == []
    assert profiling.span("a") is profiling.span("b")  # one shared no-op


@pytest.mark.parametrize("device, syncs", [("cuda", 1), ("cpu", 0), (None, 0)])
def test_span_with_timer_is_a_stage_clock(monkeypatch, device, syncs):
    c = Counting(monkeypatch)
    timer = profiling.Timer()
    dev = torch.device(device) if device is not None else None
    for _ in range(2):
        with profiling.span("stage", timer, dev):
            torch.ones(8).sum()
    assert list(timer.totals) == ["stage"] and timer.counts["stage"] == 2 and timer.totals["stage"] > 0
    assert c.syncs == [dev] * (2 * syncs)
    assert c.marks == []


def test_span_under_profiler_nests_marks(monkeypatch):
    c = Counting(monkeypatch)
    timer = profiling.Timer()

    def work():
        with torch.profiler.record_function("caller"):
            with profiling.span("outer"):
                with profiling.span("outer.inner", timer, torch.device("cpu")):
                    torch.ones(8).sum()
                with profiling.span("outer.inner"):
                    pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        work()
    spans = _spans(prof)
    assert c.marks == ["vfmreg.outer", "vfmreg.outer.inner", "vfmreg.outer.inner"] and c.syncs == []
    assert [s[0] for s in spans] == ["outer", "outer.inner", "outer.inner"]
    assert all(_inside(s, spans[0]) for s in spans[1:]) and spans[1][2] <= spans[2][1]
    assert timer.counts["outer.inner"] == 1
    events = {e.name: e for e in prof.events()}
    # The caller's annotation stays the only user annotation, the spans' parent.
    assert events["caller"].is_user_annotation and not events["vfmreg.outer"].is_user_annotation
    assert events["vfmreg.outer"].cpu_parent.name == "caller"
    assert events["vfmreg.outer.inner"].cpu_parent.name == "vfmreg.outer"


def test_scan_to_map_spans(s2m_runs):
    _, _, _, marks, spans = s2m_runs
    assert sorted(s[0] for s in spans) == sorted(S2M_ONCE)
    assert sorted(m[len(profiling.SPAN_PREFIX):] for m in marks) == sorted(S2M_ONCE)
    one = {name: _named(spans, name)[0] for name in S2M_ONCE}
    assert all(_inside(s, one["scan_to_map"]) for s in spans)
    assert _inside(one["vfm_icp.phase1"], one["vfm_icp"]) and _inside(one["vfm_icp.phase2"], one["vfm_icp"])
    assert one["vfm_icp.phase1"][2] <= one["vfm_icp.phase2"][1]
    assert _inside(one["icp.loop"], one["vfm_icp.phase2"])
    layers = [one[n] for n in ("grid_build", "queries", "match", "vfm_icp")]
    assert all(a[2] <= b[1] for a, b in zip(layers, layers[1:]))


def test_row_spans(row_runs):
    _, _, _, marks, spans = row_runs
    assert len(marks) == len(spans)
    (root,) = _named(spans, "row")
    assert all(_inside(s, root) for s in spans)
    stages = [s for s in spans if s[0] in ROW_STAGES]
    assert [s[0] for s in stages] == ROW_STAGES
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    stage = {s[0]: s for s in stages}
    (grid,) = _named(spans, "grid_build")
    assert _inside(grid, stage["row.grid_build"])
    matches = _named(spans, "match")
    assert matches and all(_inside(m, stage["row.match"]) for m in matches)
    loops = _named(spans, "icp.loop")
    assert sum(_inside(x, stage["row.gt_refine_icp"]) for x in loops) == 2  # the GT and refine rows
    assert sum(_inside(x, stage["row.vanilla_icp"]) for x in loops) >= 1
    assert all(_inside(x, stage["row.gt_refine_icp"]) or _inside(x, stage["row.vanilla_icp"]) for x in loops)
    assert {s[0] for s in spans} == {"row", "grid_build", "match", "icp.loop", *ROW_STAGES}


def test_scan_to_map_without_profiler_unmarked_and_equal(s2m_runs):
    plain, (marks, syncs), profiled, _, _ = s2m_runs
    assert marks == [] and syncs == []
    for k in plain._fields:
        a, b = getattr(plain, k), getattr(profiled, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


def test_row_without_profiler_unmarked_and_equal(row_runs):
    plain, (marks, syncs), profiled, _, _ = row_runs
    assert marks == [] and syncs == []
    for k in ROW_KEYS:
        if isinstance(plain[k], np.ndarray):
            np.testing.assert_array_equal(plain[k], profiled[k], err_msg=k)
        else:
            assert plain[k] == profiled[k], k
    for k in ("iterations", "settled", "rebuilds", "loop", "icp_width", "corr_width"):
        assert plain["stats"][k] == profiled["stats"][k], k
    assert set(plain["stats"]["seconds"]) == set(profiled["stats"]["seconds"]) == {"total"}


DESC_SCANS = 8


@pytest.fixture(scope="module")
def descriptor_runs():
    cfg = dataclasses.replace(vit.PRESETS["dinov2_vitg14_reg"], hidden_size=48, num_layers=2, num_heads=3)
    gen = ImageFeatureGenerator("dinov2", config=cfg, seed=0, device="cpu")
    rig = SyntheticCameraRig(seed=0)
    clouds = [make_rig_cloud(256, seed=i) for i in range(DESC_SCANS)]
    files = [[f"cloud{i}/{cam}.png" for cam in rig.cameras] for i in range(DESC_SCANS)]

    def run():
        before = dict(vit.FORWARD_COUNTS)
        out = [create_descriptors(f, rig, gen, c) for f, c in zip(files, clouds)]
        return out, {k: vit.FORWARD_COUNTS[k] - before.get(k, 0) for k in ("images", "tokens")}

    return (gen, rig, files, clouds), _both(run)


def test_descriptor_spans(descriptor_runs):
    _, (_, _, _, marks, spans) = descriptor_runs
    assert len(marks) == len(spans)
    roots = _named(spans, "descriptors")
    assert len(roots) == DESC_SCANS and all(a[2] <= b[1] for a, b in zip(roots, roots[1:]))
    vits, assemble = _named(spans, "vit"), _named(spans, "descriptors.assemble")
    cameras = len(SyntheticCameraRig.cameras)
    assert len(vits) == DESC_SCANS * cameras and len(assemble) == DESC_SCANS * (cameras + 1)
    assert {s[0] for s in spans} == {"descriptors", "vit", "descriptors.assemble"}
    for root in roots:
        inner = [s for s in spans if s is not root and _inside(s, root)]
        assert [s[0] for s in inner] == ["vit", "descriptors.assemble"] * cameras + ["descriptors.assemble"]
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # the layers follow one another


def test_descriptor_counter_and_no_marks_without_profiler(descriptor_runs):
    _, (plain, (marks, syncs), profiled, _, _) = descriptor_runs
    cameras = len(SyntheticCameraRig.cameras)
    assert plain[1] == profiled[1] == {"images": DESC_SCANS * cameras, "tokens": DESC_SCANS * cameras * 325}
    assert marks == [] and syncs == []
    assert all(np.array_equal(a, b) for a, b in zip(plain[0], profiled[0]))


def test_descriptor_timer_clocks_the_spans(descriptor_runs):
    (gen, rig, files, clouds), (plain, _, _, _, _) = descriptor_runs
    timer = profiling.Timer()
    out = create_descriptors(files[0], rig, gen, clouds[0], timer=timer)
    assert dict(timer.counts) == {"descriptors": 1, "vit": 5, "descriptors.assemble": 6}
    assert timer.totals["descriptors"] >= timer.totals["vit"] + timer.totals["descriptors.assemble"]
    assert np.array_equal(out, plain[0][0])
