"""The descriptor cell (`desc.g14.b8`: entry `descriptor_pass`, reference
`reference/descriptor_pass.py`, scene `traffic/rig_scene.py`) at a CPU size:
a run `correct`, with and without trace; each planted fault of
`calibrate_descriptors.FAULTS` that acts on the CPU, and the TF32 control,
refused by `correct`; the configuration's file running the program's preset;
the scene's weights loaded into the program, and the reference's
projection; the metrics' arithmetic on a made-up trace; and `offset.b32` =
`offset.b8` at 32 scans."""

import json

import numpy as np
import pytest
import torch

from benchmark import calibrate_descriptors, harness, vit_work
from benchmark.conftest import ROOT, write_small_cells
from benchmark.entries import descriptor_pass as entry

CPU = torch.device("cpu")
CELL = "desc.g14.b8"
SMALL = {"hidden_size": 48, "num_hidden_layers": 4, "num_attention_heads": 3, "ffn_hidden_size": 128,
         "n_scan": 2048, "kept_rows": 64}
SMALL_RIG = {"image_height": 308, "image_width": 404, "hood_rows": 46}
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "dinov2-vitg14-reg.json").read_text())


@pytest.fixture
def small_cell(tmp_path):
    return write_small_cells(tmp_path, configs={"dinov2-vitg14-reg": SMALL}, traffic={"rig5.b8": SMALL_RIG}), tmp_path


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_cpu(trace, small_cell):
    spec, tmp = small_cell
    r = harness.run(CELL, 2**31 + 11, 0.05, bool(trace), device=CPU, spec=spec, traffic_dir=tmp)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] % 2 == 0
    assert set(r["checks"]) == {"coverage_diff", "desc_rel_err_max"}
    assert r["checks"]["coverage_diff"]["value"] == 0 and r["checks"]["desc_rel_err_max"]["value"] < 1e-4
    if trace:  # no device trace on the CPU: the device metrics read nothing, the stage clock reads the ViT
        assert set(r["metrics"]) == {"vit.ms"}
    else:
        assert {"scans_per_s", "call_p90_ms", "peak_mem_gib", "setup_s"} <= set(r["metrics"])


def test_planted_faults_and_the_control_fail(small_cell):
    spec, tmp = small_cell
    cell = harness.Cell.load(CELL, spec, tmp)
    seen = {}
    calibrate_descriptors.readings(cell, 7, CPU, True, True, lambda o: seen.setdefault(o["kind"], o["numbers"]))
    limits = cell.config["limits"]

    def passes(numbers):
        return all(numbers[k] <= limits[k] for k in limits)

    assert passes(seen["program"])
    for kind in ("fault:block_skipped", "fault:registers_in_patches", "fault:resize_without_antialias",
                 "fault:camera_dropped", "control_tf32"):
        assert not passes(seen[kind]), (kind, seen[kind])
    assert seen["fault:camera_dropped"]["coverage_diff"] > 0


def test_the_file_runs_the_preset():
    from vfmreg_tpu_torch.models import vit

    assert entry.vit_config(CONFIG, vit.PRESETS) == vit.PRESETS[CONFIG["preset"]]
    with pytest.raises(KeyError):
        entry.vit_config(dict(CONFIG, preset="dinov2_vitg14_unknown"), vit.PRESETS)
    with pytest.raises(ValueError, match="FFN width"):
        entry.vit_config(dict(CONFIG, ffn_hidden_size=4104), vit.PRESETS)


def test_the_scene_draws_the_weights_and_the_reference_projects_as_the_rig():
    """The scene's weights (hub layout, drawn before the program) load into the
    program as its own tensors; the reference's pinhole projection from the
    scene's calibration is the rig's."""
    from vfmreg_tpu_torch.models import vit

    from benchmark.reference import descriptor_pass as ref
    from benchmark.traffic import rig_scene

    cfg = dict(CONFIG, **SMALL)
    traffic = dict(json.loads((ROOT / "benchmark" / "traffic" / "rig5.b8.json").read_text()), **SMALL_RIG,
                   batch=2, batches=1)
    scene = rig_scene.make(cfg, traffic, 2**31 + 5, CPU)
    again = rig_scene.make(cfg, traffic, 2**31 + 5, CPU)
    assert all(torch.equal(scene.weights[k], again.weights[k]) for k in scene.weights)
    assert scene.weights["blocks.0.attn.qkv.weight"].shape == (3 * 48, 48)
    assert float(scene.weights["blocks.3.mlp.w3.bias"].abs().max()) > 0
    vit_cfg = entry.vit_config(cfg, vit.PRESETS)
    model = vit.ViT(vit_cfg)
    model.load_state_dict(vit.load_dinov2_state_dict(scene.weights, vit_cfg))
    held = {t.untyped_storage().data_ptr() for t in scene.weights.values()}
    assert not any(t.untyped_storage().data_ptr() in held for t in model.state_dict().values())
    cloud, files = scene.batches[0]["clouds"][1], scene.batches[0]["files"][1]
    pcl_h = np.insert(cloud, 3, values=1, axis=1).T
    for c, cam in enumerate(scene.rig.cameras):
        image = scene.rig.images[files[c]]
        want = scene.rig.project_pcl_to_image(pcl_h, image, cam)
        got = ref.project(scene.calibration, c, cloud, *image.shape[:2])
        assert len(want[2]) > 0 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_vit_flops_and_the_metrics_on_a_made_up_trace():
    assert vit_work.vit_flops(CONFIG, 325) == pytest.approx(0.76264e12, rel=1e-4)
    flops, nbytes = vit_work.attention_work(1, 325, 24, 64)
    assert vit_work.attention_seconds(1, 325, 24, 64) == pytest.approx(3 * flops / 495e12)
    outputs = [{"counters": {"vit_images": 40, "vit_tokens": 40 * 325}}] * 3
    ops = [("void (anonymous namespace)::flash_kernel<64>(...)", 0.0, 50.0, True)] * 3200 + [("gemm", 0.0, 1e6, True)]
    ctx = {"outputs": outputs, "trace_calls": 2, "trace_window_s": 4.0, "ops": ops, "config": CONFIG}
    mfu = harness.load_metric("vit.mfu").read(ctx)
    assert mfu == pytest.approx(100 * 80 * vit_work.vit_flops(CONFIG, 325) / (4.0 * 67e12))
    roof = harness.load_metric("vit.attention_roofline").read(ctx)
    assert roof == pytest.approx(100 * 80 * 40 * vit_work.attention_seconds(1, 325, 24, 64) / (3200 * 50e-6))
    # Without the program's counter (a program that lacks it), both read nothing.
    bare = dict(ctx, outputs=[{"counters": {}}] * 3)
    assert harness.load_metric("vit.mfu").read(bare) is None
    assert harness.load_metric("vit.attention_roofline").read(bare) is None


def test_offset_b32_is_offset_b8_at_32_scans():
    traffic = ROOT / "benchmark" / "traffic"
    b8, b32 = (json.loads((traffic / f"offset.{n}.json").read_text()) for n in ("b8", "b32"))
    assert b32 == dict(b8, batch=32, batches=4)
