"""Parity of the port's evaluation-driver method row with `vfmreg_tpu`.

`precompute_scene_batched` against the reference's
`RegistrationNode._precompute_scene_batched` (built as `bench.py:230-240`
builds it: vfm row only, batched, device preprocessing) on small synthetic
scenes from `pipeline/synthetic.py` (B = 3, 16,384-point map, 1,024-point
scans, D = 24):

* equal correspondence counts, retried scans, scan sizes, snap counts and
  map size: the preprocessing, matching and snap filter select the same
  sets;
* every lane of every ICP row settles below the 1000-iteration cap on these
  scenes (so no lane escapes the pose comparison), and the GT and vanilla
  ICP poses agree within 1e-3 m and 1e-2 deg (chord) on every lane: the rows
  are deterministic, and the packages differ only in the order of f32 sums;
* RANSAC raw poses differ by design (the port draws its picks from a
  `torch.Generator`, the reference from threefry), so the refined poses are
  held within the recall gate (0.3 m, 1.5 deg) of the reference's, and the
  recall tables must be equal;
* one scene with a small scan forces the 1 m retry, and a 4-query budget
  forces the full-width re-match of every scan.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu.pipeline.registration_node import RegistrationNode  # noqa: E402
from vfmreg_tpu_torch.geometry.metrics import compute_errors  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline import synthetic  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene  # noqa: E402
from vfmreg_tpu_torch.registration.icp import MAX_NUM_ITERATIONS  # noqa: E402

B, N_MAP, N_SCAN, D, EXTENT = 3, 16384, 1024, 24, 60.0
KEYS = ("gt", "vfm_ransac_raw", "vfm_ransac_ortho", "vfm_ransac_icp", "icp", "corr_counts",
        "snap_counts", "map_size", "scan_sizes", "retried", "viz_corr")


def _rotation_gap_deg(pa, pb):
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


def _scene(crop_scan=None):
    scene, local_map, true_poses = make_synthetic_scene(B, N_MAP, N_SCAN, D, seed=0, extent=EXTENT)
    if crop_scan is not None:
        # An 8 m-radius scan: a handful of 5 m voxels, below 75 correspondences.
        c = scene["scene_point_clouds"][crop_scan]
        scene["scene_point_clouds"][crop_scan] = c[np.linalg.norm(c[:, :2], axis=1) < 8.0]
    return scene, local_map, true_poses


def _jax_row(scene, local_map, q5_budget=None):
    tmp = tempfile.mkdtemp()
    node = RegistrationNode(Path(tmp), methods_ransac=[("vfm", True)], methods_teaser=[],
                            methods_pointdsc=[], batch_scans=True, device_preprocess=True)
    node.filenames = [Path(tmp) / "scene_test.h5"]
    if q5_budget is not None:
        node._q5_budget = q5_budget
    return node._precompute_scene_batched(scene, local_map)


def _compare(ref, got, true_poses):
    assert set(KEYS) <= set(got) and set(KEYS) <= set(ref)
    for k in ("corr_counts", "snap_counts", "scan_sizes", "retried", "map_size"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    stats = got["stats"]
    for row in ("gt", "refine", "icp"):
        assert all(stats["settled"][row]), (row, stats["iterations"][row])
        assert max(stats["iterations"][row]) < MAX_NUM_ITERATIONS, (row, stats["iterations"][row])
    for key in ("gt", "icp"):
        for j in range(B):
            pa, pb = got[key][j], ref[key][j]
            rte, gap = np.linalg.norm(pa[:3, 3] - pb[:3, 3]), _rotation_gap_deg(pa, pb)
            assert rte < 1e-3 and gap < 1e-2, (key, j, rte, gap)
    for j in range(B):
        rte, rre = compute_errors(got["vfm_ransac_icp"][j], ref["vfm_ransac_icp"][j])
        assert rte < 0.3 and rre < 1.5, (j, rte, rre)
        rte, rre = compute_errors(got["gt"][j], true_poses[j])
        assert rte < 0.3 and rre < 1.5, (j, rte, rre)
    assert trn.recall_table(trn.method_errors(got)) == trn.recall_table(trn.method_errors(ref))
    assert sum(stats["rebuilds"]["icp"]) > 0


@pytest.fixture(scope="module")
def scene_a():
    return _scene()


def test_driver_row_matches_jax(scene_a):
    scene, local_map, true_poses = scene_a
    ref = _jax_row(scene, local_map)
    got = trn.precompute_scene_batched(scene, local_map, device="cpu")
    assert got["retried"] == [] and min(got["corr_counts"]) >= 75
    _compare(ref, got, true_poses)
    # The recall table prints one row per method.
    text = trn.format_recall_table(trn.recall_table(trn.method_errors(got)))
    assert [ln.split(":")[0].strip() for ln in text.splitlines()[1:]] == list(trn.METHODS)


def test_driver_overflow_rematch_matches_jax(scene_a, capsys):
    scene, local_map, true_poses = scene_a
    ref = _jax_row(scene, local_map, q5_budget=4)
    capsys.readouterr()
    got = trn.precompute_scene_batched(scene, local_map, device="cpu", q5_budget=4)
    assert "re-matching them at full width" in capsys.readouterr().out
    assert min(got["corr_counts"]) > 4
    _compare(ref, got, true_poses)


def test_driver_retry_matches_jax():
    scene, local_map, true_poses = _scene(crop_scan=1)
    ref = _jax_row(scene, local_map)
    got = trn.precompute_scene_batched(scene, local_map, device="cpu")
    assert got["retried"] == [1]
    _compare(ref, got, true_poses)


def test_driver_main_runs_and_needs_a_device(capsys, monkeypatch):
    """The synthetic demo of the method row (`python -m
    vfmreg_tpu_torch.pipeline.synthetic`)."""
    synthetic.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "vfm_ransac_icp" in out and "0.3, 15" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic.main([])
