"""A run with the timed path broken underneath comes out not correct, for
each fault that these cells can have. Both cells run on one card, so the
fault of an exchange between cards left out has no place here. CPU sizes;
the look for a card is skipped (the harness is driven with a CPU device)."""

import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.conftest import write_small_cells

CPU = torch.device("cpu")
SEED = 2**31 + 101


@contextlib.contextmanager
def patched(module, name, make):
    kept = getattr(module, name)
    setattr(module, name, make(kept))
    try:
        yield
    finally:
        setattr(module, name, kept)


def _frozen_exp(orig):
    """A GN step that leaves the pose and the points as they were."""
    def exp(dx):
        return torch.eye(4, dtype=dx.dtype, device=dx.device).expand(dx.shape[0], 4, 4).clone()
    return exp


def _run(cell, small_cells):
    spec, tmp = small_cells
    return harness.run(cell, SEED, 0.05, False, device=CPU, spec=spec, traffic_dir=tmp)


@pytest.mark.parametrize("cell", ["s2m.b8", "row.b8"])
def test_a_step_that_leaves_the_state_unchanged(cell, tmp_path):
    from vfmreg_tpu_torch.ops import gn_kernel
    from vfmreg_tpu_torch.parallel import mesh
    from vfmreg_tpu_torch.pipeline import registration_node
    from vfmreg_tpu_torch.registration import vfm_icp

    # A frozen loop runs to its budget: the budgets cut to keep the test short.
    small_cells = (write_small_cells(tmp_path, configs={"vfm-scan-to-map": {"max_iterations": 40}}), tmp_path)
    with patched(gn_kernel, "exp_se3_lanes", _frozen_exp), patched(vfm_icp, "exp_se3_lanes", _frozen_exp), \
            patched(registration_node, "MAX_NUM_ITERATIONS", lambda _: 40), \
            patched(mesh, "MAX_NUM_ITERATIONS", lambda _: 40), \
            patched(mesh, "FAR_FIELD_PHASE1_ITERATIONS", lambda _: 20):
        r = _run(cell, small_cells)
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out_scan_to_map(small_cells):
    from vfmreg_tpu_torch import scan_to_map
    from vfmreg_tpu_torch.ops.matching import VFMCorrespondences

    def half(orig):
        def f(grid, points, mask, corr, guess, *a, **k):
            h = points.shape[0] // 2
            res = orig(grid, points[:h], mask[:h], VFMCorrespondences(*(x[:h] for x in corr)), guess[:h], *a, **k)
            poses = torch.cat([res.poses, torch.as_tensor(guess[h:], dtype=res.poses.dtype)])
            return res._replace(poses=poses)
        return f

    with patched(scan_to_map, "register_frames_vfm_lanes", half):
        r = _run("s2m.b8", small_cells)
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out_method_row(small_cells):
    from vfmreg_tpu_torch.pipeline import registration_node

    def half(orig):
        def f(src, tgt, mask, seeds, *a, **k):
            h = src.shape[0] // 2
            poses = orig(src[:h], tgt[:h], mask[:h], list(seeds)[:h], *a, **k)
            eye = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(src.shape[0] - h, 4, 4)
            return torch.cat([poses, eye])
        return f

    with patched(registration_node, "batched_ransac", half):
        r = _run("row.b8", small_cells)
    assert not r["correct"], r["checks"]


def test_an_answer_altered_where_it_is_produced_scan_to_map(small_cells):
    from vfmreg_tpu_torch import scan_to_map

    def shifted(orig):
        def f(*a, **k):
            res = orig(*a, **k)
            poses = res.poses.clone()
            poses[0, 0, 3] += 0.01  # one scan's pose 1 cm off
            return res._replace(poses=poses)
        return f

    with patched(scan_to_map, "register_frames_vfm_lanes", shifted):
        r = _run("s2m.b8", small_cells)
    assert not r["correct"], r["checks"]


def test_an_answer_altered_where_it_is_produced_method_row(small_cells):
    from vfmreg_tpu_torch.pipeline import registration_node

    def one_dropped(orig):
        def f(*a, **k):
            corr = orig(*a, **k)
            mask = corr.mask.clone()
            first = torch.nonzero(mask[0])[0, 0]
            mask[0, first] = False  # scan 0 loses one accepted correspondence
            return corr._replace(mask=mask)
        return f

    with patched(registration_node, "get_vfm_correspondences_batched", one_dropped):
        r = _run("row.b8", small_cells)
    assert not r["correct"], r["checks"]


def test_the_vanilla_row_moved_on_most_scans(tmp_path):
    """Three scans of four a call 5 cm off: the median over the scans sees it."""
    from vfmreg_tpu_torch.pipeline import registration_node

    def moved(orig):
        def f(*a, **k):
            res = orig(*a, **k)
            poses = res.poses.clone()
            poses[:3, 0, 3] += 0.05
            return res._replace(poses=poses)
        return f

    small_cells = (write_small_cells(tmp_path, traffic={"regions.b8": {"batch": 4, "batches": 1}}), tmp_path)
    with patched(registration_node, "batched_icp_two_phase", moved):
        r = _run("row.b8", small_cells)
    assert not r["correct"], r["checks"]
    assert r["checks"]["vanilla_median_dt_m"]["value"] > r["checks"]["vanilla_median_dt_m"]["limit"]


def test_ransac_with_a_single_hypothesis(small_cells):
    from vfmreg_tpu_torch.pipeline import registration_node

    with patched(registration_node, "RANSAC_HYPOTHESES", lambda _: 1):
        r = _run("row.b8", small_cells)
    assert not r["correct"], r["checks"]
    assert r["checks"]["ransac_excess_median"]["value"] > r["checks"]["ransac_excess_median"]["limit"]


def test_the_snap_dropping_pairs(small_cells):
    from vfmreg_tpu_torch.pipeline import registration_node

    def half_dropped(orig):
        def f(*a, **k):
            src, tgt, mask = orig(*a, **k)
            mask = mask.clone()
            rows = torch.nonzero(mask[0])[:, 0]
            mask[0, rows[::2]] = False  # scan 0 loses half its snapped pairs
            return src, tgt, mask
        return f

    with patched(registration_node, "snap_correspondences", half_dropped):
        r = _run("row.b8", small_cells)
    assert not r["correct"], r["checks"]
    assert r["checks"]["snap_count_diff"]["value"] > r["checks"]["snap_count_diff"]["limit"]
