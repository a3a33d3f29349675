"""Parity of the PyTorch port's scan-to-map path with the JAX reference.

The same seeded scene goes through `bench.py`'s staged JAX pipeline (grid
build, 5 m voxelize, flattened-batch cosine matching, `register_frame_vfm`
per lane under `vmap`) and through `vfmreg_tpu_torch.scan_to_map` on the CPU:
once with the JAX grid carried over by `convert.grid_from_numpy`, once with
the port's own grid. Per lane the pose must agree within 1e-3 m and 1e-2 deg
and the GN iteration counts must be equal.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.geometry.metrics import compute_errors  # noqa: E402
from vfmreg_tpu.ops.hash_grid import build_hash_grid  # noqa: E402
from vfmreg_tpu.ops.matching import get_vfm_correspondences_batched  # noqa: E402
from vfmreg_tpu.ops.voxel import voxel_down_sample_masked  # noqa: E402
from vfmreg_tpu.registration import vfm_icp  # noqa: E402
from vfmreg_tpu_torch.convert import grid_from_numpy  # noqa: E402
from vfmreg_tpu_torch.scan_to_map import scan_to_map, shared_map_batch  # noqa: E402

B, N_MAP, N_SCAN, D, N_VFM = 2, 8192, 1024, 32, 512


def _rotation_gap_deg(pa, pb):
    """Angle between two rotations from the chord |Ra - Rb|_F = 2 sqrt(2) sin(theta / 2).
    The arccos of the trace (compute_errors) cannot resolve angles below
    ~0.01 deg between f32 rotations, whose rows are orthonormal only to ~1e-7."""
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


def _jax_reference(scene, monkeypatch):
    """bench.py's pipeline in JAX; returns (grid, poses [B,4,4], vfm_it [B], it [B])."""
    mp, mf = jnp.asarray(scene.map_points), jnp.asarray(scene.map_feats)
    sp, sf = jnp.asarray(scene.scans), jnp.asarray(scene.scan_feats)
    sm = jnp.ones(sp.shape[:2], bool)
    grid = build_hash_grid(mp, 1.0, mask=jnp.ones(N_MAP, bool), feats=mf)

    def vds(s, f, m):
        p5, f5, m5 = voxel_down_sample_masked(s, 5.0, mask=m, feats=f)
        return p5[:N_VFM], f5[:N_VFM], m5[:N_VFM]

    p5, f5, m5 = jax.vmap(vds)(sp, sf, sm)
    corrs = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, p5, f5, m5)

    # register_frame_vfm returns no iteration count: record phase 2's loop
    # state while tracing the unjitted body.
    seen = {}
    orig = vfm_icp.geometric_icp_loop

    def spy(*args, **kwargs):
        state = orig(*args, **kwargs)
        seen["it0"], seen["it"] = kwargs["it0"], state.it
        return state

    monkeypatch.setattr(vfm_icp, "geometric_icp_loop", spy)
    body = vfm_icp.register_frame_vfm.__wrapped__

    @jax.jit
    def register(grid, sp, sm, corrs):
        def one(s, m, corr):
            pose, _, _, _ = body(grid, s, m, corr, jnp.eye(4, dtype=jnp.float32), 6.0, 0.667)
            return pose, seen["it0"], seen["it"]

        return jax.vmap(one)(sp, sm, corrs)

    poses, it0, it = register(grid, sp, sm, corrs)
    return grid, np.asarray(poses), np.asarray(it0), np.asarray(it)


@pytest.fixture(scope="module")
def scene():
    return shared_map_batch(B, N_MAP, N_SCAN, D, seed=0)


@pytest.fixture(scope="module")
def reference(scene):
    with pytest.MonkeyPatch.context() as mp:
        return _jax_reference(scene, mp)


@pytest.mark.parametrize("grid_source", ["jax_grid", "torch_grid"])
def test_scan_to_map_matches_jax(scene, reference, grid_source):
    jgrid, jposes, jvfm_it, jit = reference
    grid = None
    if grid_source == "jax_grid":
        grid = grid_from_numpy(
            np.asarray(jgrid.table), np.asarray(jgrid.points), np.asarray(jgrid.bucket_slab),
            np.asarray(jgrid.feats), np.asarray(jgrid.valid), np.asarray(jgrid.voxel_size),
            jgrid.max_points_per_voxel, device="cpu",
        )
    res = scan_to_map(scene.map_points, scene.map_feats, scene.scans, scene.scan_feats,
                      n_vfm=N_VFM, device="cpu", grid=grid)
    np.testing.assert_array_equal(res.vfm_iterations, jvfm_it)
    np.testing.assert_array_equal(res.iterations, jit)
    for b in range(B):
        pa, pb = res.poses[b].astype(np.float64), jposes[b].astype(np.float64)
        rte = np.linalg.norm(pa[:3, 3] - pb[:3, 3])
        assert rte < 1e-3 and _rotation_gap_deg(pa, pb) < 1e-2, (b, rte, _rotation_gap_deg(pa, pb))
        # Both land on the true pose (the recall gate chip_smoke.py applies).
        rte, rre = compute_errors(res.poses[b].astype(np.float64), scene.true_poses[b])
        assert rte < 0.3 and rre < 1.5, (b, rte, rre)
