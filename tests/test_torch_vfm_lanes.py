"""VFM-ICP over lanes: `register_frames_vfm_lanes` against the reference's
`register_frame_vfm` under `vmap`, and against its own one-lane calls.

Four scans of 1,024 points on an 8,192-point map with 32-d descriptors, 64
VFM queries a scan, the JAX grid and correspondences carried over to the
port, the matched targets given heavy-tailed noise. The lanes differ:
lane 1 starts from a guess off the identity (its queries matched from the
guess-transformed source), lane 2 has no accepted correspondence, lane 3
has masked points, and their phase-1 counts differ; `max_iterations` 3
spends every other lane's budget in phase 1.

* against the reference (read through `tests/test_torch_slice.py`'s spy on
  phase 2's loop): per-lane vfm_iterations, iterations and phase-1 masks
  equal, poses within 1e-3 m and 1e-2 deg;
* B lanes equal bit for bit to B one-lane calls (pose, correspondences,
  mask and counts), for 1, 4 and 16 phase-1 steps per read;
* phase 1 reads the device at most ceil(max vfm_iterations /
  VFM_STEPS_PER_READ) + 1 times, once per VFM_STEPS_PER_READ steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.geometry.se3 import transform_points as jtransform  # noqa: E402
from vfmreg_tpu.ops.hash_grid import build_hash_grid  # noqa: E402
from vfmreg_tpu.ops.matching import VFMCorrespondences as JCorrespondences  # noqa: E402
from vfmreg_tpu.ops.matching import get_vfm_correspondences_batched  # noqa: E402
from vfmreg_tpu.ops.voxel import voxel_down_sample_masked  # noqa: E402
from vfmreg_tpu.registration import vfm_icp  # noqa: E402
from vfmreg_tpu_torch.convert import grid_from_numpy  # noqa: E402
from vfmreg_tpu_torch.ops.matching import VFMCorrespondences  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402
from vfmreg_tpu_torch.registration import vfm_icp as tvfm  # noqa: E402
from vfmreg_tpu_torch.scan_to_map import shared_map_batch  # noqa: E402

B, N_MAP, N_SCAN, D, N_VFM = 4, 8192, 1024, 32, 64
MAX_DIST, KERNEL = 6.0, 0.667


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its torch operations are small,
    gain nothing from more threads, and slow to a crawl when the suite's
    workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation_gap_deg(pa, pb):
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


@pytest.fixture(scope="module")
def case():
    """The JAX grid, scans, masks, guesses and correspondences of the four
    lanes, as numpy arrays."""
    scene = shared_map_batch(B, N_MAP, N_SCAN, D, seed=3)
    mp, mf = jnp.asarray(scene.map_points), jnp.asarray(scene.map_feats)
    sp, sf = jnp.asarray(scene.scans), jnp.asarray(scene.scan_feats)
    sm = np.ones((B, N_SCAN), bool)
    sm[3, ::7] = False
    guesses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    c, s = np.cos(np.deg2rad(1.0)), np.sin(np.deg2rad(1.0))
    guesses[1, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    guesses[1, :3, 3] = [0.3, -0.2, 0.1]
    grid = build_hash_grid(mp, 1.0, mask=jnp.ones(N_MAP, bool), feats=mf)

    def vds(s, f, m, g):
        p5, f5, m5 = voxel_down_sample_masked(jtransform(s, g), 5.0, mask=m, feats=f)
        return p5[:N_VFM], f5[:N_VFM], m5[:N_VFM]

    p5, f5, m5 = jax.vmap(vds)(sp, sf, jnp.asarray(sm), jnp.asarray(guesses))
    corr = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, p5, f5, m5)
    corr = corr._replace(mask=corr.mask.at[2].set(False))
    fields = [np.array(f) for f in corr]
    # Heavy-tailed noise on the matched targets: the MAD filter narrows the
    # set over several steps, and the lanes stop at different counts.
    rng = np.random.RandomState(0)
    fields[1] = (fields[1] + 0.1 * rng.standard_cauchy(fields[1].shape)).astype(np.float32)
    return dict(grid=grid, scans=scene.scans, mask=sm, guesses=guesses, corr=fields)


def _torch_inputs(case):
    g = case["grid"]
    grid = grid_from_numpy(np.asarray(g.table), np.asarray(g.points), np.asarray(g.bucket_slab),
                           np.asarray(g.feats), np.asarray(g.valid), np.asarray(g.voxel_size),
                           g.max_points_per_voxel, device="cpu")
    corr = VFMCorrespondences(*(torch.from_numpy(f) for f in case["corr"]))
    return grid, torch.from_numpy(case["scans"]), torch.from_numpy(case["mask"]), corr, \
        torch.from_numpy(case["guesses"])


def _jax_reference(case, max_iterations, monkeypatch):
    """The reference's register_frame_vfm vmapped over the lanes: (poses,
    phase-1 masks, it0, it)."""
    seen = {}
    orig = vfm_icp.geometric_icp_loop

    def spy(*args, **kwargs):
        state = orig(*args, **kwargs)
        seen["it0"], seen["it"] = kwargs["it0"], state.it
        return state

    monkeypatch.setattr(vfm_icp, "geometric_icp_loop", spy)
    body = vfm_icp.register_frame_vfm.__wrapped__
    corr = JCorrespondences(*(jnp.asarray(f) for f in case["corr"]))

    @jax.jit
    def register(grid, sp, sm, corr, guesses):
        def one(s, m, c, g):
            pose, _, _, cmask = body(grid, s, m, c, g, MAX_DIST, KERNEL, max_iterations=max_iterations)
            return pose, cmask, seen["it0"], seen["it"]

        return jax.vmap(one)(sp, sm, corr, guesses)

    out = register(case["grid"], jnp.asarray(case["scans"]), jnp.asarray(case["mask"]), corr,
                   jnp.asarray(case["guesses"]))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("max_iterations", [1000, 3])
def test_lanes_match_the_vmapped_reference(case, max_iterations):
    with pytest.MonkeyPatch.context() as mp:
        jposes, jmask, jit0, jit = _jax_reference(case, max_iterations, mp)
    grid, sp, sm, corr, guesses = _torch_inputs(case)
    res = tvfm.register_frames_vfm_lanes(grid, sp, sm, corr, guesses, MAX_DIST, KERNEL,
                                         max_iterations=max_iterations)
    np.testing.assert_array_equal(res.vfm_iterations, jit0)
    np.testing.assert_array_equal(res.iterations, jit)
    np.testing.assert_array_equal(res.corr_mask.numpy(), jmask)
    assert res.vfm_iterations[2] == 0 and not res.corr_mask[2].any()  # no correspondence: phase 2 only
    if max_iterations == 3:
        assert (res.vfm_iterations[[0, 1, 3]] == 3).all() and (res.iterations == 3).all()
    else:
        assert len(set(res.vfm_iterations[[0, 1, 3]])) > 1 and (res.iterations > res.vfm_iterations).all()
    for b in range(B):
        pa, pb = res.poses[b].numpy().astype(np.float64), jposes[b].astype(np.float64)
        rte = np.linalg.norm(pa[:3, 3] - pb[:3, 3])
        assert rte < 1e-3 and _rotation_gap_deg(pa, pb) < 1e-2, (b, rte, _rotation_gap_deg(pa, pb))


@pytest.mark.parametrize("steps_per_read", [1, 4, 16])
def test_lanes_equal_one_lane_calls(case, steps_per_read, monkeypatch):
    monkeypatch.setattr(tvfm, "VFM_STEPS_PER_READ", steps_per_read)
    grid, sp, sm, corr, guesses = _torch_inputs(case)
    res = tvfm.register_frames_vfm_lanes(grid, sp, sm, corr, guesses, MAX_DIST, KERNEL)
    for j in range(B):
        one = tvfm.register_frame_vfm(grid, sp[j], sm[j], corr.lane(j), guesses[j], MAX_DIST, KERNEL)
        assert torch.equal(res.poses[j], one.pose), j
        assert torch.equal(res.src_corr[j], one.src_corr) and torch.equal(res.tgt_corr[j], one.tgt_corr), j
        assert torch.equal(res.corr_mask[j], one.corr_mask), j
        assert (res.vfm_iterations[j], res.iterations[j], res.rebuilds[j]) == (
            one.vfm_iterations, one.iterations, one.rebuilds), j


def test_phase_one_reads(case):
    grid, sp, sm, corr, guesses = _torch_inputs(case)
    res = tvfm.register_frames_vfm_lanes(grid, sp, sm, corr, guesses, MAX_DIST, KERNEL)
    per_read = tvfm.VFM_STEPS_PER_READ
    most = int(res.vfm_iterations.max())
    assert most > per_read  # the lanes take several rounds
    assert res.loop["vfm_reads"] <= -(-most // per_read) + 1, (res.loop, res.vfm_iterations)
    assert res.loop["vfm_steps"] == per_read * res.loop["vfm_reads"]
    # Phase 2 is one lane loop: its rounds are bounded by the longest lane.
    phase2 = res.iterations - res.vfm_iterations
    assert res.loop["step_calls"] <= ticp.GN_STEPS_PER_READ * int(phase2.max()), (res.loop, phase2)
