"""Parity of the port's ICP rows and batched ICP stages with `vfmreg_tpu`.

On a copy of the reference's far-field fixture (`tests/test_parallel.py:
469-491`: one shared 5,000-point map, b = 4 scans at growing offsets, each
lane needing a different number of GN iterations):

* every champion rebuild of the ICP loop (kernel B3's plain version on the
  transposed planes) equals `build_nn_cache` on the epoch's slab gather bit
  for bit, and a run whose rebuilds are `build_nn_cache` (the reference's
  "slabs" rebuild) gives the same poses, iterations and rebuild counts;
* per lane, with either rebuild, `register_frame_icp_stats` gives the
  reference's iteration count
  and settled flag, and its pose within 1e-3 m and 1e-2 deg (rotation gap
  measured by the chord, as in `tests/test_torch_slice.py`): the packages
  sum the GN moments in other orders, so poses agree to f32 rounding, not
  bit for bit;
* a two-phase lane that settles in phase 1 is bit-identical to the single
  full-budget run; with a 6-iteration phase 1 three of the four lanes cross
  into phase 2, and every lane matches the reference's
  `batched_icp_two_phase` within the same tolerance, on its true pose.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation as Rot  # noqa: E402

from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.parallel import mesh as jmesh  # noqa: E402
from vfmreg_tpu.registration import icp as jicp  # noqa: E402
from vfmreg_tpu_torch.geometry.metrics import compute_errors  # noqa: E402
from vfmreg_tpu_torch.ops import gn_kernel as tgn  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402
from vfmreg_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402

MD, KERNEL = 3.0, 0.5
P1 = 6  # a phase-1 budget that most lanes cross


def _rotation_gap_deg(pa, pb):
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


def _close(pa, pb):
    pa, pb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
    rte = np.linalg.norm(pa[:3, 3] - pb[:3, 3])
    return rte < 1e-3 and _rotation_gap_deg(pa, pb) < 1e-2


@pytest.fixture(scope="module")
def fixture():
    """One shared map + b scans at far-field offsets with known GT."""
    rng = np.random.RandomState(42)
    b, m, n = 4, 5000, 700
    pts = np.c_[rng.uniform(-35, 35, (m, 2)), rng.uniform(0, 6, (m, 1))].astype(np.float32)
    scans = np.zeros((b, n, 3), np.float32)
    gts = []
    for j in range(b):
        T = np.eye(4)
        T[:3, :3] = Rot.from_euler("z", rng.uniform(-4, 4) * (j + 1) / b, degrees=True).as_matrix()
        T[:2, 3] = rng.uniform(-1.0, 1.0, 2) * (j + 1)
        sel = rng.choice(m, n, replace=False)
        Ti = np.linalg.inv(T)
        scans[j] = (pts[sel] @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        gts.append(T)
    mask = np.ones((b, n), bool)
    mask[:, ::17] = False  # some padding rows
    jgrid = jhg.build_hash_grid(jnp.asarray(pts), 1.0)
    tgrid = thg.build_hash_grid(torch.from_numpy(pts), 1.0)
    return jgrid, tgrid, scans, mask, np.stack(gts)


@pytest.fixture(scope="module")
def jax_lanes(fixture):
    """The reference's per-lane (pose, iterations, settled) at the full budget."""
    jgrid, _, scans, mask, _ = fixture
    eye = jnp.eye(4, dtype=jnp.float32)
    out = []
    for j in range(scans.shape[0]):
        pose, it, settled = jicp.register_frame_icp_stats(
            jgrid, jnp.asarray(scans[j]), jnp.asarray(mask[j]), eye, jnp.float32(MD),
            jnp.float32(KERNEL),
        )
        out.append((np.asarray(pose), int(it), bool(settled)))
    return out


def _port_lanes(fixture, **kwargs):
    _, tgrid, scans, mask, _ = fixture
    return tmesh.batched_icp_stats(
        tgrid, torch.from_numpy(scans), torch.from_numpy(mask),
        np.tile(np.eye(4, dtype=np.float32), (scans.shape[0], 1, 1)), MD, KERNEL, **kwargs,
    )


def _slabs_rebuild(monkeypatch, check=False):
    """Make the ICP loop's rebuilds `build_nn_cache` on each lane's own epoch
    slab gather; with `check`, keep kernel B3's result and assert it equal to
    `build_nn_cache`'s on every rebuilt lane instead. The loop gathers the
    slabs of the lanes flagged GATHERED, in ascending order, over their
    concatenated queries, and rebuilds the flagged lanes in one call; each
    lane's slice of its last gather is its epoch's candidates. Returns a
    dict that counts the checked lanes."""
    seen = {"checked": 0, "lane_cands": {}}
    gather, b3 = ticp.gather_candidate_slabs, ticp.champions_from_planes_lanes

    def recording_gather(grid, queries, mask):
        seen["cands"] = gather(grid, queries, mask)
        return seen["cands"]

    def rebuild(cxt, cyt, czt, queries, mask, flags, group, out):
        n = queries.shape[1]
        flags = flags.tolist()
        gathered = [j for j, f in enumerate(flags) if f == tgn.GATHERED]
        for k, j in enumerate(gathered):
            seen["lane_cands"][j] = thg.Candidates(seen["cands"].slabs[k * n:(k + 1) * n])
        b3(cxt, cyt, czt, queries, mask, torch.tensor(flags, dtype=torch.int32), group, out)
        for j, f in enumerate(flags):
            if f == tgn.KEEP:
                continue
            cache = thg.build_nn_cache(seen["lane_cands"][j], queries[j], mask[j])
            ref = (cache.cx, cache.cy, cache.cz)
            if not check:
                for c in range(3):
                    out[c, j] = ref[c]
                continue
            assert all(torch.equal(out[c, j], ref[c]) for c in range(3))
            seen["checked"] += 1

    monkeypatch.setattr(ticp, "gather_candidate_slabs", recording_gather)
    monkeypatch.setattr(ticp, "champions_from_planes_lanes", rebuild)
    return seen


def test_planes_equals_slabs(fixture, monkeypatch):
    planes = _port_lanes(fixture)
    seen = _slabs_rebuild(monkeypatch, check=True)
    _port_lanes(fixture)
    assert seen["checked"] == planes.rebuilds.sum()
    monkeypatch.undo()
    _slabs_rebuild(monkeypatch)
    slabs = _port_lanes(fixture)
    assert torch.equal(slabs.poses, planes.poses)
    np.testing.assert_array_equal(slabs.iterations, planes.iterations)
    np.testing.assert_array_equal(slabs.rebuilds, planes.rebuilds)
    assert planes.rebuilds.min() > 0 and len(set(planes.iterations.tolist())) > 1


@pytest.mark.parametrize("rebuild_mode", ["slabs", "planes"])
def test_register_frame_icp_stats_match_jax(fixture, jax_lanes, rebuild_mode, monkeypatch):
    if rebuild_mode == "slabs":
        _slabs_rebuild(monkeypatch)
    got = _port_lanes(fixture)
    gts = fixture[4]
    for j, (pose, it, settled) in enumerate(jax_lanes):
        assert got.iterations[j] == it and got.settled[j] == settled, (j, got.iterations, it)
        assert _close(got.poses[j].numpy(), pose), (j, got.poses[j], pose)
        rte, rre = compute_errors(got.poses[j].numpy().astype(np.float64), gts[j])
        assert rte < 0.3 and rre < 1.5, (j, rte, rre)
    # One lane on its own gives the batched stage's lane.
    _, tgrid, scans, mask, _ = fixture
    one = ticp.register_frame_icp_stats(tgrid, torch.from_numpy(scans[0]), torch.from_numpy(mask[0]),
                                        torch.eye(4), MD, KERNEL)
    assert torch.equal(one.pose, got.poses[0]) and one.iterations == got.iterations[0]


def test_two_phase_settled_lane_is_single_run(fixture):
    _, tgrid, scans, mask, _ = fixture
    single = _port_lanes(fixture)
    assert single.settled.all() and single.iterations.max() <= ticp.FAR_FIELD_PHASE1_ITERATIONS
    two = tmesh.batched_icp_two_phase(
        tgrid, torch.from_numpy(scans), torch.from_numpy(mask),
        np.tile(np.eye(4, dtype=np.float32), (scans.shape[0], 1, 1)), MD, KERNEL,
    )
    assert torch.equal(two.poses, single.poses)
    np.testing.assert_array_equal(two.iterations, single.iterations)
    np.testing.assert_array_equal(two.rebuilds, single.rebuilds)


def test_two_phase_crossing_lanes_match_jax(fixture):
    jgrid, tgrid, scans, mask, gts = fixture
    guesses = np.tile(np.eye(4, dtype=np.float32), (scans.shape[0], 1, 1))
    ref = np.asarray(jmesh.batched_icp_two_phase(
        jgrid, jnp.asarray(scans), jnp.asarray(mask), jnp.asarray(guesses),
        jnp.float32(MD), jnp.float32(KERNEL), phase1_iters=P1,
    ))
    got = tmesh.batched_icp_two_phase(
        tgrid, torch.from_numpy(scans), torch.from_numpy(mask), guesses, MD, KERNEL, phase1_iters=P1,
    )
    first = _port_lanes(fixture, max_iterations=P1)
    crossed = ~first.settled
    assert crossed.sum() >= 3  # lanes 1-3 cross into phase 2
    assert (got.iterations[crossed] > P1).all() and got.settled.all()
    assert torch.equal(got.poses[~crossed], first.poses[~crossed])
    for j in range(scans.shape[0]):
        assert _close(got.poses[j].numpy(), ref[j]), (j, got.poses[j], ref[j])
        rte, rre = compute_errors(got.poses[j].numpy().astype(np.float64), gts[j])
        assert rte < 0.3 and rre < 1.5, (j, rte, rre)
