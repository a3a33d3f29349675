"""Parity of the port's XD path (cosine-weighted neighbours) with `vfmreg_tpu`.

The same numpy inputs from a seed go through both packages on the CPU.
Tolerances, each with its reason:

* `candidate_weights`: 5e-7, half the cosine's error bound (dot products
  and norms of D = 16 terms near 1 summed in another order: up to D f32
  ulps of 1, 1e-6); the weighted champion cache: coordinates exact and
  weights within 5e-7 wherever the champion is
  decisive (its weighted distance 1e-4 clear of the voxel's runner-up),
  `nn_from_weighted_cache` and `nearest_neighbors_xd` the same neighbour
  there, distances within 1e-6 m;
* `register_frame_icp_xd` and `register_frame`'s XD dispatch: poses within
  1e-3 m and 1e-2 deg (chord) of the reference's, as `tests/test_torch_kiss.py`
  holds the 3-D path (another f32 summation order);
* `KissICP` over the 8-frame corridor with 16-d descriptors
  (`examples/odometry_corridor.py --descriptors`): every pose within
  2e-3 m and 2e-2 deg of the reference's (`tests/test_torch_odometry.py`
  gives the reason), no launch of kernels B2 or B3, and its map, with
  descriptors, equal to the reference's given the reference's poses;
* the ComputeTransform service: the port's client and server give the
  port's `compute_transform` to 1e-12 (JSON round trip of float64), and it
  is within 1e-3 m / 1e-2 deg of the reference's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu import config as jconfig  # noqa: E402
from vfmreg_tpu.kiss import mapping as jmapping  # noqa: E402
from vfmreg_tpu.kiss import registration as jreg  # noqa: E402
from vfmreg_tpu.kiss.kiss_icp import KissICP as JKissICP  # noqa: E402
from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.pipeline import transform_server as jts  # noqa: E402
from vfmreg_tpu.registration import icp as jicp  # noqa: E402
from vfmreg_tpu_torch import config as tconfig  # noqa: E402
from vfmreg_tpu_torch.kiss import mapping as tmapping  # noqa: E402
from vfmreg_tpu_torch.kiss import registration as treg  # noqa: E402
from vfmreg_tpu_torch.kiss.kiss_icp import KissICP as TKissICP  # noqa: E402
from vfmreg_tpu_torch.ops import _build  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402
from vfmreg_tpu_torch.pipeline import transform_server as tts  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
from odometry_corridor import CorridorDataset  # noqa: E402

D = 16


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


def _close(got, ref, m=1e-3, deg=1e-2):
    assert np.linalg.norm(got[:3, 3] - ref[:3, 3]) < m and _rotation_gap_deg(got, ref) < deg, (got, ref)


def _pose(t, yaw_deg):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", yaw_deg, degrees=True).as_matrix()
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def world():
    """A 30 m world of ground, walls and posts with smooth descriptors (a
    zero descriptor on every 9th point), its grid in both packages, and a
    scan of it in its own frame."""
    rng = np.random.RandomState(0)
    n = 12000
    xy = rng.uniform(-30, 30, (n, 2))
    z = np.where(rng.rand(n) < 0.6, rng.uniform(0, 0.3, n), rng.uniform(0, 6, n))
    pts = np.c_[xy, z].astype(np.float32)
    feats = np.sin(pts @ rng.normal(size=(3, D)).astype(np.float32) * 0.2).astype(np.float32)
    feats[::9] = 0.0
    cfg = tconfig.load_config(None)
    jm = jmapping.VoxelHashMap(cfg.mapping.voxel_size, cfg.data.max_range, use_native=False)
    tm = tmapping.get_voxel_hash_map(cfg, device="cpu")
    jm.add_points(np.c_[pts, feats])
    tm.add_points(np.c_[pts, feats])
    true = _pose([0.6, -0.4, 0.05], 3.0)
    sel = rng.choice(n, 3000, replace=False)
    inv = np.linalg.inv(true)
    scan_xyz = (pts[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    scan_xyz += rng.normal(0, 0.01, scan_xyz.shape).astype(np.float32)
    return jm, tm, np.c_[scan_xyz, feats[sel]], true


def test_weighted_candidates_and_caches_match_jax(world):
    jm, tm, scan, true = world
    jg, tg = jm.device_grid(), tm.device_grid()
    n = 1024
    q = np.zeros((n, 3), np.float32)
    qf = np.zeros((n, D), np.float32)
    q[:1000] = (scan[:1000, :3] @ true[:3, :3].T + true[:3, 3]).astype(np.float32)
    qf[:1000] = scan[:1000, 3:]
    qm = np.arange(n) < 1000
    jc = jhg.gather_candidate_slabs(jg, jnp.asarray(q), jnp.asarray(qm))
    tc = thg.gather_candidate_slabs(tg, torch.from_numpy(q), torch.from_numpy(qm))
    jw = np.asarray(jhg.candidate_weights(jc, jg.feats, jnp.asarray(qf)))
    tw = thg.candidate_weights(tc, tg.feats, torch.from_numpy(qf)).numpy()
    live = np.asarray(jc.ok())
    np.testing.assert_allclose(tw[live], jw[live], rtol=0, atol=5e-7)
    assert (tw[live] == 1.0).mean() > 0.1 and (tw[live] < 0.5).mean() > 0.1  # both branches ran

    jcache = jhg.build_weighted_nn_cache(jc, jnp.asarray(jw), jnp.asarray(q), jnp.asarray(qm))
    tcache = thg.build_weighted_nn_cache(tc, torch.from_numpy(tw), torch.from_numpy(q), torch.from_numpy(qm))
    # Decisive champions: 1e-4 clear of the voxel's runner-up.
    xs, ys, zs = (np.asarray(a) for a in jc.coords())
    with np.errstate(over="ignore", invalid="ignore"):  # sentinel lanes square to inf
        wd2 = ((xs - q[:, None, 0:1]) ** 2 + (ys - q[:, None, 1:2]) ** 2
               + (zs - q[:, None, 2:3]) ** 2) * jw.reshape(xs.shape)
        top2 = np.sort(wd2, axis=-1)[..., :2]
        decisive = ((top2[..., 1] - top2[..., 0]) > 1e-4).T  # [27, N]
    for a, b in zip(jcache[:3], tcache[:3]):
        np.testing.assert_array_equal(b.numpy()[:27][decisive], np.asarray(a)[:27][decisive])
    np.testing.assert_allclose(tcache.cw.numpy()[:27][decisive], np.asarray(jcache.cw)[:27][decisive], atol=5e-7)
    np.testing.assert_array_equal(tcache.cw.numpy()[27:], 1.0)

    moved = q + np.float32(0.05)
    ok = decisive.all(axis=0) & qm
    a = jhg.nn_from_weighted_cache(jcache, jnp.asarray(moved), jnp.asarray(qm))
    b = thg.nn_from_weighted_cache(tcache, torch.from_numpy(moved), torch.from_numpy(qm))
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    np.testing.assert_array_equal(b[0].numpy()[ok], np.asarray(a[0])[ok])
    np.testing.assert_allclose(b[1].numpy()[ok], np.asarray(a[1])[ok], atol=1e-6)

    a = jhg.nearest_neighbors_xd(jg, jnp.asarray(q), jnp.asarray(qf), jnp.asarray(qm))
    b = thg.nearest_neighbors_xd(tg, torch.from_numpy(q), torch.from_numpy(qf), torch.from_numpy(qm))
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    same = (b[0].numpy() == np.asarray(a[0])).all(axis=1)
    assert same[qm].mean() > 0.99
    np.testing.assert_allclose(b[1].numpy()[same & qm], np.asarray(a[1])[same & qm], atol=1e-6)


@pytest.mark.parametrize("route", ["icp_xd", "force_xd", "vfm_descriptor_size"])
def test_register_frame_xd_matches_jax(world, route):
    jm, tm, scan, true = world
    guess = _pose([0.3, -0.2, 0.0], 1.5)
    sigma = 1.0
    if route == "icp_xd":
        n = 4096
        pts, f = np.zeros((n, 3), np.float32), np.zeros((n, D), np.float32)
        pts[:3000], f[:3000] = scan[:, :3], scan[:, 3:]
        m = np.arange(n) < 3000
        ref = np.asarray(jicp.register_frame_icp_xd(jm.device_grid(), jnp.asarray(pts), jnp.asarray(f),
                                                    jnp.asarray(m), jnp.asarray(guess, jnp.float32), 3 * sigma,
                                                    sigma / 3))
        with ticp.recording_loops() as calls:
            got = ticp.register_frame_icp_xd(tm.device_grid(), torch.from_numpy(pts), torch.from_numpy(f),
                                             torch.from_numpy(m), guess, 3 * sigma, sigma / 3).numpy()
        assert len(calls) == 1 and calls[0]["weighted"] and calls[0]["loop"]["step_calls"] > 0
    else:
        kw = {"force_xd": True} if route == "force_xd" else {"vfm_descriptor_size": 384}
        ref = jreg.register_frame(scan, jm, guess, 3 * sigma, sigma / 3, **kw)
        got = treg.register_frame(scan, tm, guess, 3 * sigma, sigma / 3, **kw)
        assert got.dtype == np.float64
    _close(got.astype(np.float64), np.asarray(ref, np.float64))
    assert np.linalg.norm(got[:3, 3] - true[:3, 3]) < 0.05


def test_kiss_icp_descriptor_corridor_matches_jax():
    ds = CorridorDataset(n_frames=8, d=D)
    jk = JKissICP(jconfig.load_config(None))
    jk.local_map._use_native = False
    tk = TKissICP(tconfig.load_config(None), device="cpu")
    tk.local_map.device_resident = True  # the card's store, on the CPU
    _build.reset_launches()
    with ticp.recording_loops() as calls:
        for i in range(len(ds)):
            jk.register_frame(ds[i], None, use_descriptors=True)
            _, down, updated = tk.register_frame(ds[i], None, use_descriptors=True)
            assert updated and down.shape[1] == 3 + D
    assert _build.LAUNCHES["gn_moments_from_cache"] == _build.LAUNCHES["champions_from_planes"] == 0
    assert len(calls) == 7 and all(c["weighted"] for c in calls)
    for got, ref in zip(tk.poses, jk.poses):
        _close(got, ref, m=2e-3, deg=2e-2)
    assert abs(tk.poses[-1][0, 3] - 7.0) < 0.5
    # The reference's poses replayed into the port's resident map.
    tm = tmapping.VoxelHashMap(1.0, 100.0, 20, device="cpu", device_resident=True)
    for i, pose in enumerate(jk.poses):
        frame = ds[i]
        keep = jk.preprocess(np.c_[frame[:, :3], np.arange(frame.shape[0], dtype=frame.dtype)])
        frame = np.c_[keep[:, :3], frame[keep[:, 3].astype(int), 3:]]
        down = jk.voxelize(np.c_[frame[:, :3], np.arange(frame.shape[0], dtype=frame.dtype)])[1]
        tm.update(np.c_[down[:, :3], frame[down[:, 3].astype(int), 3:]], pose)
    np.testing.assert_array_equal(tm.point_cloud_n(), jk.local_map.point_cloud_n())


def test_transform_service_round_trip():
    rng = np.random.RandomState(4)
    pts = np.c_[rng.uniform(-20, 20, (2000, 2)), rng.uniform(0, 4, (2000, 1))]
    wall = np.c_[rng.uniform(-20, 20, (500, 1)), np.full((500, 1), 8.0), rng.uniform(0, 4, (500, 1))]
    post = np.c_[rng.normal(5.0, 0.1, (300, 2)), rng.uniform(0, 4, (300, 1))]
    pts = np.concatenate([pts, wall, post])
    frame_b = np.c_[pts, np.sin(pts @ rng.normal(size=(3, 8)))]
    offset = np.array([0.4, -0.3, 0.1])
    frame_a = frame_b.copy()
    frame_a[:, :3] -= offset
    pose = tts.compute_transform(frame_a, frame_b, device="cpu")
    _close(pose, jts.compute_transform(frame_a, frame_b))
    assert np.linalg.norm(pose[:3, 3] - offset) < 0.1
    with tts.TransformServer(device="cpu") as server:
        got = tts.request_transform(server.host, server.port, frame_a, frame_b)
        with pytest.raises(RuntimeError, match="ValueError"):
            tts.request_transform(server.host, server.port, frame_a[:, :2], frame_b)
    np.testing.assert_allclose(got, pose, rtol=0, atol=1e-12)
