"""Gloo process groups for the port's multi-device tests, and the data they share.

The tests (`test_torch_mesh*.py`) hold the port's `parallel/mesh.py` at
world sizes 2 and 4 against the JAX package on as many of the virtual CPU
devices. The ranks run in spawned processes that import only torch, numpy
and the port: this module imports no JAX, and its data makers are numpy,
so the pytest process (JAX) and the ranks (the port) build the same inputs
from the same seeds.

`start(world, target, tmp, *args)` spawns `world` ranks that join one gloo
group (a file store in `tmp`, a 60 s timeout, so that a rank waiting on a
collective its peers never make fails the test in a minute), call
`target(rank, world, *args)` on one intra-op thread and pickle its result
(a dict of numpy arrays) or the traceback. `Ranks.results()` waits for them.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

TIMEOUT_S = 60


def _rank_main(rank, world, tmp, target, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            result = {"ok": target(rank, world, *args)}
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the test, which fails on it
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)


class Ranks:
    def __init__(self, procs, tmp):
        self.procs, self.tmp = procs, Path(tmp)

    def results(self, timeout=4 * TIMEOUT_S):
        """Each rank's result, in rank order; raises on any rank's failure."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 1))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        if alive:
            raise RuntimeError(f"{len(alive)} rank(s) still running after {timeout} s")
        out = []
        for rank, p in enumerate(self.procs):
            path = self.tmp / f"rank{rank}.pkl"
            if not path.exists():
                raise RuntimeError(f"rank {rank} exited with {p.exitcode} and no result")
            with open(path, "rb") as f:
                r = pickle.load(f)
            if "error" in r:
                raise RuntimeError(f"rank {rank} failed:\n{r['error']}")
            out.append(r["ok"])
        return out


def start(world, target, tmp, *args) -> Ranks:
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp), target, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, tmp)


# ---------------------------------------------------------------------------
# Data (numpy, seeded): the reference tests' inputs (tests/test_parallel.py)
# ---------------------------------------------------------------------------


def rot_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rigid(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


def into_frame(pts, T):
    """pts expressed in the frame whose pose is T (T^-1 applied), f32."""
    return ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)


def ransac_pair():
    """`test_sharded_ransac_matches_single_device`: 256 pairs, 25 % outliers."""
    rng = np.random.RandomState(42)
    n = 256
    src = np.c_[rng.uniform(-10, 10, (n, 2)), rng.uniform(0, 3, (n, 1))].astype(np.float32)
    T = rigid(rot_z(25), [2.0, -1.0, 0.2])
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt[: n // 4] = rng.uniform(-10, 10, (n // 4, 3))
    return src, tgt, np.ones(n, bool), T


def ransac_clear(seed):
    """tests/test_torch_ransac.py's correspondences (`_corrs(seed, 300, 0.3,
    0.3)`, 40 rows masked): at a small budget the best hypothesis beats the
    second by far more than the f32 score noise, so two packages scoring
    the same picks pick the same winner."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("xyz", rng.uniform(-30, 30, 3), degrees=True).as_matrix()
    T[:3, 3] = rng.uniform(-20, 20, 3)
    n = 300
    src = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    k = int(n * 0.3)
    tgt[:k] = (rng.uniform(-40, 40, (k, 3)) + src[:k].mean(0)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[np.random.RandomState(seed + 10).choice(n, 40, replace=False)] = False
    return src, tgt, mask


def ransac_batch():
    """`test_hypothesis_sharded_batched_ransac_matches_serial_loop`: 3 scans."""
    rng = np.random.RandomState(3)
    b, n = 3, 256
    src = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    tgt = np.empty_like(src)
    gts = []
    for j in range(b):
        th = rng.uniform(-0.5, 0.5)
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        tgt[j] = src[j] @ R.T + t
        bad = rng.choice(n, n // 4, replace=False)
        tgt[j, bad] = rng.uniform(-25, 25, (len(bad), 3))
        gts.append(rigid(R, t))
    return src, tgt, np.ones((b, n), bool), gts


def icp_case(m, n, extent, T, seed=42):
    """A uniform cloud of m points and a scan of n of them seen from T."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-extent, extent, (m, 3)).astype(np.float32)
    sel = rng.choice(m, n, replace=False)
    return pts, into_frame(pts[sel], T), sel


def icp_refresh1():
    """`test_map_sharded_icp_matches_single_grid`: sparse occupancy."""
    from scipy.spatial.transform import Rotation

    T = rigid(Rotation.from_euler("zy", [2.0, -1.0], degrees=True).as_matrix(), [0.25, -0.2, 0.1])
    pts, scan, _ = icp_case(8192, 1024, 20.0, T)
    return pts, scan, T


def icp_default_refresh():
    """`test_map_sharded_icp_default_refresh_recovers_pose`."""
    T = rigid(rot_z(3.0), [0.3, 0.15, -0.1])
    pts, scan, _ = icp_case(4096, 512, 15.0, T)
    return pts, scan, T


def icp_padded(world):
    """`test_map_sharded_icp_padded_masked_rows`: 3001 rows padded to a
    multiple of the world with masked rows 0.3 m off a scanned point."""
    T = rigid(rot_z(2.0), [0.25, -0.15, 0.05])
    rng = np.random.RandomState(42)
    m_real, n = 3001, 512
    pts = rng.uniform(-15, 15, (m_real, 3)).astype(np.float32)
    sel = rng.choice(m_real, n, replace=False)
    sel[0] = 0
    m_pad = -(-m_real // world) * world
    mp = np.zeros((m_pad, 3), np.float32)
    mp[:m_real] = pts
    mp[m_real:] = pts[0] + np.float32(0.3)
    mmask = np.zeros(m_pad, bool)
    mmask[:m_real] = True
    return pts, mp, mmask, into_frame(pts[sel], T), T


def world_map(m, d, seed=42):
    rng = np.random.RandomState(seed)
    pts = np.c_[rng.uniform(-25, 25, (m, 2)), rng.uniform(0, 6, (m, 1))].astype(np.float32)
    feats = np.sin(pts @ rng.normal(size=(3, d)).astype(np.float32) * 0.15).astype(np.float32)
    return rng, pts, feats


def vfm_case():
    """`test_map_sharded_vfm_register_end_to_end`."""
    rng, pts, feats = world_map(8192, 32)
    T = rigid(rot_z(12.0), [3.0, -2.0, 0.2])
    sel = rng.choice(8192, 1024, replace=False)
    return pts, feats, into_frame(pts[sel], T), feats[sel], T


def dp_case():
    """`test_dp_map_sharded_vfm_register_matches_single_device`: 4 scans."""
    rng, pts, feats = world_map(8192, 32)
    scans, sfeats, gts = [], [], []
    for j in range(4):
        T = rigid(rot_z(5.0 + 4.0 * j), [1.0 + j, -2.0 + 0.5 * j, 0.2])
        sel = rng.choice(8192, 1024, replace=False)
        scans.append(into_frame(pts[sel], T))
        sfeats.append(feats[sel])
        gts.append(T)
    return pts, feats, np.stack(scans), np.stack(sfeats), gts


def corr_case(world):
    """`test_map_sharded_correspondences_match_single_device`: exact
    duplicate descriptors planted across shard boundaries (the lowest
    global row must win), every 17th row masked."""
    rng = np.random.RandomState(42)
    m, n, d = 1024, 256, 16
    pts = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    feats = rng.normal(size=(m, d)).astype(np.float32)
    shard = m // world
    feats[(world - 1) * shard + 7] = feats[5]
    feats[(world - 1) * shard + 1] = feats[min(shard, m // 2) + 2]
    scan_pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    scan_feats = feats[rng.choice(m, n, replace=False)] + 0.0
    mm = np.ones(m, bool)
    mm[::17] = False
    return pts, feats, mm, scan_pts, scan_feats


def pairs(b, m, n, d=16, seed=42):
    """`tests/test_parallel.py:_make_pairs`: b scan-map pairs."""
    rng = np.random.RandomState(seed)
    map_pts = np.zeros((b, m, 3), np.float32)
    map_feats = np.zeros((b, m, d), np.float32)
    scan_pts = np.zeros((b, n, 3), np.float32)
    scan_feats = np.zeros((b, n, d), np.float32)
    poses = []
    for i in range(b):
        pts = np.c_[rng.uniform(-20, 20, (m, 2)), rng.uniform(0, 5, (m, 1))].astype(np.float32)
        feats = np.sin(pts @ rng.normal(size=(3, d)).astype(np.float32) * 0.2)
        T = rigid(rot_z(rng.uniform(-20, 20)), [rng.uniform(-3, 3), rng.uniform(-3, 3), 0.1])
        sel = rng.choice(m, n, replace=False)
        map_pts[i], map_feats[i] = pts, feats
        scan_pts[i], scan_feats[i] = into_frame(pts[sel], T), feats[sel]
        poses.append(T)
    return map_pts, map_feats, np.ones((b, m), bool), scan_pts, scan_feats, np.ones((b, n), bool), poses


# ---------------------------------------------------------------------------
# The ranks' work
# ---------------------------------------------------------------------------


def mesh_checks(rank, world, picks):
    """Every `parallel/mesh.py` function at this world size, with the single-
    device rows they are held to (tests/test_torch_mesh.py reads the
    result). `picks` holds the reference's per-device RANSAC picks,
    [world, (scans,) K, 3]: "pair" for `ransac_pair`, "batch" for
    `ransac_batch`, "clear" for the three `ransac_clear` scans."""
    import torch

    from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
    from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences
    from vfmreg_tpu_torch.parallel import mesh as M
    from vfmreg_tpu_torch.registration.icp import register_frame_icp
    from vfmreg_tpu_torch.registration.ransac import ransac_registration
    from vfmreg_tpu_torch.registration.vfm_icp import register_frame_vfm

    t = torch.from_numpy
    out = {}
    mesh = M.make_mesh(("model",))

    def rows(a):
        return M.shard_rows(t(np.ascontiguousarray(a)), mesh, "model")

    # RANSAC: the reference's picks, the seeded draw, and one device fed
    # every rank's picks in rank order.
    src, tgt, mask, _ = ransac_pair()
    run = M.sharded_ransac(mesh, num_hypotheses=4096, axis="model")
    out["ransac_picks"] = [x.numpy() for x in run(t(src), t(tgt), t(mask), 0, picks=t(picks["pair"][rank]))]
    out["ransac_seeded"] = [x.numpy() for x in run(t(src), t(tgt), t(mask), 0)]
    single = ransac_registration(t(src), t(tgt), t(mask), picks=t(np.concatenate(list(picks["pair"]))))
    out["ransac_single"] = [single.pose.numpy(), single.rmse.numpy()]
    bsrc, btgt, bmask, _ = ransac_batch()
    batched = M.hypothesis_sharded_batched_ransac(mesh, num_hypotheses=4096, axis="model")
    bp = picks["batch"][rank]
    out["batch"] = batched(t(bsrc), t(btgt), t(bmask), range(3), picks=t(bp)).numpy()
    out["batch_serial"] = np.stack([run(t(bsrc[j]), t(btgt[j]), t(bmask[j]), j, picks=t(bp[j]))[0].numpy()
                                    for j in range(3)])
    out["batch_seeded"] = batched(t(bsrc), t(btgt), t(bmask), range(3)).numpy()
    csrc, ctgt, cmask = (np.stack(a) for a in zip(*(ransac_clear(j) for j in range(3))))
    cp = picks["clear"][rank]
    budget = cp.shape[1] * world
    run = M.sharded_ransac(mesh, num_hypotheses=budget, axis="model")
    out["clear_serial"] = [np.stack(a) for a in zip(*(
        [x.numpy() for x in run(t(csrc[j]), t(ctgt[j]), t(cmask[j]), j, picks=t(cp[j]))] for j in range(3)))]
    batched = M.hypothesis_sharded_batched_ransac(mesh, num_hypotheses=budget, axis="model")
    out["clear_batch"] = batched(t(csrc), t(ctgt), t(cmask), range(3), picks=t(cp)).numpy()

    # Map-sharded ICP: refresh 1, the default refresh, masked padding rows.
    eye = torch.eye(4)
    for name, (pts, scan, _), refresh in (("icp_r1", icp_refresh1(), 1),
                                          ("icp_default", icp_default_refresh(), None)):
        fn = M.map_sharded_icp(mesh, 1.0, refresh_interval=refresh)
        n = scan.shape[0]
        ones = torch.ones(n, dtype=torch.bool)
        out[name] = fn(rows(pts), rows(np.ones(len(pts), bool)), t(scan), ones, eye, 2.0, 0.5).numpy()
        grid = build_hash_grid(t(pts), 1.0)
        kw = {} if refresh is None else {"refresh_interval": refresh}
        out[name + "_single"] = register_frame_icp(grid, t(scan), ones, eye, 2.0, 0.5, **kw).numpy()
    pts, mp, mmask, scan, _ = icp_padded(world)
    fn = M.map_sharded_icp(mesh, 1.0, refresh_interval=1)
    ones = torch.ones(scan.shape[0], dtype=torch.bool)
    out["icp_padded"] = fn(rows(mp), rows(mmask), t(scan), ones, eye, 2.0, 0.5).numpy()
    out["icp_padded_single"] = register_frame_icp(build_hash_grid(t(pts), 1.0), t(scan), ones, eye, 2.0, 0.5,
                                                  refresh_interval=1).numpy()

    # Map-sharded correspondences against the single-device search.
    cp, cf, cm, sp, sf = corr_case(world)
    sm = torch.ones(sp.shape[0], dtype=torch.bool)
    got = M.get_vfm_correspondences_map_sharded(rows(cp), rows(cf), rows(cm), t(sp), t(sf), sm,
                                                mesh.get_group("model"))
    ref = get_vfm_correspondences(t(cp), t(cf), t(cm), t(sp), t(sf), sm)
    out["corr"] = [got.mask.numpy(), got.similarity.numpy(), got.target.numpy()]
    out["corr_single"] = [ref.mask.numpy(), ref.similarity.numpy(), ref.target.numpy()]

    # The flagship method against the sharded map, and on one device.
    pts, feats, scan, sfeats, _ = vfm_case()
    sm = torch.ones(scan.shape[0], dtype=torch.bool)
    fn = M.map_sharded_vfm_register(mesh, 1.0)
    pose, count = fn(rows(pts), rows(feats), rows(np.ones(len(pts), bool)), t(scan), t(sfeats), sm, eye, 3.0, 0.5)
    out["vfm"] = [pose.numpy(), int(count)]
    grid = build_hash_grid(t(pts), 1.0)
    corr = get_vfm_correspondences(t(pts), t(feats), torch.ones(len(pts), dtype=torch.bool), t(scan), t(sfeats), sm)
    out["vfm_single"] = register_frame_vfm(grid, t(scan), sm, corr, eye, 3.0, 0.5).pose.numpy()

    # dp x tp on 2 x (world / 2).
    mesh2 = M.make_mesh(("data", "model"), (2, world // 2))
    pts, feats, scans, sfeats, _ = dp_case()

    def mrows(a):
        return M.shard_rows(t(np.ascontiguousarray(a)), mesh2, "model")

    def drows(a):
        return M.shard_rows(t(np.ascontiguousarray(a)), mesh2, "data")

    fn = M.dp_map_sharded_vfm_register(mesh2, 1.0)
    poses, counts = fn(mrows(pts), mrows(feats), mrows(np.ones(len(pts), bool)), drows(scans), drows(sfeats),
                       drows(np.ones(scans.shape[:2], bool)), drows(np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))),
                       3.0, 0.5)
    out["dp"] = [poses.numpy(), counts.numpy(), drows(np.arange(4)).numpy()]

    # The pair batch over the ranks: one pair each.
    mp_, mf_, mm_, sp_, sf_, sm_, _ = pairs(world, 512, 128)
    step = M.sharded_registration_step(mesh, axis="model")
    poses, counts, total = step(*(rows(a) for a in (mp_, mf_, mm_, sp_, sf_, sm_)))
    one = M.batched_registration_step(*(rows(a) for a in (mp_, mf_, mm_, sp_, sf_, sm_)))
    out["pairs"] = [poses.numpy(), counts.numpy(), int(total), one[0].numpy(), one[1].numpy()]
    return out


def make_world(rng, n=6000, d=24, extent=60.0):
    """`tests/test_harness.py:make_world`."""
    pts = np.c_[rng.uniform(-extent, extent, (n, 2)), rng.uniform(0, 8, (n, 1))].astype(np.float32)
    W = rng.normal(size=(3, d)).astype(np.float32)
    return pts, np.sin(pts @ W * 0.08).astype(np.float32)


def write_harness_scene(folder):
    """`tests/test_harness.py:scene_h5`: two posed map clouds, two scans."""
    from vfmreg_tpu_torch.data.h5io import save_scene

    rng = np.random.RandomState(0)
    pts, feats = make_world(rng)
    map_poses, map_clouds = [], []
    for cx in (-15.0, 15.0):
        T = np.eye(4)
        T[0, 3] = cx
        keep = np.abs(pts[:, 0] - cx) < 40.0
        map_poses.append(T)
        map_clouds.append(np.c_[pts[keep] - T[:3, 3], feats[keep]])
    seq_poses, seq_clouds = [], []
    for cx in (-5.0, 8.0):
        T = np.eye(4)
        T[:3, 3] = [cx, 3.0, 0.0]
        keep = np.linalg.norm(pts[:, :2] - T[:2, 3], axis=1) < 30.0
        local = pts[keep] - T[:3, 3]
        sub = rng.choice(local.shape[0], min(3000, local.shape[0]), replace=False)
        seq_poses.append(T)
        seq_clouds.append(np.c_[local[sub], feats[keep][sub]])
    Path(folder).mkdir(parents=True, exist_ok=True)
    save_scene(Path(folder) / "scene_000.h5", ["seq_map", "seq_a", "seq_b"], map_poses, map_clouds, seq_poses,
               seq_clouds)


def write_mesh_ransac_scene(folder):
    """`tests/test_parallel.py:test_harness_uses_sharded_ransac_on_mesh`'s
    scene: one map cloud, one scan 4 m / 2 m off."""
    from vfmreg_tpu_torch.data.h5io import save_scene

    rng = np.random.RandomState(3)
    pts, feats = make_world(rng, n=4000)
    keep = np.abs(pts[:, 0]) < 45
    Ts = np.eye(4)
    Ts[:3, 3] = [4.0, 2.0, 0.0]
    sel = rng.choice(len(pts), 2000, replace=False)
    Path(folder).mkdir(parents=True, exist_ok=True)
    save_scene(Path(folder) / "scene_000.h5", ["m", "s"], [np.eye(4)], [np.c_[pts[keep], feats[keep]]], [Ts],
               [np.c_[pts[sel] - Ts[:3, 3], feats[sel]]])


def multichip_scene(n_scans, n_map=12000, n_scan=900, d=16, seed=3):
    """`tests/test_harness_multichip.py:_make_scene`: a map and scans at
    known poses (the scans' points are map points, moved into the scan's
    frame)."""
    rng = np.random.RandomState(seed)
    mp = np.c_[rng.uniform(-40, 40, (n_map, 2)), rng.uniform(0, 6, (n_map, 1))].astype(np.float32)
    W = rng.normal(size=(3, d)).astype(np.float32)
    mf = np.sin(mp @ W * 0.1).astype(np.float32)
    poses, clouds = [], []
    for _ in range(n_scans):
        center = rng.uniform(-15, 15, 2)
        near = np.flatnonzero(np.linalg.norm(mp[:, :2] - center, axis=1) < 25.0)
        sel = rng.choice(near, min(n_scan, near.size), replace=False)
        T = np.eye(4)
        T[:2, 3] = center
        poses.append(T)
        clouds.append(np.c_[(mp[sel] - T[:3, 3]).astype(np.float32), mf[sel]])
    return {"scene_poses": poses, "scene_point_clouds": clouds}, np.c_[mp, mf]


ROW_KEYS = ("gt", "vfm_ransac_raw", "vfm_ransac_icp", "icp", "corr_counts", "snap_counts", "retried", "map_size")
NODE_METHODS = dict(methods_ransac=[("vfm", True)], methods_teaser=[], methods_pointdsc=[])


def run_node(folder, rank, tag, single_device=False, **kw):
    """make_step of a node on `folder`, with the rank's captured output and
    whether its `dump_errors` wrote `folder/errors_<tag>_<rank>/mode.pkl`.
    `single_device` turns the node's multi-device modes off after it is
    built, as `tests/test_harness.py:545` builds its baseline."""
    import contextlib
    import io

    from vfmreg_tpu_torch.pipeline.registration_node import RegistrationNode

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        node = RegistrationNode(folder, device="cpu", **kw)
        if single_device:
            node.mesh, node._sharded_ransac = None, None
        node.make_step()
    pkl = Path(folder) / f"errors_{tag}_{rank}" / "mode.pkl"
    node.dump_errors(pkl)
    return {"trans": dict(node.trans_errors), "rot": dict(node.rot_errors), "log": out.getvalue(),
            "pickle": pkl.exists(), "mesh": node.mesh is not None, "map_sharded": node._map_sharded,
            "sharded_ransac": node._sharded_ransac is not None}


def driver_checks(rank, world, folders):
    """The multi-device driver at this world size (tests/test_torch_mesh_driver.py):
    the scan-sharded row on `multichip_scene` at 3 scans (more than the
    ranks) and 1 (fewer), and the node in its three modes."""
    from vfmreg_tpu_torch.parallel import mesh as M
    from vfmreg_tpu_torch.pipeline import registration_node as rn

    out = {}
    mesh = M.make_mesh(("data",))
    scene, local_map = multichip_scene(3)
    for b in (3, 1):
        sc = {k: v[:b] for k, v in scene.items()}
        res = rn.precompute_scene_batched(sc, local_map, device="cpu", mesh=mesh)
        out[f"rows_{b}"] = {k: res[k] for k in ROW_KEYS}
    harness, ransac_scene = folders
    # The map-sharded node's baseline, as `tests/test_harness.py:545` has it:
    # the single-device row, its RANSAC drawing the map-sharded mode's
    # stream (every scan's budget split over the ranks).
    hyp = M.hypothesis_sharded_batched_ransac(mesh, rn.RANSAC_HYPOTHESES)
    batched_ransac = rn.batched_ransac
    rn.batched_ransac = lambda src, tgt, mask, seeds, num_hypotheses: hyp(src, tgt, mask, seeds)
    try:
        out["baseline"] = run_node(harness, rank, "baseline", single_device=True, batch_scans=True, **NODE_METHODS)
    finally:
        rn.batched_ransac = batched_ransac
    out["map_sharded"] = run_node(harness, rank, "map_sharded", batch_scans=True, map_sharding=True,
                                  **NODE_METHODS)
    out["scan_sharded"] = run_node(harness, rank, "scan_sharded", batch_scans=True, **NODE_METHODS)
    out["serial"] = run_node(ransac_scene, rank, "serial", methods_ransac=[("vfm", False)], methods_teaser=[],
                             methods_pointdsc=[], batch_scans=False)
    return out


# ---------------------------------------------------------------------------
# The trainer's dp x tp split (tests/test_torch_trainer_mesh.py)
# ---------------------------------------------------------------------------

# Each case: the ("data", "model") mesh shape at world size 4 and the ViT's
# head count (64 wide either way): 4 heads divide every model axis here, 2
# heads at "model" = 4 give each rank half a head.
TRAIN_CASES = {"dp2_tp2": ((2, 2), 4), "tp4": ((1, 4), 4), "tp4_split_heads": ((1, 4), 2), "dp4": ((4, 1), 4)}


def train_vit_config(heads=4):
    """tests/test_trainer.py's TINY ViT with `heads` heads."""
    from vfmreg_tpu_torch.models.vit import ViTConfig

    return ViTConfig(hidden_size=64, num_layers=2, num_heads=heads, patch_size=14, pretrain_img_size=56,
                     use_flash_attention=False)


def train_config():
    from vfmreg_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(adapter_hidden=64, adapter_out=32)


def train_batch(seed=42, b=4, hw=56, k=8, grid=16):
    """tests/test_trainer.py's `_batch`: 4 pairs of 56 x 56 views, K = 8."""
    rng = np.random.RandomState(seed)
    ia = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    ib = ia + 0.05 * rng.normal(size=ia.shape).astype(np.float32)
    idx = rng.randint(0, grid, (b, k)).astype(np.int32)
    return ia, ib, idx


def trainer_checks(rank, world, ckpt_dir, single_ckpt):
    """Each TRAIN_CASES split from `create_train_state(seed 0)`: the local q
    weight's shape, step 1's loss, accuracy and gathered gradients, step 2's
    loss and gathered parameters; a batch of 3 refused at "data" = 4 and 2;
    the tp4 case's state checkpointed into `ckpt_dir` after step 2; and the
    one-process checkpoint `single_ckpt` restored at (2, 2): its gathered
    parameters and moments, and the next step's loss."""
    import torch

    from vfmreg_tpu_torch.parallel.mesh import make_mesh
    from vfmreg_tpu_torch.train import trainer as T

    tcfg = train_config()
    ia, ib, idx = train_batch()

    def gathered(state, key=None):
        named = dict(state.model.named_parameters())
        if key == "grad":
            tensors = {n: p.grad for n, p in named.items()}
        elif key is not None:
            tensors = {n: state.optimizer.state[p][key] for n, p in named.items()}
        else:
            tensors = named
        return {n: v.numpy() for n, v in T.gather_full(state.model, tensors).items()}

    out = {}
    for name, (shape, heads) in TRAIN_CASES.items():
        mesh = make_mesh(("data", "model"), shape)
        cfg = train_vit_config(heads)
        state, _, _ = T.create_train_state(torch.Generator().manual_seed(0), cfg, mesh, tcfg, "cpu")
        step = T.make_train_step(cfg, mesh, tcfg)
        r = {"q_shard": tuple(state.model.vit.blocks[0].attn.q.weight.shape)}
        state, m = step(state, ia, ib, idx)
        r.update(loss=float(m["loss"]), accuracy=float(m["accuracy"]), grads=gathered(state, "grad"))
        state, m = step(state, ia, ib, idx)
        r.update(loss2=float(m["loss"]), params2=gathered(state))
        if shape[0] > 1:
            try:
                step(state, ia[:3], ib[:3], idx[:3])
                r["odd_batch"] = "accepted"
            except ValueError as e:
                r["odd_batch"] = str(e)
        if name == "tp4":
            r["ckpt"] = T.save_checkpoint(ckpt_dir, state)
        out[name] = r

    mesh = make_mesh(("data", "model"), (2, 2))
    cfg = train_vit_config()
    state, _, _ = T.create_train_state(torch.Generator().manual_seed(9), cfg, mesh, tcfg, "cpu")
    state = T.restore_checkpoint(single_ckpt, state)
    r = {"step": state.step, "params": gathered(state), "exp_avg": gathered(state, "exp_avg"),
         "exp_avg_sq": gathered(state, "exp_avg_sq")}
    state, m = T.make_train_step(cfg, mesh, tcfg)(state, ia, ib, idx)
    r["loss_next"] = float(m["loss"])
    out["restored"] = r
    return out
