"""Scan-to-map VFM registration: the port's main path.

Counterpart of `bench.py:_run_workload` (`:86-153`), staged the same way:
build the voxel hash grid of the map once, voxelize each scan at 5 m and keep
`n_vfm` queries, match the flattened batch against the map descriptors in one
cosine arg-max (kernel B1), then register the scans with VFM-ICP as lanes
of one loop, as the reference vmaps `register_frame_vfm`
(`registration.vfm_icp.register_frames_vfm_lanes`: phase 1 on the device,
phase 2 one `registration.icp.geometric_icp_loop_lanes` over the batch, with
kernel B3 in every champion rebuild and kernel B2 in every GN step).

`shared_map_batch` is a copy of `bench.py:_shared_map_batch` (`:46-83`) with
the same seed semantics, which also returns each scan's true pose.

Run as a script to register a small synthetic batch and print the errors:

    python -m vfmreg_tpu_torch.scan_to_map [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.metrics import compute_errors
from vfmreg_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences_batched
from vfmreg_tpu_torch.ops.voxel import voxel_down_sample_masked
from vfmreg_tpu_torch.registration.icp import MAX_NUM_ITERATIONS
from vfmreg_tpu_torch.registration.vfm_icp import register_frames_vfm_lanes
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision
from vfmreg_tpu_torch.utils.profiling import span

MAP_VOXEL_SIZE = 1.0
VFM_VOXEL_SIZE = 5.0  # Registration.cpp:217
MAX_CORRESPONDENCE_DISTANCE = 6.0
KERNEL = 0.667


class SceneBatch(NamedTuple):
    map_points: np.ndarray  # [M, 3] f32
    map_feats: np.ndarray  # [M, D] f32
    scans: np.ndarray  # [B, N, 3] f32, each in its own sensor frame
    scan_feats: np.ndarray  # [B, N, D] f32
    true_poses: np.ndarray  # [B, 4, 4] f64, scan frame -> map frame


def shared_map_batch(batch, n_map, n_scan, d, seed=0, offset=True) -> SceneBatch:
    """One world map and `batch` scans sampled from it. With `offset`, each
    scan is observed from a frame misaligned by |t| in [0.2, 0.5] m and a
    rotation in [0.5, 2] deg; registration must recover that pose."""
    rng = np.random.RandomState(seed)
    mp = np.c_[rng.uniform(-100, 100, (n_map, 2)), rng.uniform(0, 8, (n_map, 1))].astype(np.float32)
    W = rng.normal(size=(3, d)).astype(np.float32)
    mf = np.sin(mp @ W * 0.1).astype(np.float32)
    scans, sfeats, poses = [], [], []
    for _ in range(batch):
        sel = rng.choice(n_map, n_scan, replace=False)
        pts = mp[sel] + rng.normal(0, 0.02, (n_scan, 3)).astype(np.float32)
        T = np.eye(4)
        if offset:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            ang = np.deg2rad(rng.uniform(0.5, 2.0))
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
            R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
            t_dir = rng.normal(size=3)
            t = t_dir / np.linalg.norm(t_dir) * rng.uniform(0.2, 0.5)
            pts = ((pts - t) @ R).astype(np.float32)
            T[:3, :3], T[:3, 3] = R, t
        scans.append(pts)
        sfeats.append(mf[sel])
        poses.append(T)
    return SceneBatch(mp, mf, np.stack(scans), np.stack(sfeats), np.stack(poses))


def vfm_queries(scans, scan_feats, scan_mask, n_vfm: int):
    """5 m voxelize each scan [B, N, 3] and keep the first `n_vfm`
    representatives: the query set of the cosine matching
    (`Registration.cpp:217`). Returns (points, feats, mask) with [B, n_vfm] leading axes."""
    with span("queries"):
        p5, f5, m5 = [], [], []
        for i in range(scans.shape[0]):
            p, f, m = voxel_down_sample_masked(scans[i], VFM_VOXEL_SIZE, mask=scan_mask[i], feats=scan_feats[i])
            p5.append(p[:n_vfm])
            f5.append(f[:n_vfm])
            m5.append(m[:n_vfm])
        return torch.stack(p5), torch.stack(f5), torch.stack(m5)


class ScanToMapResult(NamedTuple):
    poses: np.ndarray  # [B, 4, 4] f32
    vfm_iterations: np.ndarray  # [B] phase-1 GN iterations
    iterations: np.ndarray  # [B] all GN iterations (phase 2 = the difference)
    n_correspondences: np.ndarray  # [B] accepted cosine correspondences
    rebuilds: np.ndarray  # [B] phase 2's champion-cache rebuilds
    # The lane loop's counts (`registration.vfm_icp.VFMLanes.loop`: phase 1's
    # steps and reads; phase 2's B2 step calls, reads, B3 launches).
    loop: collections.Counter


def scan_to_map(
    map_points,
    map_feats,
    scans,
    scan_feats,
    n_vfm: int = 512,
    max_iterations: int = MAX_NUM_ITERATIONS,
    device=None,
    grid: Optional[HashGrid] = None,
) -> ScanToMapResult:
    """Register B scans [B, N, 3] (descriptors [B, N, D]) to one map [M, 3]
    (descriptors [M, D]), each from the identity initial guess.

    Arrays may be numpy or torch; they are moved to `device` (default: the
    card). `grid`, if given, is used in place of building one from the map.

    The call is the span `scan_to_map`, in which the grid's build, the
    queries, the matching and VFM-ICP carry their own spans
    (`utils.profiling.span`)."""
    full_precision()
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    with span("scan_to_map"):
        mp, mf, sp, sf = put(map_points), put(map_feats), put(scans), put(scan_feats)
        b, n = sp.shape[:2]
        if grid is None:
            grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
        sm = torch.ones((b, n), dtype=torch.bool, device=dev)

        p5, f5, m5 = vfm_queries(sp, sf, sm, n_vfm)
        corrs = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, p5, f5, m5)

        eye = torch.eye(4, dtype=torch.float32).expand(b, 4, 4)
        res = register_frames_vfm_lanes(grid, sp, sm, corrs, eye, MAX_CORRESPONDENCE_DISTANCE, KERNEL,
                                        max_iterations=max_iterations)
        return ScanToMapResult(res.poses.numpy(), res.vfm_iterations, res.iterations,
                               corrs.count.cpu().numpy(), res.rebuilds, res.loop)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    scene = shared_map_batch(2, 8192, 1024, 32, seed=0)
    res = scan_to_map(scene.map_points, scene.map_feats, scene.scans, scene.scan_feats,
                      device=args.device)
    errs = [compute_errors(p.astype(np.float64), t) for p, t in zip(res.poses, scene.true_poses)]
    print(json.dumps({
        "rte_m": [e[0] for e in errs], "rre_deg": [e[1] for e in errs],
        "iterations": res.iterations.tolist(), "vfm_iterations": res.vfm_iterations.tolist(),
    }))


if __name__ == "__main__":
    main()
