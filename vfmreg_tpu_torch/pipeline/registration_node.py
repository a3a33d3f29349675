"""The evaluation driver's batched method row for one scene on one device.

Counterpart of the single-device, device-preprocessing, vfm-row branch of
`vfmreg_tpu/pipeline/registration_node.py:RegistrationNode
._precompute_scene_batched` (`:747-1225`), with its helpers `orthogonalize`
(`:58`), `_preprocess_scans_device` (`:72`), `_voxelize_batch` (`:114`) and
`_replace_corr_rows` (`:127`), and the recall table of `_print_summary`
(`:1472-1506`). Per scene:

1. the map's voxel hash grid, built as `VoxelHashMap.device_grid()` builds it
   (padded to `bucket_size(n)`, at most 20 points per voxel);
2. device preprocessing of the B scans: 0.1 m voxelize, KISS double
   downsample (0.5 v, 1.0 v), and the 5 m query voxelize cut to `q5_budget`;
3. cosine matching of the 5 m queries against the map descriptors (kernel
   B1), a full-width re-match of scans whose 5 m query set overflowed the
   budget, and a 1 m retry of scans below 75 correspondences;
4. the accepted correspondences compacted to the front (stable) and cut to
   `bucket_size(max count)`, then snapped to the voxelized clouds;
5. 50,000-hypothesis RANSAC per scan, orthogonalized on the host in f64;
6. GT ICP (from the stored GT poses) and the RANSAC refine ICP, as two
   separate rows at (3 sigma, sigma / 3);
7. the two-phase vanilla ICP row from the identity at (7 sigma, sigma / 7).

Every ICP row steps all its lanes together on the device
(`registration.icp.geometric_icp_loop_lanes`): one kernel B2 call per GN
step of the row, one kernel B3 launch per round of champion rebuilds.

It reads from the device three times, as the reference does: the
correspondence counts (which decide the retry and the ICP width), the RANSAC
poses (for the f64 orthogonalization), and one final read; the re-match and
retry paths add one read each. The ICP rows read a small vector of lane
state once per `GN_STEPS_PER_READ` GN steps, because their loops decide on
the host where the lanes go between steps. The call is the span `row`
(`utils.profiling.span`), and each stage one span inside it: `row.grid_build`,
`row.preprocess`, `row.match`, `row.snap`, `row.ransac`, `row.gt_refine_icp`,
`row.vanilla_icp` and `row.final_read`, which together cover the call. Under
a recording profiler they are marks on its clock. `stats["seconds"]` holds
the row's wall time ("total"). With `VFMREG_PROFILE_DRIVER=1` the stage
spans are a stage clock: every stage ends with a synchronize on the card,
its seconds land under its own key, and the row prints the reference's
`[profile] driver stage breakdown (s): ...` line: the barriers take away the overlap of host and device that the row has
without them, so the row's time under the switch is not its time.
`VFMREG_PROFILE_ICP_ITERS=1` prints each single-device ICP row's lanes'
iterations and settled flags, and runs the vanilla row as one full-budget
loop, as the reference does (`:1112-1122`, `:1155`).

With a `mesh` (`parallel.mesh.make_mesh`; every rank of its group calls the
row with the same scene) the stages run on several devices, as the
reference's do on a device mesh (`:796-840`, `:1103-1110`): the scan axis
split over the ranks (`sharded_driver_stages`, the batch padded to a
multiple of the world size by repeating scan 0; with fewer scans than
ranks only RANSAC is split, by hypotheses), or with `map_sharded` the map's
rows (`map_sharded_driver_stages`, the rows padded to ceil(bucket / world)
x world; the vanilla row then runs as one full-budget loop, as the
reference's does).

`RegistrationNode` is the scene loop around that row (reference
`registration_node.py:157-1519`): it reads `scene_*.h5` files, accumulates
the map, runs the method matrix per scan (the batched row, or the serial
per-scan methods), the baseline descriptors' RANSAC columns, the serial
TEASER column, the PointDSC column, and keeps the errors, the recall
summary, the error pickle and, with `dump_viz_dir`, per-scan PLY files. It
also runs the reference's experiment modes (cluster removal and insertion,
scan-to-scan; see the class). Run as the reference's CLI:

    python -m vfmreg_tpu_torch.pipeline.registration_node FOLDER [--device cpu] [--dump-viz DIR]
        [--cluster-removal-sweep]

(reading the scene files needs `h5py`). `pipeline/synthetic.py` runs the
batched row on a small synthetic scene.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import pickle
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vfmreg_tpu_torch.config import INITIAL_THRESHOLD, MAX_POINTS_PER_VOXEL, VOXEL_SIZE, load_config
from vfmreg_tpu_torch.data.h5io import read_scenes
from vfmreg_tpu_torch.descriptors import get_extractor
from vfmreg_tpu_torch.geometry.metrics import compute_errors, success_rate
from vfmreg_tpu_torch.ops.hash_grid import HashGrid, build_padded_grid
from vfmreg_tpu_torch.ops.matching import (
    VFMCorrespondences, get_vfm_correspondences_batched, mutual_nn_correspondences,
)
from vfmreg_tpu_torch.ops.voxel import bucket_size, voxel_down_sample_masked
from vfmreg_tpu_torch.parallel import collectives
from vfmreg_tpu_torch.parallel.mesh import (
    SUM,
    batched_icp_stats,
    batched_icp_two_phase,
    batched_ransac,
    hypothesis_sharded_batched_ransac,
    make_mesh,
    map_sharded_driver_stages,
    shard_rows,
    sharded_driver_stages,
    sharded_ransac,
)
from vfmreg_tpu_torch.registration.icp import MAX_NUM_ITERATIONS, BatchedICP
from vfmreg_tpu_torch.kiss import VoxelHashMap, get_voxel_hash_map, register_frame, voxel_down_sample
from vfmreg_tpu_torch.registration.ransac import ransac_registration, snap_correspondences
from vfmreg_tpu_torch.registration.teaser import teaser_registration_exact
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.logging import print_msg
from vfmreg_tpu_torch.utils.hdbscan import hdbscan_labels
from vfmreg_tpu_torch.utils.pcl import KNeighbors, transform_pcl
from vfmreg_tpu_torch.utils.precision import full_precision
from vfmreg_tpu_torch.utils.profiling import Timer, span

RANSAC_HYPOTHESES = 50000  # registration_node.py:319-327
RETRY_BELOW = 75  # correspondences below which a scan takes the 1 m retry
# The recall table's (RTE m, RRE deg) thresholds and rows (`:1490-1500`).
THRESHOLDS = ((0.3, 15), (0.6, 1.5), (2, 5))
METHODS = ("vfm_ransac", "vfm_ransac_icp", "icp")


def orthogonalize(Rm: np.ndarray) -> np.ndarray:
    """Newton-iteration orthogonalization in f64 (`registration_node.py:333-335`)."""
    R = np.asarray(Rm, dtype=np.float64)
    for _ in range(50):
        if abs(1.0 - np.linalg.det(R)) <= 1e-12:
            break
        R = 1.5 * R - 0.5 * (R @ R.T @ R)
    return R


def _preprocess_scans_device(raw, raw_mask, voxel_size: float, q_budget: int):
    """Per scan of the padded batch raw [B, N, 3 + D]: 0.1 m first-wins
    voxelize, the KISS double downsample (0.5 v, 1.0 v) and the 5 m query
    voxelize, descriptors carried along, survivors compacted to the front in
    input order. Returns (s_xyz [B,N,3], s_feats [B,N,D], s_mask [B,N],
    s_counts [B], q5_xyz [B,Q,3], q5_feats [B,Q,D], q5_mask [B,Q],
    q5_total [B]) with Q = min(q_budget, N)."""
    outs = []
    for pc, m in zip(raw, raw_mask):
        p, f, m_ = voxel_down_sample_masked(pc[:, :3], 0.1, mask=m, feats=pc[:, 3:])
        p, f, m_ = voxel_down_sample_masked(p, 0.5 * voxel_size, mask=m_, feats=f)
        p, f, m_ = voxel_down_sample_masked(p, 1.0 * voxel_size, mask=m_, feats=f)
        q5, qf5, qm5 = voxel_down_sample_masked(p, 5.0, mask=m_, feats=f)
        outs.append((p, f, m_, q5[:q_budget], qf5[:q_budget], qm5[:q_budget], qm5.sum()))
    p, f, m, q5, qf5, qm5, q5_total = (torch.stack(a) for a in zip(*outs))
    return p, f, m, m.sum(dim=1), q5, qf5, qm5, q5_total


def _voxelize_batch(p, m, f, size: float):
    """First-wins voxelize of each scan row at `size`: the full-width 5 m
    re-pass of scans that overflow the query budget."""
    outs = [voxel_down_sample_masked(pp, size, mask=mm, feats=ff) for pp, mm, ff in zip(p, m, f)]
    q, qf, qm = (torch.stack(a) for a in zip(*outs))
    return q, qf, qm


def _replace_corr_rows(c_src, c_tgt, c_mask, corr_new: VFMCorrespondences, scan_rows):
    """Route row r of the freshly matched `corr_new` to scan `scan_rows[r]`,
    keeping every other scan's correspondences; both are zero-padded to a
    common width."""
    n_corr = max(c_src.shape[1], corr_new.source.shape[1])

    def pad_to(a):
        pad = [0, 0] * (a.ndim - 2) + [0, n_corr - a.shape[1]]
        return torch.nn.functional.pad(a, pad)

    c_src, c_tgt, c_mask = pad_to(c_src), pad_to(c_tgt), pad_to(c_mask)
    n_src, n_tgt, n_mask = pad_to(corr_new.source), pad_to(corr_new.target), pad_to(corr_new.mask)
    for r, j in enumerate(scan_rows):
        c_src[j], c_tgt[j], c_mask[j] = n_src[r], n_tgt[r], n_mask[r]
    return c_src, c_tgt, c_mask


def stack_scans(clouds: Sequence[np.ndarray], dims: int):
    """Pad scans to the widest scan's bucket: (points [B, n, dims], mask [B, n])."""
    n = max(bucket_size(max(c.shape[0], 1)) for c in clouds)
    out = np.zeros((len(clouds), n, dims), np.float32)
    m = np.zeros((len(clouds), n), bool)
    for j, c in enumerate(clouds):
        out[j, : c.shape[0]] = c[:, :dims]
        m[j, : c.shape[0]] = True
    return out, m


def build_map_grid(local_map, voxel_size: float, dev: torch.device):
    """`VoxelHashMap.device_grid()` of a map [M, 3 + D] (numpy or tensor) on
    `dev`: padded to `bucket_size(M)` rows, with the per-voxel cap."""
    lm = torch.as_tensor(local_map, dtype=torch.float32).to(dev)
    return build_padded_grid(lm[:, :3], lm[:, 3:] if lm.shape[1] > 3 else None, voxel_size,
                             MAX_POINTS_PER_VOXEL)


def _pad_scans(arrays, n_dev: int):
    """The leading scan axis of each array padded to a multiple of `n_dev`
    by repeating row 0 (reference `:806-815`); callers cut the rows back."""
    b0 = arrays[0].shape[0]
    r = (-b0) % n_dev
    if r == 0:
        return tuple(arrays)
    return tuple(torch.cat([a, a[:1].expand(r, *a.shape[1:])]) for a in arrays)


def _first_rows(r: BatchedICP, n: int) -> BatchedICP:
    return BatchedICP(r.poses[:n], r.iterations[:n], r.settled[:n], r.rebuilds[:n], r.loop)


def precompute_scene_batched(
    scene: Dict,
    local_map,
    device=None,
    q5_budget: int = 2048,
    grid: Optional[HashGrid] = None,
    viz: bool = False,
    mesh=None,
    map_sharded: bool = False,
) -> Dict:
    """The method row of one scene (see the module docstring).

    `scene` holds "scene_poses" (B GT poses, 4x4) and "scene_point_clouds"
    (B scans [n, 3 + D] in their own frames), or, in place of the clouds,
    "scene_point_clouds_device": (raw [B, N, 3 + D], mask [B, N]) already
    stacked. `local_map` is [M, 3 + D]. Runs on `device` (default: the card).
    `grid` is the map's grid where the caller has built it
    (`build_map_grid`'s, or `kiss.mapping.VoxelHashMap.device_grid()` of the
    same map with descriptors, which is the same grid); the map-sharded mode
    builds its own. `mesh` (a 1-D `DeviceMesh`) runs the stages over its
    ranks, scan-sharded or, with `map_sharded`, map-sharded.

    Returns the reference's keys: "gt", "vfm_ransac_raw",
    "vfm_ransac_ortho", "vfm_ransac_icp", "icp" ([B, 4, 4] f64),
    "corr_counts", "snap_counts", "map_size", "scan_sizes", "retried",
    "viz_corr" (with `viz`, per scan the snapped pairs RANSAC kept, (src
    [k, 3], tgt [k, 3]) f32, read with the final read; else None), and
    "stats": seconds ("total", and per stage under VFMREG_PROFILE_DRIVER)
    and, per ICP row, GN iterations, settled flags and champion rebuilds
    per lane, and the row loop's counts (`registration.icp.ICPLanes.loop`,
    this rank's: kernel B2 step calls, device reads, kernel B3 launches,
    lanes rebuilt and gathered)."""
    full_precision()
    dev = resolve_device(device)
    sigma, voxel_size = INITIAL_THRESHOLD, VOXEL_SIZE
    profile = os.environ.get("VFMREG_PROFILE_DRIVER") == "1"
    profile_icp = os.environ.get("VFMREG_PROFILE_ICP_ITERS") == "1"
    timer = Timer() if profile else None  # the stage spans' clock

    t_start = time.perf_counter()
    with span("row"):
        with span("row.grid_build", timer, dev):
            poses = np.stack([np.asarray(p, dtype=np.float64) for p in scene["scene_poses"]])
            b = poses.shape[0]

            stages = ms = hyp = None
            n_dev = 1
            if mesh is not None:
                axis = mesh.mesh_dim_names[0]
                group = mesh.get_group(axis)
                n_dev = torch.distributed.get_world_size(group)
                if map_sharded:
                    ms = map_sharded_driver_stages(mesh, voxel_size, RANSAC_HYPOTHESES, axis=axis,
                                                   max_points_per_voxel=MAX_POINTS_PER_VOXEL)
                else:
                    stages = sharded_driver_stages(mesh, RANSAC_HYPOTHESES, axis=axis)
                    hyp = hypothesis_sharded_batched_ransac(mesh, RANSAC_HYPOTHESES, axis=axis)

            if ms is not None:
                # This rank's grid over its block of the map's rows, padded to
                # ceil(bucket / world) x world (reference `:823-840`).
                lm = torch.as_tensor(local_map, dtype=torch.float32).to(dev)
                m0 = lm.shape[0]
                rows = -(-max(bucket_size(max(m0, 1)), n_dev) // n_dev) * n_dev
                padded = torch.zeros((rows, lm.shape[1]), dtype=torch.float32, device=dev)
                padded[:m0] = lm
                valid = torch.arange(rows, device=dev) < m0
                grid = ms["build"](*(shard_rows(a, mesh, axis) for a in (padded[:, :3], padded[:, 3:], valid)))
            elif grid is None:
                grid = build_map_grid(local_map, voxel_size, dev)

        with span("row.preprocess", timer, dev):
            resident = scene.get("scene_point_clouds_device")
            if resident is not None:
                raw, raw_mask = (t.to(dev) for t in resident)
            else:
                raw_np, mask_np = stack_scans(scene["scene_point_clouds"], local_map.shape[1])
                raw, raw_mask = torch.from_numpy(raw_np).to(dev), torch.from_numpy(mask_np).to(dev)
            p3, f3, m3, counts3_dev, q5x, q5f, q5m, q5_total = _preprocess_scans_device(
                raw, raw_mask, voxel_size, q_budget=q5_budget
            )

        with span("row.match", timer, dev):
            def match(qx, qf, qm) -> VFMCorrespondences:
                if ms is not None:
                    return ms["match"](grid, qx, qf, qm)
                if stages is not None:
                    corr = stages["match"](grid.points, grid.feats, grid.valid, *_pad_scans((qx, qf, qm), n_dev))
                    return VFMCorrespondences(*(f[: qx.shape[0]] for f in corr))
                return get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, qx, qf, qm)

            # 5 m pass for every scan. Sync 1: the counts that decide the retry, and
            # the scan survivor counts that set the ICP operand width.
            corr5 = match(q5x, q5f, q5m)
            sync1 = torch.stack([corr5.mask.sum(dim=1), counts3_dev, q5_total]).cpu().numpy()
            counts5, counts3, q5_tot = sync1[0].copy(), sync1[1], sync1[2]
            W = min(bucket_size(max(int(counts3.max()), 1)), p3.shape[1])
            s_xyz, s_mask = p3[:, :W], m3[:, :W]
            scan_sizes = [int(x) for x in counts3]

            c_src, c_tgt, c_mask = corr5.source, corr5.target, corr5.mask
            # Scans with more occupied 5 m voxels than the query budget were matched
            # on a truncated query set: re-match them at full width.
            overflow = [j for j in range(b) if int(q5_tot[j]) > q5x.shape[1]]
            if overflow:
                print(f"[WARNING] 5 m query budget ({q5x.shape[1]}) exceeded by "
                      f"{len(overflow)} scan(s); re-matching them at full width")
                rows_o = torch.tensor(overflow, dtype=torch.int64, device=dev)
                corr5o = match(*_voxelize_batch(p3[rows_o], m3[rows_o], f3[rows_o], size=5.0))
                counts5o = corr5o.mask.sum(dim=1).cpu().numpy()
                for r, j in enumerate(overflow):
                    counts5[j] = counts5o[r]
                c_src, c_tgt, c_mask = _replace_corr_rows(c_src, c_tgt, c_mask, corr5o, overflow)
            retry = [j for j in range(b) if int(counts5[j]) < RETRY_BELOW]
            corr_counts = [int(x) for x in counts5]
            if retry:
                # The reference re-voxelizes the double-voxelized cloud at 1 m. With
                # an integer voxel size (VOXEL_SIZE = 1 m) every 1 m voxel nests in
                # one voxel of that cloud, so the pass is the identity and the retry
                # queries are the cloud itself.
                rows_r = torch.tensor(retry, dtype=torch.int64, device=dev)
                corr1 = match(p3[rows_r, :W], f3[rows_r, :W], m3[rows_r, :W])
                counts1 = corr1.mask.sum(dim=1).cpu().numpy()
                for r, j in enumerate(retry):
                    corr_counts[j] = int(counts1[r])
                c_src, c_tgt, c_mask = _replace_corr_rows(c_src, c_tgt, c_mask, corr1, retry)

        # Accepted correspondences to the front (stable, so RANSAC's own
        # compaction sees the same sequence), cut to the smallest bucket.
        with span("row.snap", timer, dev):
            Wc = bucket_size(max(max(corr_counts), 1))
            if Wc < c_mask.shape[1]:
                order = torch.sort((~c_mask).to(torch.int32), dim=1, stable=True).indices[:, :Wc]
                c_src = torch.gather(c_src, 1, order[..., None].expand(-1, -1, 3))
                c_tgt = torch.gather(c_tgt, 1, order[..., None].expand(-1, -1, 3))
                c_mask = torch.gather(c_mask, 1, order)
            if ms is not None:
                snap = ms["snap"](c_src, c_tgt, c_mask, s_xyz, s_mask, grid)
            elif stages is not None:
                snap = (a[:b] for a in stages["snap"](*_pad_scans((c_src, c_tgt, c_mask, s_xyz, s_mask), n_dev),
                                                      grid.points, grid.valid))
            else:
                snap = snap_correspondences(c_src, c_tgt, c_mask, s_xyz, s_mask, grid.points, grid.valid)
            snap_src, snap_tgt, snap_mask = snap

        # Sync 2: the RANSAC poses, orthogonalized on the host in f64. Scan j's
        # hypotheses come from a generator seeded with j (`parallel.mesh
        # .rank_seed` on each rank where the budget is split).
        with span("row.ransac", timer, dev):
            if ms is not None:
                ransac_dev = ms["ransac"](snap_src, snap_tgt, snap_mask, range(b))
            elif stages is not None and b >= n_dev:
                # At least one scan a rank: each rank runs its scans' whole budget.
                ransac_dev = stages["ransac"](*_pad_scans((snap_src, snap_tgt, snap_mask), n_dev),
                                              range(b + (-b) % n_dev))[:b]
            elif hyp is not None:
                # Fewer scans than ranks: every scan's budget split over the ranks.
                ransac_dev = hyp(snap_src, snap_tgt, snap_mask, range(b))
            else:
                ransac_dev = batched_ransac(snap_src, snap_tgt, snap_mask, seeds=range(b),
                                            num_hypotheses=RANSAC_HYPOTHESES)
            ransac_raw = ransac_dev.cpu().numpy().astype(np.float64)
            ransac_ortho = ransac_raw.copy()
            for j in range(b):
                ransac_ortho[j, :3, :3] = orthogonalize(ransac_raw[j, :3, :3])

        with span("row.gt_refine_icp", timer, dev):
            def run_icp(guesses, max_dist, kernel, mode="slabs", max_iterations=MAX_NUM_ITERATIONS) -> BatchedICP:
                """One ICP row over the B scans from `guesses`. `mode` is the
                reference's rebuild_mode of the row, which it names in its
                VFMREG_PROFILE_ICP_ITERS line (the port rebuilds by planes in every
                row)."""
                g = torch.as_tensor(np.asarray(guesses, dtype=np.float32))
                if ms is not None:
                    return ms["icp"](grid, s_xyz, s_mask, g, max_dist, kernel, max_iterations)
                if stages is not None:
                    return _first_rows(stages["icp"](grid, *_pad_scans((s_xyz, s_mask, g), n_dev), max_dist, kernel,
                                                     max_iterations), b)
                r = batched_icp_stats(grid, s_xyz, s_mask, g, max_dist, kernel, max_iterations)
                if profile_icp:
                    print(f"[profile] icp lane iters ({mode}): {r.iterations.tolist()} "
                          f"settled={r.settled.tolist()}")
                return r

            # GT ICP and the refine row: two separate rows at (3 sigma, sigma / 3).
            gt = run_icp(poses, 3 * sigma, sigma / 3)
            refined = run_icp(ransac_ortho, 3 * sigma, sigma / 3)

        # The vanilla row: two phases, or one full-budget loop in the map-sharded
        # mode and under the ICP profiler (which needs the full-budget stats).
        with span("row.vanilla_icp", timer, dev):
            eye_b = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
            md7, k7 = 7 * sigma, sigma / 7
            if ms is not None or profile_icp:
                vanilla = run_icp(eye_b, md7, k7, mode="planes")
            elif stages is not None:
                def far_p1(p, m, g):
                    return _first_rows(stages["icp_planes_p1"](grid, *_pad_scans((p, m, g), n_dev), md7, k7),
                                       g.shape[0])

                def far_resume(p, m, g):
                    return stages["icp_planes_resume"](grid, p, m, g, md7, k7)

                vanilla = batched_icp_two_phase(grid, s_xyz, s_mask, torch.from_numpy(eye_b), md7, k7,
                                                stats_fn=far_p1, resume_fn=far_resume, pad_multiple=n_dev)
            else:
                vanilla = batched_icp_two_phase(grid, s_xyz, s_mask, eye_b, md7, k7)

        # Sync 3: every remaining device result in one read.
        with span("row.final_read", timer, dev):
            n_map = grid.valid.sum()[None]
            if ms is not None:
                collectives.all_reduce(n_map, SUM, group)
            final = torch.cat([snap_mask.sum(dim=1), n_map]).cpu().numpy()
            viz_corr = None
            if viz:
                pairs = [t.cpu().numpy() for t in (snap_src, snap_tgt, snap_mask)]
                viz_corr = [(pairs[0][j][pairs[2][j]], pairs[1][j][pairs[2][j]]) for j in range(b)]

        seconds = {name[len("row."):]: t for name, t in timer.totals.items()} if profile else {}
        seconds["total"] = time.perf_counter() - t_start
        if profile:
            print("[profile] driver stage breakdown (s): " + ", ".join(
                f"{k}={v:.3f}" for k, v in seconds.items() if k != "total")
                + f" | total={sum(v for k, v in seconds.items() if k != 'total'):.3f}")
    rows = {"gt": gt, "refine": refined, "icp": vanilla}
    return {
        "gt": gt.poses.numpy().astype(np.float64),
        "vfm_ransac_raw": ransac_raw,
        "vfm_ransac_ortho": ransac_ortho,
        "vfm_ransac_icp": refined.poses.numpy().astype(np.float64),
        "icp": vanilla.poses.numpy().astype(np.float64),
        "corr_counts": corr_counts,
        "snap_counts": [int(x) for x in final[:b]],
        "map_size": int(final[b]),
        "scan_sizes": scan_sizes,
        "retried": retry,
        "viz_corr": viz_corr,
        "stats": {
            "seconds": seconds,
            "icp_width": W,
            "corr_width": int(c_mask.shape[1]),
            "iterations": {k: v.iterations.tolist() for k, v in rows.items()},
            "settled": {k: v.settled.tolist() for k, v in rows.items()},
            "rebuilds": {k: v.rebuilds.tolist() for k, v in rows.items()},
            "loop": {k: dict(v.loop) for k, v in rows.items()},
        },
    }


def method_errors(result: Dict) -> Dict[str, List[Tuple[float, float]]]:
    """(RTE, RRE) per scan for each row of the recall table, measured against
    the GT ICP pose, as the reference driver scores them."""
    poses = {"vfm_ransac": result["vfm_ransac_ortho"], "vfm_ransac_icp": result["vfm_ransac_icp"],
             "icp": result["icp"]}
    return {m: [compute_errors(gt, poses[m][i]) for i, gt in enumerate(result["gt"])]
            for m in METHODS}


def recall_table(errors: Dict[str, List[Tuple[float, float]]]) -> Dict[str, List[float]]:
    """Success rate (0..1) per method at each of THRESHOLDS."""
    return {
        m: [success_rate([e[0] for e in errs], [e[1] for e in errs], t, r) for t, r in THRESHOLDS]
        for m, errs in errors.items()
    }


def format_recall_table(table: Dict[str, List[float]]) -> str:
    """The reference's summary table: one row per method, percent per threshold."""
    header = f"{'':<20}: " + "".join(f"{t:>3}, {r:<3} | " for t, r in THRESHOLDS)
    lines = [header[:-2]]
    for m, rates in table.items():
        lines.append((f"{m:<20}: " + "".join(f"{100 * x:>8.2f} | " for x in rates))[:-2])
    return "\n".join(lines)




# ---------------------------------------------------------------------------
# The scene loop: `RegistrationNode` (reference `registration_node.py:157-1519`)
# ---------------------------------------------------------------------------

TEASER_NOISE_BOUND = 0.2  # registration_node.py:112-127
# The reference's default method matrices (`registration_node.py:255-261`).
DEFAULT_RANSAC = [(m, True) for m in ("fpfh", "dip", "gedi", "fcgf", "gcl", "spinnet", "vfm")]
DEFAULT_TEASER = [("fpfh", True), ("vfm", True)]
DEFAULT_POINTDSC = [("fpfh", True), ("fcgf", True)]
# The PCA colours of the classes the removal experiment takes out: trees
# (`registration_node.py:660-662`).
REMOVE_CLASSES = [np.array([[217, 60, 165], [118, 105, 57]], dtype=np.float32)]
# `--cluster-removal-sweep`'s (file suffix, probability) modes, in the
# reference's order (`registration_node.py:1556-1563`).
SWEEP_MODES = [
    ("000", 0), ("020", 0.2), ("040", 0.4), ("060", 0.6), ("080", 0.8),
    ("100", 1.0), ("010", 0.1), ("030", 0.3), ("050", 0.5), ("070", 0.7),
    ("090", 0.9),
]


def _pad_rows(arr: np.ndarray, dev: torch.device, n: Optional[int] = None):
    """[k, c] rows zero-padded to n (default `bucket_size(k)`) rows on
    `dev`, with their mask."""
    arr = np.asarray(arr, dtype=np.float32)
    if n is None:
        n = bucket_size(max(arr.shape[0], 1))
    out = torch.zeros((n,) + arr.shape[1:], dtype=torch.float32, device=dev)
    out[: arr.shape[0]] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[: arr.shape[0]] = True
    return out, mask


class RegistrationNode:
    """The evaluation driver's scene loop, with the reference's constructor
    and method names (`vfmreg_tpu/pipeline/registration_node.py:157`).

    Per scene (`make_step` reads `scene_*.h5`, `run_scene` does the rest):
    the map clouds accumulated and voxelized at 0.25 m; per scan a 0.1 m
    voxelize, the RobotCar GT fixes, GT ICP from the stored pose, the vfm
    RANSAC column (5 m cosine matches with the 1 m retry, snap, 50,000
    hypotheses from a generator seeded with the scan index, ICP refine), the
    vfm TEASER column (exact max clique, GNC-TLS, ICP refine), the baseline
    columns below, and the two-phase vanilla ICP from the identity; errors
    against the GT ICP pose, the recall summary, and `dump_errors`' pickle.

    `batch_scans` (default: on the card, not on the CPU, as the reference
    turns it on for the TPU) runs the GT ICP, vfm RANSAC + refine and vanilla
    rows of a scene as the batched method row (`precompute_scene_batched`,
    which always preprocesses the scans on the device: the rows the host
    chain keeps). The baseline, TEASER and PointDSC columns are serial
    either way. Both paths give the same rows: GT and vanilla ICP bit for bit, RANSAC within the
    refine's tolerance (tests, `chip_smoke.py`). `rng_seed` and
    `device_preprocess` are accepted for the reference's signature and read
    by nothing.

    The baseline columns run the reference's default matrix: RANSAC over
    fpfh, dip, gedi, fcgf, gcl, spinnet (`compute_correspondences`: the
    extractors of `descriptors/`, the map's descriptors cached per method
    for the scene, the L2 1-NN), TEASER over fpfh (mutual-filtered
    correspondences) and PointDSC over fpfh and fcgf
    (`pointsdc_registration`; skipped with a message when
    `VFMREG_POINTDSC_WEIGHTS` names no file, as the reference), each with
    the ICP refine. A method whose extractor is not in the registry drops
    out of the matrices, as in the reference's `available()`.

    `dump_viz_dir` writes per scan the map (once a scene), the scan at GT
    and at the flagship estimate, and the correspondences of the last
    RANSAC column (the batched row's vfm pairs) as PLY segment pairs
    (`_dump_scan_viz`).

    The experiment modes (reference `make_step`, `:1284-1375`) turn the
    batched row off and run every scan serially on a map of its own:
    `cluster_removal_prob` p > 0 removes each tree cluster of the map with
    probability p (`_apply_cluster_removal`: `feature_generator.run_pca`
    colours, the native KD-tree's region growth, HDBSCAN), and with
    `cluster_insertion_dir` inserts int(100 p) clusters drawn from its
    `*.npy` files instead (`_apply_cluster_insertion`); `scan_to_scan`
    "data" registers each scan against its nearest map cloud, "kitti"
    against consecutive `kitti_dir/*.bin` frames (no descriptors: the vfm
    columns are skipped), both from the GT pose plus seeded noise. Their
    draws come from two `np.random.RandomState(42)` per scene and, for the
    KITTI frame, the global `np.random`, in the reference's order.

    Several devices (reference `:263-320`): when a `torch.distributed`
    process group of world size > 1 is initialised (`torchrun`; the CLI
    initialises it), every rank runs the same scene loop, the batched row's
    stages run over the ranks (`precompute_scene_batched(mesh=...)`) and the
    serial RANSAC columns split their hypotheses over them
    (`parallel.mesh.sharded_ransac`); with `map_sharding` the batched row
    splits the map's rows instead and the serial columns stay on each
    rank's device. At world size 1 both keep the single-device path, as the
    reference's do. Rank 0 alone prints, writes the error pickle and the
    `dump_viz_dir` files. Runs on `device` (default: the card)."""

    # Manual RobotCar GT improvements (`registration_node.py:597-623`).
    _ROBOTCAR_GT_FIX = {
        0: [15, 5, 0], 6: [3.5, 2, 0], 7: [10, 8, 0], 10: [5, 2, 0], 12: [3, 1, 0],
        13: [4, 2, 0], 14: [-2, 2, 0], 15: [3, 2, 0], 17: [2, 2, 0], 18: [8, 2, 0],
        21: [2, 1, 0], 23: [5, 2, 0], 24: [0, 2, 0],
    }

    def __init__(
        self,
        folder: Path,
        interactive: bool = False,
        cluster_removal_prob: float = 0,
        scan_to_scan: Optional[str] = None,
        methods_ransac: Optional[List[Tuple[str, bool]]] = None,
        methods_teaser: Optional[List[Tuple[str, bool]]] = None,
        methods_pointdsc: Optional[List[Tuple[str, bool]]] = None,
        feature_generator=None,
        viz=None,
        rng_seed: int = 42,
        cluster_insertion_dir: Optional[Path] = None,
        kitti_dir: Optional[Path] = None,
        batch_scans: Optional[bool] = None,
        device_preprocess: Optional[bool] = None,
        map_sharding: bool = False,
        dump_viz_dir: Optional[Path] = None,
        device=None,
    ) -> None:
        if scan_to_scan not in (None, "data", "kitti"):
            raise ValueError(f"scan_to_scan must be None, 'data' or 'kitti', got {scan_to_scan!r}")
        self.device = resolve_device(device)
        self.dump_viz_dir = Path(dump_viz_dir) if dump_viz_dir is not None else None
        self._viz_corr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._viz_initial = np.eye(4)
        full_precision()
        self.interactive = interactive
        self.viz = viz
        self.cluster_removal_prob = cluster_removal_prob
        self.cluster_insertion_dir = cluster_insertion_dir
        self.kitti_dir = kitti_dir
        self.scan_to_scan = scan_to_scan
        self.dino_generator = feature_generator  # run_pca provider of the removal
        if batch_scans is None:
            batch_scans = self.device.type == "cuda"
        self.batch_scans = batch_scans
        self._q5_budget = 2048
        # Host voxel-hash maps of the current local map, shared by the GT ICP,
        # correspondence and refine stages of a scene.
        self._hash_map_cache: Dict[bool, tuple] = {}

        self.filenames = sorted(Path(folder).glob("scene_*.h5"))
        # One-ahead scene prefetch: the next file's read overlaps this scene.
        self._scene_pool = ThreadPoolExecutor(max_workers=1)
        self._scene_futures = {}
        self._scene_name = ""
        self.scene_idx = 0
        self.scan_idx = 0
        self.map_descriptor_cache: Dict[str, tuple] = {}

        self.rot_errors: Dict[str, List[float]] = {}
        self.trans_errors: Dict[str, List[float]] = {}
        self.points_in_map: List[int] = []  # the map's size after each removal
        self.stop_publishing = False
        # Per scene: seconds by stage, the batched row's stats, and the serial
        # correspondence searches (one kernel B1 launch each).
        self.stage_seconds: Dict[str, float] = {}
        self._clock: Optional[float] = None  # set while run_scene times its stages
        self.batched_stats: Optional[Dict] = None
        self.vfm_searches = 0

        def available(pairs):
            """The pairs whose extractor is in the registry (`get_extractor`),
            as the reference's `available()`."""
            out = []
            for m, icp in pairs:
                try:
                    if m != "vfm":
                        get_extractor(m)
                    out.append((m, icp))
                except KeyError:
                    pass
            return out

        self.methods_ransac = available(methods_ransac if methods_ransac is not None else DEFAULT_RANSAC)
        self.methods_teaser = available(methods_teaser if methods_teaser is not None else DEFAULT_TEASER)
        self.methods_pointdsc = available(methods_pointdsc if methods_pointdsc is not None else DEFAULT_POINTDSC)

        # Several devices: the scan-sharded or the map-sharded batched row,
        # and the serial columns' hypothesis-sharded RANSAC (`:263-320`).
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self._rank = dist.get_rank() if world > 1 else 0
        self.mesh = None
        self._map_sharded = False
        self._sharded_ransac = None
        self.config = load_config(None, deskew=False, max_range=None)
        with self._rank0_stdout():
            if world > 1:
                self._map_sharded = map_sharding
                self.mesh = make_mesh(("model",) if map_sharding else ("data",))
                if map_sharding:
                    print(f"Mesh: sharding the MAP over {world} devices (bigger-than-HBM scene mode)")
                else:
                    self._sharded_ransac = sharded_ransac(self.mesh, num_hypotheses=RANSAC_HYPOTHESES)
                    print(f"Mesh: sharding driver stages over {world} devices")
            print("Sigma:", self.config.adaptive_threshold.initial_threshold)
            print("Voxel size:", self.config.mapping.voxel_size)
            print("Max points per voxel:", self.config.mapping.max_points_per_voxel)
            print("=" * 80)

    @contextlib.contextmanager
    def _rank0_stdout(self):
        """Standard output as it is on rank 0, discarded on the other ranks."""
        if self._rank == 0:
            yield
            return
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            yield

    def _tic(self, stage: str) -> None:
        """Add the seconds since the last mark to `stage_seconds[stage]`
        (after a synchronize on the card), while `run_scene` keeps time."""
        if self._clock is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + now - self._clock
        self._clock = now

    # ------------------------------------------------------------ registrations
    def _map_hash(self, local_map: np.ndarray, with_descriptors: bool) -> VoxelHashMap:
        """Voxel hash of the current local map, built once per (map, variant).
        Keyed by object identity: every stage of a scene sees the same map."""
        cached = self._hash_map_cache.get(with_descriptors)
        if cached is not None and cached[0] is local_map and cached[1] == local_map.shape:
            return cached[2]
        m = get_voxel_hash_map(self.config, device=self.device)
        m.add_points(local_map if with_descriptors else np.ascontiguousarray(local_map[:, :3]))
        self._hash_map_cache[with_descriptors] = (local_map, local_map.shape, m)
        return m

    @staticmethod
    def _map_size(voxel_hash_map: VoxelHashMap) -> int:
        """`point_cloud().shape[0]` without reading the points back."""
        return int(voxel_hash_map.device_grid().valid.sum())

    def _double_voxelize(self, pc: np.ndarray) -> np.ndarray:
        """KISS double downsample, 0.5 v then 1.0 v, all columns kept
        (`registration_node.py:289-290`)."""
        vs = self.config.mapping.voxel_size
        return voxel_down_sample(voxel_down_sample(pc, vs * 0.5), vs * 1.0)

    def _voxelize_scan(self, raw_scan: np.ndarray) -> np.ndarray:
        return self._double_voxelize(raw_scan[:, :3])

    def compute_vfm_correspondences(
        self, voxel_map: np.ndarray, raw_scan: np.ndarray, initial_pose: np.ndarray = np.eye(4)
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`compute_vfm_correspondences` (`registration_node.py:396-425`): 5 m
        queries, and 1 m ones below RETRY_BELOW matches."""
        voxel_scan = self._double_voxelize(raw_scan)
        voxel_hash_map = self._map_hash(voxel_map, with_descriptors=True)
        pcl = transform_pcl(voxel_scan, initial_pose)
        print(f"Map size: {self._map_size(voxel_hash_map)}, Scan size: {voxel_scan.shape[0]}")

        correspondences = voxel_hash_map.get_vfm_correspondences(voxel_down_sample(pcl, 5.0), 0.8)
        self.vfm_searches += 1
        if correspondences[0].shape[0] < RETRY_BELOW:
            print("[WARNING] Voxelized too sparse, retrying with a larger voxel size")
            correspondences = voxel_hash_map.get_vfm_correspondences(voxel_down_sample(pcl, 1.0), 0.8)
            self.vfm_searches += 1
        return correspondences

    # Voxel size (m) or keypoint count of each extractor in the scene loop
    # (`registration_node.py:427-546`).
    _EXTRACT_ARG = {"fpfh": 0.1, "dip": 0.1, "gedi": 0.1, "fcgf": 0.3, "gcl": 0.3, "spinnet": 7500}

    def compute_correspondences(
        self, voxel_map: np.ndarray, raw_scan: np.ndarray, method: str, mutual_filter: bool = False,
        stage: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Baseline-descriptor correspondences (`registration_node.py:427-546`):
        the scan's descriptors and the map's (cached per method for the
        scene), then the L2 1-NN scan -> map, mutual or the 5,000 nearest.
        `stage` names the column for `stage_seconds`."""
        if method not in self._EXTRACT_ARG:
            raise ValueError(f"Invalid method: {method}")
        stage = stage or f"{method}_correspondences"
        extractor = get_extractor(method)
        arg = self._EXTRACT_ARG[method]
        down_map, feats_map = self.map_descriptor_cache.get(method, (None, None))
        if down_map is None:
            down_map, feats_map = extractor(voxel_map, arg, device=self.device)
            self.map_descriptor_cache[method] = (down_map, feats_map)
            self._tic(f"{stage}_map_descriptors")
        down_scan, feats_scan = extractor(raw_scan, arg, device=self.device)
        self._tic(f"{stage}_scan_descriptors")

        keep, idx1 = self._descriptor_pairs(feats_scan, feats_map, mutual_filter, 5000)
        self._tic(f"{stage}_match")
        return down_scan[keep], down_map[idx1[keep]]

    def _descriptor_pairs(self, feats_scan, feats_map, mutual_filter: bool, n_points: int):
        """(keep [n0] bool, idx1 [n0]) of `mutual_nn_correspondences` between
        the scan's descriptors [n0, D] and the map's, padded to buckets."""
        f0, m0 = _pad_rows(feats_scan, self.device)
        f1, m1 = _pad_rows(feats_map, self.device)
        mnn = mutual_nn_correspondences(f0, m0, f1, m1, mutual_filter=mutual_filter, n_points=n_points)
        n0 = feats_scan.shape[0]
        return mnn.mask[:n0].cpu().numpy(), mnn.idx1[:n0].cpu().numpy()

    def _refine(self, voxel_scan, voxel_hash_map, guess: np.ndarray) -> np.ndarray:
        """The ICP refine of a RANSAC or TEASER pose at (3 sigma, sigma / 3),
        from the guess with its rotation orthogonalized in place."""
        guess[:3, :3] = orthogonalize(guess[:3, :3])
        sigma = self.config.adaptive_threshold.initial_threshold
        return register_frame(points=voxel_scan, voxel_map=voxel_hash_map, initial_guess=guess,
                              max_correspondance_distance=3 * sigma, kernel=sigma / 3)

    def ransac_registration(
        self, voxel_map: np.ndarray, raw_scan: np.ndarray, method: str, run_icp: bool = False
    ):
        """`ransac_registration` (`registration_node.py:273-357`)."""
        stage = "ransac" if method == "vfm" else f"{method}_ransac"
        if method == "vfm":
            src, tgt = self.compute_vfm_correspondences(voxel_map, raw_scan)
        else:
            src, tgt = self.compute_correspondences(voxel_map[:, :3], raw_scan[:, :3], method, stage=stage)
        print(f"[{method}] Correspondences: {src.shape[0]}")
        self._tic(f"{stage}_match")

        voxel_scan = self._voxelize_scan(raw_scan)
        voxel_hash_map = self._map_hash(voxel_map, with_descriptors=False)
        grid = voxel_hash_map.device_grid()
        print(f"[{method}] Map size: {self._map_size(voxel_hash_map)}, Scan size: {voxel_scan.shape[0]}")

        # Snap the correspondences into the voxelized clouds (`:295-310`),
        # against the map grid's own rows, as the batched row does.
        dev = self.device
        s_pts, s_mask = _pad_rows(src, dev)
        t_pts, _ = _pad_rows(tgt, dev, s_pts.shape[0])
        scan_pts, scan_mask = _pad_rows(voxel_scan, dev)
        snapped_src, snapped_tgt, snap_mask = snap_correspondences(
            s_pts, t_pts, s_mask, scan_pts, scan_mask, grid.points, grid.valid
        )
        print(f"[{method}] Correspondences after filtering: {int(snap_mask.sum())}")
        if self.dump_viz_dir is not None:
            keep = snap_mask.cpu().numpy()
            self._viz_corr = (snapped_src.cpu().numpy()[keep], snapped_tgt.cpu().numpy()[keep])

        if self._sharded_ransac is not None:
            pose_dev, _ = self._sharded_ransac(snapped_src, snapped_tgt, snap_mask, self.scan_idx)
        else:
            generator = torch.Generator(device=dev).manual_seed(self.scan_idx)
            pose_dev = ransac_registration(snapped_src, snapped_tgt, snap_mask, generator,
                                           num_hypotheses=RANSAC_HYPOTHESES).pose
        ransac_pose = pose_dev.cpu().numpy().astype(np.float64)
        self._tic(f"{stage}_solve")
        if run_icp:
            pose = self._refine(voxel_scan, voxel_hash_map, ransac_pose)
            self._tic(f"{stage}_refine")
            return ransac_pose, pose
        return ransac_pose, None

    def teaser_registration(
        self, voxel_map: np.ndarray, raw_scan: np.ndarray, method: str, run_icp: bool = False
    ):
        """`teaser_registration` (`registration_node.py:91-159`): vfm, or
        fpfh with mutual-filtered correspondences."""
        stage = "teaser" if method == "vfm" else f"{method}_teaser"
        if method == "fpfh":
            src, tgt = self.compute_correspondences(voxel_map[:, :3], raw_scan[:, :3], "fpfh",
                                                    mutual_filter=True, stage=stage)
        elif method == "vfm":
            src, tgt = self.compute_vfm_correspondences(voxel_map, raw_scan)
        else:
            raise ValueError(f"Invalid method: {method}")
        print(f"[{method}] Correspondences: {src.shape[0]}")
        self._tic(f"{stage}_match")

        n = bucket_size(max(src.shape[0], 1))
        s_pts, t_pts = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
        s_pts[: src.shape[0]], t_pts[: tgt.shape[0]] = src, tgt
        s_mask = np.arange(n) < src.shape[0]
        res = teaser_registration_exact(s_pts, t_pts, s_mask, noise_bound=TEASER_NOISE_BOUND,
                                        device=self.device)
        teaser_pose = res.pose.cpu().numpy().astype(np.float64)
        self._tic(f"{stage}_solve")
        if run_icp:
            voxel_hash_map = self._map_hash(voxel_map, with_descriptors=False)
            voxel_scan = self._voxelize_scan(raw_scan)
            pose = self._refine(voxel_scan, voxel_hash_map, teaser_pose)
            self._tic(f"{stage}_refine")
            return teaser_pose, pose
        return teaser_pose, None

    def pointsdc_registration(
        self, voxel_map: np.ndarray, raw_scan: np.ndarray, method: str, n_points: int, run_icp: bool = False
    ):
        """`pointsdc_registration` (`registration_node.py:161-271`): FPFH at
        0.3 m, normalized, or FCGF at 0.3 m, for the scan and the map; each
        scan descriptor's L2 nearest map descriptor, the n_points nearest
        kept; PointDSC (`models.pointdsc.get_pointdsc_model`:
        FileNotFoundError without $VFMREG_POINTDSC_WEIGHTS, as the
        reference); the ICP refine."""
        from vfmreg_tpu_torch.models.pointdsc import get_pointdsc_model

        if method not in ("fpfh", "fcgf"):
            raise ValueError(f"Invalid method: {method}")
        stage = f"{method}_pointdsc"
        model = get_pointdsc_model(self.device)
        voxel_hash_map = self._map_hash(voxel_map, with_descriptors=False)
        extractor = get_extractor(method)
        kw = {"normalize": True} if method == "fpfh" else {}
        src_pts, src_features = extractor(raw_scan[:, :3], 0.3, device=self.device, **kw)
        self._tic(f"{stage}_scan_descriptors")
        tgt_pts, tgt_features = extractor(voxel_map[:, :3], 0.3, device=self.device, **kw)
        self._tic(f"{stage}_map_descriptors")

        keep, idx1 = self._descriptor_pairs(src_features, tgt_features, False, n_points)
        src_keypts, tgt_keypts = src_pts[keep], tgt_pts[idx1[keep]]
        print(f"[{method}] Correspondences: {src_keypts.shape[0]}")
        self._tic(f"{stage}_match")

        pointdsc_pose = model.register(src_keypts, tgt_keypts).astype(np.float64)
        self._tic(f"{stage}_solve")
        if run_icp:
            pose = self._refine(self._voxelize_scan(raw_scan), voxel_hash_map, pointdsc_pose)
            self._tic(f"{stage}_refine")
            return pointdsc_pose, pose
        return pointdsc_pose, None

    def icp_registration(
        self,
        voxel_map: np.ndarray,
        raw_scan: np.ndarray,
        initial_pose: Optional[np.ndarray] = None,
        dist: float = 3,
        two_phase: bool = False,
    ) -> np.ndarray:
        """`icp_registration` (`registration_node.py:359-394`); `two_phase`
        replays the batched vanilla row's phase split
        (`kiss.registration.register_frame`)."""
        voxel_scan = self._double_voxelize(raw_scan)
        voxel_hash_map = self._map_hash(voxel_map, with_descriptors=raw_scan.shape[1] > 3)
        print(f"Map size: {self._map_size(voxel_hash_map)}, Scan size: {voxel_scan.shape[0]}")

        sigma = self.config.adaptive_threshold.initial_threshold
        if initial_pose is None:
            initial_pose = np.eye(4)
        if raw_scan.shape[1] == 3:
            return register_frame(
                points=voxel_scan,
                voxel_map=voxel_hash_map,
                initial_guess=initial_pose,
                max_correspondance_distance=dist * sigma,
                kernel=sigma / dist,
                two_phase=two_phase,
            )
        a = time.time()
        pose, src_, tgt_ = register_frame(
            points=voxel_scan,
            voxel_map=voxel_hash_map,
            initial_guess=initial_pose,
            max_correspondance_distance=dist * sigma,
            kernel=sigma / dist,
            src_=np.array([[0, 0, 0]]),
            tgt_=np.array([[0, 0, 0]]),
        )
        print(f"ICP time: {(time.time() - a):.5f}")
        if self.viz is not None:
            self.viz("correspondences", (src_, tgt_))
        return pose

    # ----------------------------------------------------------------- stepping
    def _accumulate_map(self, scene) -> np.ndarray:
        """Map accumulation and 0.25 m voxelization with the split above 1e6
        points (`registration_node.py:556-580`)."""
        voxel_size = 0.25
        parts = []
        for pose, pcl in zip(scene["map_poses"], scene["map_point_clouds"]):
            pcl = pcl[np.sum(pcl[:, 3:], axis=1) > 0]  # drop descriptor-less points
            pcl = voxel_down_sample(pcl, voxel_size).astype(pcl.dtype)
            parts.append(transform_pcl(pcl, pose))
        local_map = np.concatenate(parts, axis=0).astype(np.float32)
        if local_map.shape[0] > 1000000:
            mean_3d = np.mean(local_map[:, :3], axis=0)
            map_a = voxel_down_sample(local_map[local_map[:, 0] > mean_3d[0]], voxel_size)
            map_b = voxel_down_sample(local_map[local_map[:, 0] <= mean_3d[0]], voxel_size)
            local_map = np.concatenate([map_a, map_b], axis=0).astype(np.float32)
        else:
            local_map = voxel_down_sample(local_map, voxel_size).astype(np.float32)
        descriptor_dim = local_map.shape[1] - 3
        local_map = local_map[:, : 3 + min(descriptor_dim, 384)]
        print(f"Map voxelization (0.25m): {local_map.shape[0]}")
        return local_map

    def _gt_fixed_pose(self, pose) -> np.ndarray:
        """The scene's GT pose with the manual RobotCar translation fixes,
        shared by the serial loop and the batched row."""
        pose = np.array(pose, dtype=np.float64)
        if "robotcar" in self._scene_name:
            fix = self._ROBOTCAR_GT_FIX.get(self.scene_idx)
            if fix is not None:
                pose[:3, 3] += np.array(fix, dtype=np.float64)
        return pose

    def _apply_cluster_removal(self, local_map: np.ndarray, rng_cluster_removal) -> np.ndarray:
        """The semantic cluster-removal experiment (`registration_node.py:651-704`):
        the map's PCA colours within 50 of a tree colour, those with >= 3
        such neighbours within a squared 0.5 m, grown by their other
        neighbours within a squared 0.5 m, clustered by HDBSCAN (100, 25);
        then one normal draw per cluster, in label order, keeps the cluster
        when it lies above the normal quantile of `cluster_removal_prob` p
        and removes it otherwise (with probability p). Appends the map's
        new size to `points_in_map`. An empty selection raises ValueError,
        as the reference's does: no tree-coloured point leaves the KD-tree
        k = 0 neighbours to find, no cluster leaves numpy an empty max."""
        import scipy.stats

        if self.dino_generator is None:
            raise ValueError("cluster removal requires a feature_generator (run_pca)")
        local_map_pca = self.dino_generator.run_pca(local_map[:, 3:], n_components=3)
        for remove_class in REMOVE_CLASSES:
            del_idx = []
            for color in remove_class:
                distance = np.linalg.norm(local_map_pca - color, axis=1)
                del_idx.append(np.flatnonzero(distance < 50))
            del_idx = np.concatenate(del_idx)

            knn = KNeighbors()
            knn.fit(local_map[del_idx, :3], del_idx)
            n_neighbors = knn.n_neighbors_in_radius(local_map[del_idx, :3], 10, 0.5)
            del_idx = del_idx[n_neighbors >= 3]
            keep_idx = np.delete(np.arange(local_map.shape[0]), del_idx)
            knn = KNeighbors()
            knn.fit(local_map[keep_idx, :3], keep_idx)
            knn_idx = knn.query(local_map[del_idx, :3], 50, 0.5)
            del_idx = np.concatenate([del_idx, knn_idx])

            a = time.time()
            cluster_labels = hdbscan_labels(local_map[del_idx, :3], min_cluster_size=100, min_samples=25)
            print(
                f"Clustering time: {(time.time() - a):.5f} | Clusters: {cluster_labels.max() + 1} "
                f"| Outliers: {np.sum(cluster_labels == -1)}"
            )
            del_idx = del_idx[cluster_labels != -1]
            cluster_labels = cluster_labels[cluster_labels != -1]

            for label in range(cluster_labels.max() + 1):
                if rng_cluster_removal.standard_normal() > scipy.stats.norm.ppf(self.cluster_removal_prob):
                    del_idx = del_idx[cluster_labels != label]
                    cluster_labels = cluster_labels[cluster_labels != label]
            keep_idx = np.delete(np.arange(local_map.shape[0]), del_idx)
            local_map = local_map[keep_idx]
            self.points_in_map.append(local_map.shape[0])
        print(f"Semantic-filtered map: {local_map.shape[0]}")
        return local_map

    def _apply_cluster_insertion(
        self, local_map: np.ndarray, gt_pose: np.ndarray, rng_cluster_removal
    ) -> np.ndarray:
        """The tree-insertion experiment (`registration_node.py:706-733`):
        int(100 p) clusters drawn (with replacement) from
        `cluster_insertion_dir/*.npy`, each centred, dropped at a random map
        point with the GT pose's rotation, its top at the highest map point
        within 2 m, and appended to the map."""
        cluster_files = sorted(Path(self.cluster_insertion_dir).glob("*.npy"))
        if not cluster_files:
            return local_map
        n_insert = int(self.cluster_removal_prob * 100)
        sampled = rng_cluster_removal.choice(len(cluster_files), n_insert, replace=True)
        new_clusters = []
        for fi in sampled:
            cluster = np.load(cluster_files[int(fi)])
            cluster = cluster[:, : local_map.shape[1]]
            cluster[:, :3] -= np.mean(cluster[:, :3], axis=0)
            cluster_pose = np.asarray(gt_pose).copy()
            idx = rng_cluster_removal.choice(local_map.shape[0], 1)
            cluster_pose[:2, 3] = local_map[idx, :2]
            dist = np.linalg.norm(local_map[:, :2] - cluster_pose[:2, 3].reshape(1, 2), axis=1)
            near = local_map[dist < 2]
            ground_z = np.max(near[:, 2]) if near.shape[0] else 0.0
            cluster[:, :3] = transform_pcl(cluster[:, :3], cluster_pose)
            cluster[:, 2] += ground_z - np.max(cluster[:, 2])
            new_clusters.append(cluster)
        if not new_clusters:
            return local_map
        return np.concatenate([local_map] + new_clusters, axis=0)

    def _kitti_pair(self) -> Tuple[np.ndarray, np.ndarray]:
        """(map, scan) for scan-to-scan on KITTI (`registration_node.py:1315-1328`):
        consecutive velodyne frames of `kitti_dir`, the first drawn by the
        global `np.random.choice` among all but the last 10, each voxelized
        at 0.1 m, xyz only."""
        if self.kitti_dir is None:
            raise ValueError("scan_to_scan='kitti' requires kitti_dir")
        filenames = sorted(Path(self.kitti_dir).glob("*.bin"))
        kitti_i = np.random.choice(len(filenames) - 10)
        local_map = np.fromfile(filenames[kitti_i], dtype=np.float32).reshape(-1, 4)[:, :3]
        point_cloud = np.fromfile(filenames[kitti_i + 1], dtype=np.float32).reshape(-1, 4)[:, :3]
        local_map = voxel_down_sample(local_map, 0.1).astype(np.float32)
        point_cloud = voxel_down_sample(point_cloud, 0.1).astype(point_cloud.dtype)
        print(f"Map {local_map.shape[0]}, Scan {point_cloud.shape[0]}")
        return local_map, point_cloud

    def _nearest_map_cloud(self, scene: Dict, pose: np.ndarray) -> np.ndarray:
        """Scan-to-scan on the scene's own data (`registration_node.py:1339-1346`):
        the map cloud whose pose lies nearest the scan's, in the world frame,
        voxelized at 0.1 m."""
        map_poses = np.array([p[:3, 3] for p in scene["map_poses"]])
        nearest = int(np.linalg.norm(pose[:3, 3] - map_poses, axis=1).argmin())
        local_map = transform_pcl(scene["map_point_clouds"][nearest], scene["map_poses"][nearest])
        return voxel_down_sample(local_map, 0.1).astype(local_map.dtype)

    @staticmethod
    def _noisy_initial_pose(gt_pose: np.ndarray, rng) -> np.ndarray:
        """Scan-to-scan's initial guess (`registration_node.py:1354-1363`):
        the GT pose plus N(0, 10 m) in x, y and N(0, 1 m) in z, and
        N(0, 2 deg), N(0, 2 deg), N(0, 10 deg) on its xyz Euler angles."""
        from scipy.spatial.transform import Rotation as Rot

        t_noise = np.r_[rng.normal(0, 10, 2), rng.normal(0, 1, 1)]
        r_noise = np.r_[rng.normal(0, 2, 2), rng.normal(0, 10, 1)]
        initial_pose = gt_pose.copy()
        euler = Rot.from_matrix(initial_pose[:3, :3]).as_euler("xyz")
        initial_pose[:3, :3] = Rot.from_euler("xyz", euler + np.deg2rad(r_noise)).as_matrix()
        initial_pose[:3, 3] = initial_pose[:3, 3] + t_noise
        return initial_pose

    def _read_scene(self, idx):
        fut = self._scene_futures.pop(idx, None)
        if fut is not None:
            return fut.result()
        return read_scenes(self.filenames[idx])

    def _prefetch_scene(self, idx) -> None:
        if 0 <= idx < len(self.filenames) and idx not in self._scene_futures:
            self._scene_futures[idx] = self._scene_pool.submit(read_scenes, self.filenames[idx])

    def _precompute_scene_batched(self, scene, scene_local_map: np.ndarray) -> Dict:
        """The scene's GT ICP, vfm RANSAC + refine and vanilla rows as the
        batched method row, on the GT-fixed poses and the map's own grid."""
        poses = [self._gt_fixed_pose(p) for p in scene["scene_poses"]]
        grid = None if self._map_sharded else self._map_hash(scene_local_map, with_descriptors=True).device_grid()
        res = precompute_scene_batched(
            {"scene_poses": poses, "scene_point_clouds": scene["scene_point_clouds"]},
            scene_local_map, device=self.device, q5_budget=self._q5_budget, grid=grid,
            viz=self.dump_viz_dir is not None, mesh=self.mesh, map_sharded=self._map_sharded,
        )
        self.batched_stats = res["stats"]
        return res

    def make_step(self) -> None:
        """One scene (`registration_node.py:548-989`): read it, prefetch the
        next, then `run_scene`."""
        if self.scene_idx >= len(self.filenames):
            self.stop_publishing = True
            return
        name = self.filenames[self.scene_idx]
        with self._rank0_stdout():
            print(f"Current scene ID: {self.scene_idx} | {name.name}")
        scene = self._read_scene(self.scene_idx)
        self._prefetch_scene(self.scene_idx + 1)
        self.run_scene(scene, name)

    def run_scene(self, scene: Dict, name=None) -> None:
        """The body of `make_step` on a scene dict in `data.h5io.read_scenes`'
        layout: map accumulation, the method matrix per scan, errors and the
        summary. `name` (the scene file's path) selects the RobotCar GT fixes.
        Seconds by stage land in `stage_seconds` (the serial RANSAC and
        TEASER columns split into match, solve and refine; what is left of
        a column under its own name)."""
        self._scene_name = Path(name).as_posix() if name is not None else ""
        label = Path(name).name if name is not None else f"scene {self.scene_idx}"
        n_scenes = max(len(self.filenames), self.scene_idx + 1)
        self.stage_seconds, self.batched_stats = {}, None
        self._clock = time.perf_counter()
        try:
            with self._rank0_stdout():
                self._run_scene(scene, label, n_scenes)
        finally:
            self._clock = None

    def _run_scene(self, scene: Dict, label: str, n_scenes: int) -> None:
        tic = self._tic
        scene_local_map = self._accumulate_map(scene)
        tic("accumulate_map")

        # The experiments' draws, fresh for every scene (`:1285-1286`).
        rng = np.random.RandomState(seed=42)
        rng_cluster_removal = np.random.RandomState(seed=42)

        # An experiment changes the map or the scan per scan: no batched row.
        precomputed = None
        if (
            self.batch_scans
            and self.scan_to_scan is None
            and self.cluster_removal_prob == 0
            and self.cluster_insertion_dir is None
            and len(scene["scene_poses"]) >= 2
        ):
            precomputed = self._precompute_scene_batched(scene, scene_local_map)
            tic("batched_row")

        for i, (pose, point_cloud) in enumerate(zip(scene["scene_poses"], scene["scene_point_clouds"])):
            results: Dict[str, Optional[np.ndarray]] = {}
            print("=" * 80)
            self.scan_idx = i
            tmp = point_cloud.shape
            point_cloud = voxel_down_sample(point_cloud, 0.1).astype(point_cloud.dtype)
            print(f"Scan voxelization (0.1m): {tmp[0]} -> {point_cloud.shape[0]}")
            tic("scan_voxelize")
            if self.scan_to_scan == "kitti":
                scene_local_map, point_cloud = self._kitti_pair()
                pose = np.eye(4)
                tic("scan_to_scan_map")
            pose = self._gt_fixed_pose(pose)

            # GT pose: noiseless KISS-ICP (`:644-646`).
            print(f'{"--- Ground truth: ICP w/o noise ---":-^80}')
            if precomputed is not None:
                gt_pose = precomputed["gt"][i]
                print(f"Map size: {precomputed['map_size']}, "
                      f"Scan size: {precomputed['scan_sizes'][i]} (batched)")
            else:
                gt_pose = self.icp_registration(scene_local_map, point_cloud[:, :3], pose)
            print(f'{"--- Ground truth: ICP w/o noise ---":-^80}')
            tic("gt_icp")

            local_map = scene_local_map
            if self.scan_to_scan == "data":
                local_map = self._nearest_map_cloud(scene, pose)
                tic("scan_to_scan_map")
            if self.cluster_removal_prob > 0 and self.cluster_insertion_dir is None:
                local_map = self._apply_cluster_removal(local_map, rng_cluster_removal)
                tic("cluster_removal")
            elif self.cluster_insertion_dir is not None and self.cluster_removal_prob > 0:
                local_map = self._apply_cluster_insertion(local_map, gt_pose, rng_cluster_removal)
                tic("cluster_insertion")

            # Scan-to-scan starts from the GT pose plus noise (`:1354-1365`).
            if self.scan_to_scan is not None:
                initial_pose = self._noisy_initial_pose(gt_pose, rng)
            else:
                initial_pose = np.eye(4)
            # All computed poses are relative to this initial guess (`:859-861`).
            point_cloud = transform_pcl(point_cloud, initial_pose)
            # The map's descriptors are cached per scene, and per scan when
            # the map changes per scan (`:1374-1375`).
            if i == 0 or self.scan_to_scan is not None or self.cluster_removal_prob > 0:
                self.map_descriptor_cache = {}

            print(f'{"--- RANSAC ---":-^80}')
            for method, run_icp in self.methods_ransac:
                if self.scan_to_scan == "kitti" and method == "vfm":
                    continue  # KITTI frames carry no descriptors (`:1379-1380`)
                key = f"{method}_ransac"
                if precomputed is not None and method == "vfm":
                    print(f"[vfm] Correspondences: {precomputed['corr_counts'][i]} (batched)")
                    print(f"[vfm] Correspondences after filtering: {precomputed['snap_counts'][i]}")
                    # The serial path orthogonalizes the RANSAC pose in place
                    # when it refines it (`:333-335`).
                    if run_icp:
                        results[key] = precomputed["vfm_ransac_ortho"][i]
                        results[f"{key}_icp"] = precomputed["vfm_ransac_icp"][i]
                    else:
                        results[key] = precomputed["vfm_ransac_raw"][i]
                        results[f"{key}_icp"] = None
                    continue
                results[key], results[f"{key}_icp"] = self.ransac_registration(
                    local_map, point_cloud, method, run_icp
                )
            tic("ransac")
            print(f'{"--- TEASER ---":-^80}')
            for method, run_icp in self.methods_teaser:
                if self.scan_to_scan == "kitti" and method == "vfm":
                    continue
                key = f"{method}_teaser"
                results[key], results[f"{key}_icp"] = self.teaser_registration(
                    local_map, point_cloud, method, run_icp
                )
            tic("teaser")
            if self.methods_pointdsc:
                print(f'{"--- PointDSC ---":-^80}')
                for method, run_icp in self.methods_pointdsc:
                    key = f"{method}_pointdsc"
                    try:
                        results[key], results[f"{key}_icp"] = self.pointsdc_registration(
                            local_map, point_cloud, method, 10000, run_icp
                        )
                    except (ImportError, FileNotFoundError) as e:
                        print(f"[pointdsc:{method}] skipped: {e}")
                tic("pointdsc")
            print(f'{"--- Vanilla ICP ---":-^80}')
            if precomputed is not None:
                results["icp"] = precomputed["icp"][i]
            else:
                results["icp"] = self.icp_registration(local_map, point_cloud[:, :3], dist=7, two_phase=True)
            tic("vanilla_icp")

            # Errors (`:935-954`).
            print("=" * 80)
            print(f"Scene: {self.scene_idx + 1}/{n_scenes} ({label}) | {i + 1}/{len(scene['scene_poses'])}")
            print_msg(gt_pose, "GT pose")
            print_msg(initial_pose, "Initial guess")
            print("-" * 80)
            for k, v in results.items():
                if v is None:
                    continue
                v = v @ initial_pose
                rte, rre = self.compute_errors(gt_pose, v, k)
                print_msg(v, k, color="green" if (rte < 0.3 and rre < 15) else None)
            print("-" * 80)
            print(f"Points in map: {local_map.shape}")
            print("=" * 80)
            tic("errors")
            if self.dump_viz_dir is not None:
                corr = (precomputed["viz_corr"][i] if precomputed is not None and precomputed.get("viz_corr")
                        else self._viz_corr)
                self._viz_initial = initial_pose
                self._dump_scan_viz(i, local_map, point_cloud, gt_pose, results, corr)
                self._viz_corr = None
                tic("dump_viz")

        self.scene_idx += 1
        # The cached maps (host arrays and device grids) are per scene.
        self._hash_map_cache.clear()
        self._print_summary()
        tic("errors")

    def _dump_scan_viz(
        self,
        scan_idx: int,
        local_map: np.ndarray,
        point_cloud: np.ndarray,
        gt_pose: np.ndarray,
        results: dict,
        corr: Optional[Tuple[np.ndarray, np.ndarray]],
    ) -> None:
        """This scan's visualization files under
        `dump_viz_dir/scene_<idx>/` (`registration_node.py:1226-1270`): the
        scene map (with scan 0), the scan at GT, the scan at the flagship
        estimate (the refined vfm row when it ran, else the first row there
        is), and the accepted correspondences as segment pairs."""
        from vfmreg_tpu_torch.pipeline.visualize_scenes import write_ply, write_ply_segments

        if self._rank != 0:
            return
        out = self.dump_viz_dir / f"scene_{self.scene_idx:03d}"
        out.mkdir(parents=True, exist_ok=True)
        if scan_idx == 0:
            write_ply(out / "map.ply", local_map[:, :3], color=(90, 120, 230))
        # `point_cloud` carries the initial guess and gt_pose is a world pose:
        # express it relative to the initial frame, as the method rows are.
        write_ply(
            out / f"scan_{scan_idx:02d}_gt.ply",
            transform_pcl(point_cloud[:, :3], gt_pose @ np.linalg.inv(self._viz_initial)),
            color=(80, 200, 80),
        )
        if results.get("vfm_ransac_icp") is not None:
            key = "vfm_ransac_icp"
        else:
            key = next((k for k, v in results.items() if v is not None), None)
        if key is not None:
            write_ply(
                out / f"scan_{scan_idx:02d}_est_{key}.ply",
                transform_pcl(point_cloud[:, :3], results[key]),
                color=(230, 90, 90),
            )
        if corr is not None and corr[0].shape[0] > 0:
            write_ply_segments(out / f"scan_{scan_idx:02d}_correspondences.ply", corr[0], corr[1])

    # ------------------------------------------------------------------ metrics
    def compute_errors(self, pose, gt_pose, method: str) -> Tuple[float, float]:
        """Geodesic RRE / L2 RTE, accumulated per method
        (`registration_node.py:997-1019`; called as (gt_pose, estimate, name))."""
        R = pose[:3, :3]
        R_gt = gt_pose[:3, :3]
        rot_error = abs(np.arccos(min(max(((R.T @ R_gt).trace() - 1) / 2, -1.0), 1.0)))
        rot_error = float(np.rad2deg(rot_error))
        trans_error = float(np.linalg.norm(pose[:3, 3] - gt_pose[:3, 3]))
        self.rot_errors.setdefault(method, []).append(rot_error)
        self.trans_errors.setdefault(method, []).append(trans_error)
        return trans_error, rot_error

    def compute_success_rate(self, method, translation_threshold, rotation_threshold) -> float:
        return success_rate(
            self.trans_errors[method], self.rot_errors[method],
            translation_threshold, rotation_threshold,
        )

    def _print_summary(self):
        print("=" * 80)
        for method, rot_error in self.rot_errors.items():
            print(
                f"Rotation error ({method:<20}): "
                f"{np.mean(rot_error):.3f} ± {np.std(rot_error):.3f}"
            )
        print("-" * 80)
        for method, trans_error in self.trans_errors.items():
            print(
                f"Translat error ({method:<20}): "
                f"{np.mean(trans_error):.3f} ± {np.std(trans_error):.3f}"
            )
        print("-" * 80)
        header = f"{'':<20}: "
        for t in THRESHOLDS:
            header += f"{t[0]:>3}, {t[1]:<3} | "
        print(header[:-2])
        for method in self.rot_errors.keys():
            row = f"{method:<20}: "
            for t in THRESHOLDS:
                row += f"{100 * self.compute_success_rate(method, *t):>8.2f} | "
            print(row[:-2])
        print("-" * 80)
        if self.points_in_map:
            print(f"Points in map: {np.mean(self.points_in_map)}")
        print("=" * 80)

    def dump_errors(self, error_file: Path):
        """The pickle of `registration_node.py:1092-1100` (rank 0 writes it)."""
        if self._rank != 0:
            return
        error_file = Path(error_file)
        error_file.parent.mkdir(exist_ok=True, parents=True)
        with open(error_file, "wb") as f:
            pickle.dump(
                {
                    "rot": self.rot_errors,
                    "trans": self.trans_errors,
                    "points_in_map": self.points_in_map,
                },
                f,
            )


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The reference's CLI (`registration_node.py:1522-1595`) on a folder of
    `scene_*.h5`, plus `--device`: every scene, the average time per step,
    the errors pickled to FOLDER/errors_<date>/mode.pkl, and with
    `--dump-viz DIR` the per-scan PLY files under DIR.
    `--cluster-removal-sweep` runs the folder once per mode of SWEEP_MODES,
    in that order, with one `ImageFeatureGenerator` (its PCA fit, made on the
    first map, colours every later map) and writes `mode_<NNN>.pkl` each.
    Launched by `torchrun --nproc_per_node N` (WORLD_SIZE > 1), every rank
    joins one process group, NCCL with one card a rank (LOCAL_RANK), or
    gloo with `--device cpu`, and the node runs its multi-device modes."""
    def signal_handler(sig, frame):
        print("Manual termination triggered")
        sys.exit(0)

    parser = argparse.ArgumentParser()
    parser.add_argument("folder", type=str)
    parser.add_argument("--interactive", action="store_true", help="Pauses after each scene.")
    parser.add_argument("--cluster-removal-sweep", action="store_true",
                        help="Run the 0..100%% cluster-removal experiment sweep")
    parser.add_argument("--dump-viz", type=str, default=None, metavar="DIR",
                        help="Write per-scan visualization PLYs (map, scan at GT / estimate, "
                             "correspondence segments) under DIR")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    signal.signal(signal.SIGINT, signal_handler)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if cpu else "nccl")

    datetime_now = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    cluster_removal_probs = SWEEP_MODES if args.cluster_removal_sweep else [(None, 0)]
    # The removal needs a PCA provider; run_pca does not use the model's
    # weights, so the default (random) generator serves.
    feature_generator = None
    if any(prob > 0 for _, prob in cluster_removal_probs):
        from vfmreg_tpu_torch.models import image_features

        feature_generator = image_features.ImageFeatureGenerator("dinov2", device=args.device)

    data_dir = Path(args.folder)
    for mode_name, prob in cluster_removal_probs:
        mode_str = f"_{mode_name}" if mode_name is not None else ""
        node = RegistrationNode(data_dir, args.interactive, prob, None, feature_generator=feature_generator,
                                device=args.device,
                                dump_viz_dir=Path(args.dump_viz) if args.dump_viz else None)
        times = []
        while not node.stop_publishing:
            start = time.time()
            node.make_step()
            times.append(time.time() - start)
            avg = np.mean(times)
            remaining = (len(node.filenames) - node.scene_idx) * avg
            print(
                f"\033[93m Average time per step: {avg:.3f} s | "
                f"Remaining: {remaining // 3600}h {(remaining % 3600) // 60}min \033[0m"
            )
            if args.interactive and not node.stop_publishing:
                input("Press Enter to continue with next scene...\n")
        node.dump_errors(data_dir / f"errors_{datetime_now}" / f"mode{mode_str}.pkl")


if __name__ == "__main__":
    main()
