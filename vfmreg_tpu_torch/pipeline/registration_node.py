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
the host where the lanes go between steps. Every stage ends with a
synchronize on the card, so the stage times in `stats["seconds"]` are what
each stage took.

Run as a script to register a small synthetic scene and print the recall
table:

    python -m vfmreg_tpu_torch.pipeline.registration_node [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.config import INITIAL_THRESHOLD, MAX_POINTS_PER_VOXEL, VOXEL_SIZE
from vfmreg_tpu_torch.geometry.metrics import compute_errors, success_rate
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.matching import VFMCorrespondences, get_vfm_correspondences_batched
from vfmreg_tpu_torch.ops.voxel import bucket_size, voxel_down_sample_masked
from vfmreg_tpu_torch.parallel.mesh import (
    batched_icp_stats,
    batched_icp_two_phase,
    batched_ransac,
)
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene
from vfmreg_tpu_torch.registration.ransac import snap_correspondences
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

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
    """`VoxelHashMap.device_grid()` of a map [M, 3 + D] (numpy or tensor):
    zero-padded to `bucket_size(M)` rows and built with the per-voxel cap."""
    lm = torch.as_tensor(local_map, dtype=torch.float32).to(dev)
    m0, cols = lm.shape
    cap = bucket_size(max(m0, 1))
    pts = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    feats = torch.zeros((cap, max(cols - 3, 1)), dtype=torch.float32, device=dev)
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    pts[:m0] = lm[:, :3]
    feats[:m0, : cols - 3] = lm[:, 3:]
    mask[:m0] = True
    return build_hash_grid(pts, voxel_size, mask=mask, feats=feats,
                           max_points_per_voxel=MAX_POINTS_PER_VOXEL)


def precompute_scene_batched(
    scene: Dict,
    local_map,
    device=None,
    q5_budget: int = 2048,
) -> Dict:
    """The method row of one scene (see the module docstring).

    `scene` holds "scene_poses" (B GT poses, 4x4) and "scene_point_clouds"
    (B scans [n, 3 + D] in their own frames), or, in place of the clouds,
    "scene_point_clouds_device": (raw [B, N, 3 + D], mask [B, N]) already
    stacked. `local_map` is [M, 3 + D]. Runs on `device` (default: the card).

    Returns the reference's keys: "gt", "vfm_ransac_raw",
    "vfm_ransac_ortho", "vfm_ransac_icp", "icp" ([B, 4, 4] f64),
    "corr_counts", "snap_counts", "map_size", "scan_sizes", "retried",
    "viz_corr" (None), and "stats": per-stage seconds and, per ICP row, GN
    iterations, settled flags and champion rebuilds per lane, and the row
    loop's counts (`registration.icp.ICPLanes.loop`: kernel B2 step calls,
    device reads, kernel B3 launches, lanes rebuilt and gathered)."""
    full_precision()
    dev = resolve_device(device)
    sigma, voxel_size = INITIAL_THRESHOLD, VOXEL_SIZE

    seconds: Dict[str, float] = {}
    clock = [time.perf_counter()]

    def tic(label):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[label] = seconds.get(label, 0.0) + now - clock[0]
        clock[0] = now

    poses = np.stack([np.asarray(p, dtype=np.float64) for p in scene["scene_poses"]])
    b = poses.shape[0]

    grid = build_map_grid(local_map, voxel_size, dev)
    tic("grid_build")

    resident = scene.get("scene_point_clouds_device")
    if resident is not None:
        raw, raw_mask = (t.to(dev) for t in resident)
    else:
        raw_np, mask_np = stack_scans(scene["scene_point_clouds"], local_map.shape[1])
        raw, raw_mask = torch.from_numpy(raw_np).to(dev), torch.from_numpy(mask_np).to(dev)
    p3, f3, m3, counts3_dev, q5x, q5f, q5m, q5_total = _preprocess_scans_device(
        raw, raw_mask, voxel_size, q_budget=q5_budget
    )
    tic("preprocess")

    def match(qx, qf, qm) -> VFMCorrespondences:
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
    tic("match")

    # Accepted correspondences to the front (stable, so RANSAC's own
    # compaction sees the same sequence), cut to the smallest bucket.
    Wc = bucket_size(max(max(corr_counts), 1))
    if Wc < c_mask.shape[1]:
        order = torch.sort((~c_mask).to(torch.int32), dim=1, stable=True).indices[:, :Wc]
        c_src = torch.gather(c_src, 1, order[..., None].expand(-1, -1, 3))
        c_tgt = torch.gather(c_tgt, 1, order[..., None].expand(-1, -1, 3))
        c_mask = torch.gather(c_mask, 1, order)
    snap_src, snap_tgt, snap_mask = snap_correspondences(
        c_src, c_tgt, c_mask, s_xyz, s_mask, grid.points, grid.valid
    )
    tic("snap")

    # Sync 2: the RANSAC poses, orthogonalized on the host in f64.
    ransac_dev = batched_ransac(snap_src, snap_tgt, snap_mask, seeds=range(b),
                                num_hypotheses=RANSAC_HYPOTHESES)
    ransac_raw = ransac_dev.cpu().numpy().astype(np.float64)
    ransac_ortho = ransac_raw.copy()
    for j in range(b):
        ransac_ortho[j, :3, :3] = orthogonalize(ransac_raw[j, :3, :3])
    tic("ransac")

    # GT ICP and the refine row: two separate rows at (3 sigma, sigma / 3).
    gt = batched_icp_stats(grid, s_xyz, s_mask, poses, 3 * sigma, sigma / 3)
    refined = batched_icp_stats(grid, s_xyz, s_mask, ransac_ortho, 3 * sigma, sigma / 3)
    tic("gt_refine_icp")
    eye_b = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    vanilla = batched_icp_two_phase(grid, s_xyz, s_mask, eye_b, 7 * sigma, sigma / 7)
    tic("vanilla_icp")

    # Sync 3: every remaining device result in one read.
    final = torch.cat([snap_mask.sum(dim=1), grid.valid.sum()[None]]).cpu().numpy()
    tic("final_read")
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
        "viz_corr": None,
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scene, local_map, _ = make_synthetic_scene(3, 32768, 2048, 24, seed=0)
    res = precompute_scene_batched(scene, local_map, device=dev)
    print(f"corr_counts: {res['corr_counts']}  snap_counts: {res['snap_counts']}  "
          f"retried: {res['retried']}  GN iterations: {res['stats']['iterations']}")
    print(format_recall_table(recall_table(method_errors(res))))


if __name__ == "__main__":
    main()
