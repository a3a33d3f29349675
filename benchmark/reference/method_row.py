"""Plain reference of the `eval-method-row` configuration: the evaluation
driver's method row for one scene.

Per scan: first-point voxel downsampling at each of `PREPROCESS_VOXELS_M`
in turn (input order kept); the first point of every occupied 5 m voxel as
the queries (the program matches a scan with more such voxels than its
query budget again at full width, so every voxel counts), each paired with
the map point of the highest descriptor cosine and kept at `MIN_COSINE`; a
scan with fewer than `RETRY_BELOW` pairs matched again with every
downsampled point; the pairs whose two ends lie within `SNAP_TOLERANCE_M`
of a point of the downsampled scan and of the map; RANSAC on those (3
picks a hypothesis, the least mean squared residual over all pairs);
point-to-point ICP from the stored GT pose and from the RANSAC pose at (3
sigma, sigma / 3), and the vanilla ICP row from the identity at (7 sigma,
sigma / 7) in two phases: a scan that has not settled after
`FAR_FIELD_PHASE1_ITERATIONS` starts again from there with the rest of the
budget.

How each output is judged (`judge`):

* counts (correspondences, retried scans, snapped pairs): against the
  reference's. The snap may differ by a pair: the program finds a pair's
  nearest point through the -2ab expansion, whose rounding can prefer a
  point a few millimetres from the pair's own and drop it.
* the GT and refine ICP rows: their gap to the reference's pose.
* RANSAC: the mean squared residual of the program's pose over the
  reference's snapped pairs, against the least among the reference's
  hypotheses, as the median over the scans. Its picks are random and it
  scores in f32, whose rounding of the residual (~1e-4 m^2 at these
  extents, a tenth of the noise floor) picks among near-tied hypotheses:
  one scan's excess reads up to a few tenths in sound runs, their median a
  few hundredths, and a budget cut to a few hypotheses moves every scan.
* the vanilla row: the gap to the reference's pose, as the median over the
  scans. The far field starts tens of metres off and settles in one of
  several local minima: the reference parts from itself by up to decimetres
  on about a tenth of the scans when it runs in f64 or on its points in
  another order, and the program parts from it alike, so no limit on one
  scan's gap holds both sound runs and a fault; the median holds the scans
  that settle alike to rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import plain

# The evaluation driver's settings, which the program fixes itself.
VOXEL_M = 1.0  # KISS-ICP's MappingConfig.voxel_size at a 100 m max range
MAX_POINTS_PER_VOXEL = 20  # MappingConfig.max_points_per_voxel
PREPROCESS_VOXELS_M = (0.1, 0.5, 1.0)  # registration_node.py: 0.1 m, then the KISS double voxelization
QUERY_VOXEL_M = 5.0  # Registration.cpp:217
MIN_COSINE = 0.8  # the matching's acceptance
RETRY_BELOW = 75  # registration_node.py: a scan below this many pairs is matched again at 1 m
SNAP_TOLERANCE_M = 1e-3  # registration_node.py:301
RANSAC_HYPOTHESES = 50000  # registration_node.py:319-327
INITIAL_THRESHOLD_M = 2.0  # AdaptiveThresholdConfig.initial_threshold (sigma)
MAX_ITERATIONS = 1000  # Registration.cpp:92
ESTIMATION_THRESHOLD = 1e-4  # Registration.cpp:93
FAR_FIELD_PHASE1_ITERATIONS = 256  # the vanilla row's first phase


def prepare(data, cfg: Dict) -> Dict:
    lm = data.local_map
    return {"grid": plain.build_map(lm[:, :3].contiguous(), lm[:, 3:].contiguous(), VOXEL_M, MAX_POINTS_PER_VOXEL),
            "data": data, "cfg": cfg}


def _downsample(points: torch.Tensor, feats: torch.Tensor, sizes) -> tuple:
    for size in sizes:
        keep = plain.first_per_voxel(points, size)
        points, feats = points[keep], feats[keep]
    return points, feats


def scans(state: Dict, batch: Dict) -> List[tuple]:
    """Each scan's downsampled (points, feats), cached on the batch."""
    if "_plain_scans" not in batch:
        out = []
        for raw, mask in zip(batch["raw"], batch["mask"]):
            pts = raw[mask]
            out.append(_downsample(pts[:, :3].contiguous(), pts[:, 3:].contiguous(), PREPROCESS_VOXELS_M))
        batch["_plain_scans"] = out
    return batch["_plain_scans"]


FAR = (7 * INITIAL_THRESHOLD_M, INITIAL_THRESHOLD_M / 7)
NEAR = (3 * INITIAL_THRESHOLD_M, INITIAL_THRESHOLD_M / 3)


def vanilla(state: Dict, p3: torch.Tensor, tf32: bool = False) -> np.ndarray:
    """The vanilla row's pose of one downsampled scan, from the identity."""
    eye = torch.eye(4, dtype=torch.float32, device=p3.device)
    res = plain.icp(state["grid"], p3, eye, *FAR, FAR_FIELD_PHASE1_ITERATIONS, ESTIMATION_THRESHOLD, tf32)
    if not res.settled:
        guess = torch.as_tensor(res.pose, dtype=torch.float32, device=p3.device)
        res = plain.icp(state["grid"], p3, guess, *FAR, MAX_ITERATIONS - FAR_FIELD_PHASE1_ITERATIONS,
                        ESTIMATION_THRESHOLD, tf32)
    return res.pose


def answers(state: Dict, tf32: bool = False, batches: Optional[List[int]] = None) -> List[Optional[Dict]]:
    """Per distinct batch: "corr_counts", "snap_counts", "retried", "gt",
    "vfm_ransac_ortho", "vfm_ransac_icp", "icp" ([B, 4, 4] f64), and per
    scan the snapped pairs ("pairs": (src, tgt) [n, 3] f64, unrounded) and
    the mean squared residual over them of the RANSAC pose, the least among
    the hypotheses ("ransac_mse"); None for the batches left out of `batches`, when given."""
    grid, data = state["grid"], state["data"]
    dev = data.local_map.device
    poses = ("gt", "vfm_ransac_ortho", "vfm_ransac_icp", "icp")
    out = []
    for k, batch in enumerate(data.batches):
        if batches is not None and k not in batches:
            out.append(None)
            continue
        res = {n: [] for n in ("corr_counts", "snap_counts", "retried", "pairs", "ransac_mse") + poses}
        for j, (p3, f3) in enumerate(scans(state, batch)):
            q = plain.first_per_voxel(p3, QUERY_VOXEL_M)
            sim, arg = plain.cosine_match(f3[q], grid.feats, tf32)
            ok = sim >= MIN_COSINE
            src, tgt = p3[q][ok], grid.points[arg][ok]
            if int(ok.sum()) < RETRY_BELOW:
                res["retried"].append(j)
                sim, arg = plain.cosine_match(f3, grid.feats, tf32)
                ok = sim >= MIN_COSINE
                src, tgt = p3[ok], grid.points[arg][ok]
            res["corr_counts"].append(int(ok.sum()))
            snap = (plain.nearest_direct(src, p3) < SNAP_TOLERANCE_M) & \
                (plain.nearest_in_map(grid, tgt).double() < SNAP_TOLERANCE_M)
            res["snap_counts"].append(int(snap.sum()))
            rng = np.random.default_rng([int(data.seed) % 2**63, k, j])
            s_np, t_np = src[snap].double().cpu().numpy(), tgt[snap].double().cpu().numpy()
            res["pairs"].append((s_np, t_np))
            if tf32:
                s_np = plain.round_tf32(src[snap].float()).double().cpu().numpy()
                t_np = plain.round_tf32(tgt[snap].float()).double().cpu().numpy()
            ransac_pose = plain.ransac(s_np, t_np, RANSAC_HYPOTHESES, rng)
            res["vfm_ransac_ortho"].append(ransac_pose)
            res["ransac_mse"].append(plain.pair_mse(ransac_pose, *res["pairs"][-1]))
            gt_guess = torch.as_tensor(batch["gt_poses"][j], dtype=torch.float32, device=dev)
            rs_guess = torch.as_tensor(ransac_pose, dtype=torch.float32, device=dev)
            near = (*NEAR, MAX_ITERATIONS, ESTIMATION_THRESHOLD, tf32)
            res["gt"].append(plain.icp(grid, p3, gt_guess, *near).pose)
            res["vfm_ransac_icp"].append(plain.icp(grid, p3, rs_guess, *near).pose)
            res["icp"].append(vanilla(state, p3, tf32))
        out.append({k_: (np.stack(v) if k_ in poses else v if k_ == "pairs" else np.array(v))
                    for k_, v in res.items()})
    return out


def _ransac_excess(pose: np.ndarray, pairs: tuple, least: float) -> float:
    """The pose's mean squared residual over the pairs, over `least`, less 1."""
    return plain.pair_mse(pose, *pairs) / least - 1.0 if least > 0 else 0.0


def gaps(state: Dict, outputs: List[Dict], reference: List[Dict]) -> List[Dict]:
    """Per call and scan, what `judge` summarizes: each ICP row's (m, deg)
    gap, the RANSAC excess and the snap's count difference."""
    rows = (("gt", "gt"), ("refine", "vfm_ransac_icp"), ("vanilla", "icp"))
    out = []
    for o in outputs:
        k, ref = o["batch"], reference[o["batch"]]
        for j in range(len(o["gt"])):
            d = {"batch": k, "scan": j, **{row: plain.pose_gap(o[key][j], ref[key][j]) for row, key in rows}}
            d["ransac_excess"] = _ransac_excess(o["vfm_ransac_ortho"][j], ref["pairs"][j], ref["ransac_mse"][j])
            d["snap_diff"] = int(o["snap_counts"][j]) - int(ref["snap_counts"][j])
            out.append(d)
    return out


def judge(state: Dict, outputs: List[Dict], reference: List[Dict]) -> Dict[str, float]:
    """The compared numbers over every call of the window: `outputs[i]` is
    call i's row result with its "batch" index, `reference[k]` batch k's
    answers. Each number is the largest over the calls and scans, but for
    the medians over the scans (each distinct scan once, at its worst)."""
    n = {"corr_count_diff": 0.0, "retry_diff": 0.0, "snap_count_diff": 0.0}
    for out in outputs:
        ref = reference[out["batch"]]
        n["corr_count_diff"] = max(n["corr_count_diff"],
                                   float(np.abs(np.asarray(out["corr_counts"]) - ref["corr_counts"]).max()))
        n["retry_diff"] = max(n["retry_diff"], float(len(set(out["retried"]) ^ set(ref["retried"].tolist()))))
    for row in ("gt", "refine"):
        n[f"{row}_dt_m"] = n[f"{row}_dr_deg"] = 0.0
    per_scan: Dict[tuple, Dict] = {}
    for d in gaps(state, outputs, reference):
        n["snap_count_diff"] = max(n["snap_count_diff"], float(abs(d["snap_diff"])))
        for row in ("gt", "refine"):
            n[f"{row}_dt_m"] = max(n[f"{row}_dt_m"], d[row][0])
            n[f"{row}_dr_deg"] = max(n[f"{row}_dr_deg"], d[row][1])
        worst = per_scan.setdefault((d["batch"], d["scan"]), d)
        if (d["vanilla"], d["ransac_excess"]) > (worst["vanilla"], worst["ransac_excess"]):
            per_scan[(d["batch"], d["scan"])] = d
    scans_ = list(per_scan.values())
    n["vanilla_median_dt_m"], n["vanilla_median_dr_deg"] = (
        float(v) for v in np.median(np.array([d["vanilla"] for d in scans_]), axis=0)) if scans_ else (0.0, 0.0)
    n["ransac_excess_median"] = float(np.median([d["ransac_excess"] for d in scans_])) if scans_ else 0.0
    return n
