"""Plain reference of the `vfm-scan-to-map` configuration.

Per scan, from the identity: the first point of every occupied 5 m voxel
(input order), the first `n_vfm` of them as queries, each paired with the
map point of the highest descriptor cosine and kept at a cosine of at least
`MIN_COSINE`; VFM-ICP on those pairs, then geometric ICP against the 1 m
voxel map (`plain.vfm_icp`). The configuration's file gives what the
program takes (`n_vfm`, `max_iterations`); the method's other settings,
which the program fixes itself, are the constants below.

`answers` gives what the entry returns for each distinct batch; `judge`
holds every call's output of the window against them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import plain

MAP_VOXEL_M = 1.0  # the map's voxel map, KISS-ICP's default at a 100 m max range
MAX_POINTS_PER_VOXEL = 20  # MappingConfig.max_points_per_voxel
VFM_VOXEL_M = 5.0  # Registration.cpp:217
MIN_COSINE = 0.8  # the matching's acceptance
MAX_CORRESPONDENCE_M = 6.0  # 3 sigma at sigma = 2 m
KERNEL = 0.667  # sigma / 3
ESTIMATION_THRESHOLD = 1e-4  # Registration.cpp:93
VFM_MEAN_TOLERANCE_M = 0.01  # Registration.cpp:94
VFM_MAD_MULTIPLIER = 1.5  # Registration.cpp:320


def prepare(data, cfg: Dict) -> Dict:
    """The map grid of the inputs, worked out again from the map."""
    return {"grid": plain.build_map(data.map_points, data.map_feats, MAP_VOXEL_M, MAX_POINTS_PER_VOXEL),
            "data": data, "cfg": cfg}


def answers(state: Dict, tf32: bool = False, batches: Optional[List[int]] = None) -> List[Optional[Dict]]:
    """[{"poses": [B, 4, 4] f64, "n_corr": [B]}] for each distinct batch
    (None for those left out of `batches`, when given)."""
    grid, data, cfg = state["grid"], state["data"], state["cfg"]
    eye = torch.eye(4, dtype=torch.float32, device=data.map_points.device)
    out = []
    for k, batch in enumerate(data.batches):
        if batches is not None and k not in batches:
            out.append(None)
            continue
        scans, feats = batch["scans"], batch["feats"]
        queries = [plain.first_per_voxel(s, VFM_VOXEL_M)[:cfg["n_vfm"]] for s in scans]
        sim, arg = plain.cosine_match(torch.cat([f[q] for f, q in zip(feats, queries)]), grid.feats, tf32)
        poses, n_corr, a = [], [], 0
        for s, q in zip(scans, queries):
            ok = sim[a:a + q.numel()] >= MIN_COSINE
            tgt = grid.points[arg[a:a + q.numel()]]
            a += q.numel()
            poses.append(plain.vfm_icp(grid, s, s[q][ok], tgt[ok], eye, MAX_CORRESPONDENCE_M, KERNEL,
                                       cfg["max_iterations"], ESTIMATION_THRESHOLD, VFM_MEAN_TOLERANCE_M,
                                       VFM_MAD_MULTIPLIER, tf32))
            n_corr.append(int(ok.sum()))
        out.append({"poses": np.stack(poses), "n_corr": np.array(n_corr)})
    return out


def judge(state: Dict, outputs: List[Dict], reference: List[Dict]) -> Dict[str, float]:
    """The compared numbers over every call of the window: `outputs[i]` is
    call i's {"batch": k, "poses", "n_corr"}, `reference[k]` batch k's answers."""
    dt = dr = count = 0.0
    for out in outputs:
        ref = reference[out["batch"]]
        count = max(count, float(np.abs(np.asarray(out["n_corr"]) - ref["n_corr"]).max()))
        for p, r in zip(out["poses"], ref["poses"]):
            g = plain.pose_gap(p, r)
            dt, dr = max(dt, g[0]), max(dr, g[1])
    return {"corr_count_diff": count, "pose_dt_m": dt, "pose_dr_deg": dr}
