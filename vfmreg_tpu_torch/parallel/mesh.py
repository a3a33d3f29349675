"""Batched driver stages on one device.

Counterpart of the single-device stages of `vfmreg_tpu/parallel/mesh.py`
(`:207-393`): `batched_ransac`, `batched_icp_stats` and
`batched_icp_two_phase`. The reference vmaps each stage over the B scans of
a scene. Here RANSAC runs as one batched pass over all scans (and the snap
filter, the reference's `batched_snap`, is `registration.ransac
.snap_correspondences` itself, which takes the batch axis), and the ICP
rows run their lanes one after
another: each lane's GN loop decides on the host whether to go on, so a
lane's result is the one the vmapped loop gives it, and no lane waits for
another. The reference's lane compaction and filler lanes in the two-phase
row exist for the vmapped loop only; the per-lane sequence is what is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.registration.icp import (
    FAR_FIELD_PHASE1_ITERATIONS,
    MAX_NUM_ITERATIONS,
    register_frame_icp_stats,
)
from vfmreg_tpu_torch.registration.ransac import ransac_batched


class BatchedICP(NamedTuple):
    poses: torch.Tensor  # [B, 4, 4] host f32
    iterations: np.ndarray  # [B] GN iterations per lane
    settled: np.ndarray  # [B] stopped on its own, not on the budget
    rebuilds: np.ndarray  # [B] champion-cache rebuilds per lane


def batched_ransac(
    src: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor, seeds: Sequence[int],
    num_hypotheses: int = 50000, picks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RANSAC poses [B, 4, 4] (on the device) for B scans, all hypotheses of
    all scans scored in one pass. Scan j draws its picks from a generator on
    the device seeded with `seeds[j]`, as the reference seeds `PRNGKey(j)`."""
    generators = None
    if picks is None:
        generators = [torch.Generator(device=src.device).manual_seed(int(s)) for s in seeds]
    return ransac_batched(src, tgt, mask, generators, num_hypotheses, picks=picks).pose


def batched_icp_stats(
    grid: HashGrid, points: torch.Tensor, mask: torch.Tensor, guesses, max_dist: float,
    kernel: float, max_iterations: Optional[int] = None,
) -> BatchedICP:
    """`register_frame_icp_stats` for each of B lanes (points [B, N, 3],
    guesses [B, 4, 4]) against one shared grid."""
    if max_iterations is None:
        max_iterations = MAX_NUM_ITERATIONS
    guesses = torch.as_tensor(guesses).to("cpu", torch.float32)
    lanes = [
        register_frame_icp_stats(
            grid, points[j], mask[j], guesses[j], max_dist, kernel,
            max_iterations=max_iterations,
        )
        for j in range(points.shape[0])
    ]
    return BatchedICP(
        torch.stack([s.pose for s in lanes]),
        np.array([s.iterations for s in lanes], dtype=np.int64),
        np.array([s.settled for s in lanes], dtype=bool),
        np.array([s.rebuilds for s in lanes], dtype=np.int64),
    )


def batched_icp_two_phase(
    grid: HashGrid, points: torch.Tensor, mask: torch.Tensor, guesses, max_dist: float,
    kernel: float, phase1_iters: Optional[int] = None,
) -> BatchedICP:
    """The far-field row in two phases: every lane runs `phase1_iters` GN
    iterations; a lane that settled there is final, and every other lane
    resumes from its phase-1 pose (re-gathering and re-centring there) with
    the rest of the MAX_NUM_ITERATIONS budget. Iterations and rebuilds are
    the sums over both phases."""
    if phase1_iters is None:
        phase1_iters = FAR_FIELD_PHASE1_ITERATIONS
    first = batched_icp_stats(
        grid, points, mask, guesses, max_dist, kernel, phase1_iters
    )
    poses = first.poses.clone()
    its, settled, rebuilds = first.iterations.copy(), first.settled.copy(), first.rebuilds.copy()
    for j in np.flatnonzero(~first.settled):
        s = register_frame_icp_stats(
            grid, points[j], mask[j], first.poses[j], max_dist, kernel,
            max_iterations=MAX_NUM_ITERATIONS - phase1_iters,
        )
        poses[j] = s.pose
        its[j] += s.iterations
        settled[j] = s.settled
        rebuilds[j] += s.rebuilds
    return BatchedICP(poses, its, settled, rebuilds)
