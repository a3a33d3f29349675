"""Batched driver stages on one device.

Counterpart of the single-device stages of `vfmreg_tpu/parallel/mesh.py`
(`:207-393`): `batched_ransac`, `batched_icp_stats` and
`batched_icp_two_phase`. The reference vmaps each stage over the B scans of
a scene. Here RANSAC runs as one batched pass over all scans (and the snap
filter, the reference's `batched_snap`, is `registration.ransac
.snap_correspondences` itself, which takes the batch axis), and each ICP row
steps all its lanes together on the device
(`registration.icp.register_frames_icp_stats`), each lane taking the
sequence of steps the vmapped loop gives it. The reference's lane
compaction and filler lanes in the two-phase row exist for its fixed-shape
loop only: here the unsettled lanes resume as one smaller batch.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.registration.icp import (
    FAR_FIELD_PHASE1_ITERATIONS,
    MAX_NUM_ITERATIONS,
    BatchedICP,
    register_frames_icp_stats,
)
from vfmreg_tpu_torch.registration.ransac import ransac_batched


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
    guesses [B, 4, 4]) against one shared grid, all lanes in one loop."""
    if max_iterations is None:
        max_iterations = MAX_NUM_ITERATIONS
    return register_frames_icp_stats(grid, points, mask, guesses, max_dist, kernel, max_iterations)


def batched_icp_two_phase(
    grid: HashGrid, points: torch.Tensor, mask: torch.Tensor, guesses, max_dist: float,
    kernel: float, phase1_iters: Optional[int] = None,
) -> BatchedICP:
    """The far-field row in two phases: every lane runs `phase1_iters` GN
    iterations; a lane that settled there is final, and every other lane
    resumes from its phase-1 pose (re-gathering and re-centring there) with
    the rest of the MAX_NUM_ITERATIONS budget, all of them in one batched
    loop. Iterations, rebuilds and the loop counts are the sums over both
    phases."""
    if phase1_iters is None:
        phase1_iters = FAR_FIELD_PHASE1_ITERATIONS
    first = batched_icp_stats(
        grid, points, mask, guesses, max_dist, kernel, phase1_iters
    )
    resume = np.flatnonzero(~first.settled)
    if resume.size == 0:
        return first
    rows = torch.from_numpy(resume)
    dev_rows = rows.to(points.device)
    second = register_frames_icp_stats(
        grid, points[dev_rows], mask[dev_rows], first.poses[rows], max_dist, kernel,
        max_iterations=MAX_NUM_ITERATIONS - phase1_iters,
    )
    poses = first.poses.clone()
    poses[rows] = second.poses
    its, settled, rebuilds = first.iterations.copy(), first.settled.copy(), first.rebuilds.copy()
    its[resume] += second.iterations
    settled[resume] = second.settled
    rebuilds[resume] += second.rebuilds
    loop = collections.Counter(first.loop)
    loop.update(second.loop)
    return BatchedICP(poses, its, settled, rebuilds, loop)
