"""Shape-dispatched `register_frame` with the reference signature.

Counterpart of `vfmreg_tpu/kiss/registration.py:53-189`
(`kiss_icp/registration.py:28-73`):

* [N, 3] -> geometric ICP (`Registration.cpp:145-195`), optionally as the
  far-field two-phase split of the batched vanilla row (`two_phase=True`);
* [N, 3 + D] with D the map's descriptor dim -> VFM-ICP
  (`Registration.cpp:197-382`): the guess-transformed frame voxelized at
  5 m (the full frame below 100 points), cosine matches at 0.8 through
  kernel B1, then `registration.vfm_icp.register_frame_vfm`; with the
  `src_` / `tgt_` sentinels it also returns the surviving correspondences;
* [N, 3 + D] with `force_xd`, or with D not `vfm_descriptor_size` -> the XD
  path (`Registration.cpp:384-422`): the geometric loop with the
  reference's live cosine-weighted champion metric
  (`registration.icp.register_frame_icp_xd`) where the map stores D-dim
  descriptors, and on the coordinates otherwise, as in the reference. The
  odometry (`kiss.kiss_icp.KissICP`) and the ComputeTransform service
  register descriptor clouds this way, never through VFM-ICP;
* an empty map returns the guess (`Registration.cpp:150`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vfmreg_tpu_torch.kiss.mapping import VoxelHashMap
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences
from vfmreg_tpu_torch.ops.voxel import bucket_size
from vfmreg_tpu_torch.registration.icp import (
    FAR_FIELD_PHASE1_ITERATIONS,
    MAX_NUM_ITERATIONS,
    register_frame_icp,
    register_frame_icp_stats,
    register_frame_icp_xd,
)
from vfmreg_tpu_torch.registration.vfm_icp import register_frame_vfm

VFM_SOURCE_VOXEL = 5.0  # Registration.cpp:217
VFM_MIN_SOURCE_POINTS = 100  # Registration.cpp:218
VFM_MIN_COSINE = 0.8  # Registration.cpp:215


def _pad(points: np.ndarray, device: torch.device):
    """Rows zero-padded to `bucket_size`, with their mask, on `device`."""
    n = bucket_size(max(points.shape[0], 1))
    out = torch.zeros((n, points.shape[1]), dtype=torch.float32, device=device)
    out[: points.shape[0]] = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)).to(device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[: points.shape[0]] = True
    return out, mask


def register_frame(
    points: np.ndarray,
    voxel_map: VoxelHashMap,
    initial_guess: np.ndarray,
    max_correspondance_distance: float,
    kernel: float,
    src_: Optional[np.ndarray] = None,
    tgt_: Optional[np.ndarray] = None,
    vfm_descriptor_size: Optional[int] = None,
    force_xd: bool = False,
    two_phase: bool = False,
):
    """The pose [4, 4] f64 of `points` in the map's frame (see the module
    docstring); runs on the map's device."""
    points = np.asarray(points)
    initial_guess = np.asarray(initial_guess, dtype=np.float64)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError("Invalid shape")

    if voxel_map.empty():
        if points.shape[1] > 3 and src_ is not None:
            return initial_guess, src_, tgt_
        return initial_guess

    grid = voxel_map.device_grid()
    dev = voxel_map.device
    descriptor_dim = 0 if grid.feats is None else grid.feats.shape[1]
    D = points.shape[1] - 3
    is_vfm = D == descriptor_dim and D > 0 and not force_xd
    if vfm_descriptor_size is not None:
        is_vfm = is_vfm and D == vfm_descriptor_size

    if not is_vfm:
        xyz, mask = _pad(points[:, :3], dev)
        guess = torch.from_numpy(initial_guess).to(torch.float32)
        if D > 0 and D == descriptor_dim:
            feats, _ = _pad(points[:, 3:], dev)
            pose = register_frame_icp_xd(grid, xyz, feats, mask, guess, max_correspondance_distance, kernel)
        elif two_phase:
            # The batched vanilla row's per-lane phase program
            # (`parallel.mesh.batched_icp_two_phase`): phase 1 with its budget,
            # then, only if the lane did not settle, a resume from the phase-1
            # pose with the rest of the budget.
            first = register_frame_icp_stats(grid, xyz, mask, guess, max_correspondance_distance,
                                             kernel, max_iterations=FAR_FIELD_PHASE1_ITERATIONS)
            pose = first.pose
            if not first.settled:
                pose = register_frame_icp(grid, xyz, mask, pose, max_correspondance_distance, kernel,
                                          max_iterations=MAX_NUM_ITERATIONS - FAR_FIELD_PHASE1_ITERATIONS)
        else:
            pose = register_frame_icp(grid, xyz, mask, guess, max_correspondance_distance, kernel)
        return pose.numpy().astype(np.float64)

    # ---------------------------------------------------------------- VFM path
    xyz = points[:, :3] @ initial_guess[:3, :3].T + initial_guess[:3, 3]
    source_nd = np.c_[xyz.astype(np.float32), points[:, 3:]]
    voxelized = voxel_down_sample(source_nd, VFM_SOURCE_VOXEL)
    if voxelized.shape[0] < VFM_MIN_SOURCE_POINTS:
        voxelized = source_nd  # `Registration.cpp:218-221`
    q, qmask = _pad(voxelized, dev)
    corr = get_vfm_correspondences(grid.points, grid.feats, grid.valid, q[:, :3], q[:, 3:], qmask,
                                   min_cosine_similarity=VFM_MIN_COSINE)
    frame_xyz, frame_mask = _pad(points[:, :3], dev)
    res = register_frame_vfm(grid, frame_xyz, frame_mask, corr, torch.from_numpy(initial_guess),
                             max_correspondance_distance, kernel)
    pose = res.pose.numpy().astype(np.float64)
    if src_ is not None and tgt_ is not None:
        m = res.corr_mask
        return pose, res.src_corr[m].cpu().numpy(), res.tgt_corr[m].cpu().numpy()
    return pose
