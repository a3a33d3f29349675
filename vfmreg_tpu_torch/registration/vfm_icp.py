"""VFM-ICP: descriptor-guided ICP with MAD-filtered correspondences.

Counterpart of `vfmreg_tpu/registration/vfm_icp.py:register_frame_vfm`
(`:62-163`), the reference's VectorNd `RegisterFrame`
(`core/Registration.cpp:197-382`):

Phase 1 iterates a robust GN step on the cosine correspondences, moves the
full source and the correspondence sources, and narrows the set to
|d - median| < 1.5 MAD, until the mean distance changes by less than 0.01.
Phase 2 continues with geometric ICP against the voxel grid
(`registration.icp.geometric_icp_loop`), sharing the iteration budget.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.se3 import exp_se3, inverse_se3, transform_points
from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.ops.matching import VFMCorrespondences, masked_mad
from vfmreg_tpu_torch.registration.icp import (
    ESTIMATION_THRESHOLD,
    MAX_NUM_ITERATIONS,
    _conjugate_translation,
    build_linear_system,
    geometric_icp_loop,
    gn_step,
)

EUCL_DIST_THRESHOLD = 0.01  # Registration.cpp:94
MAD_MULTIPLIER = 1.5  # Registration.cpp:320


class VFMResult(NamedTuple):
    pose: torch.Tensor  # [4, 4] host f32
    src_corr: torch.Tensor  # [N_c, 3] correspondence sources, moved along
    tgt_corr: torch.Tensor  # [N_c, 3]
    corr_mask: torch.Tensor  # [N_c] phase-1 survivors
    vfm_iterations: int  # phase-1 GN iterations
    iterations: int  # all GN iterations (phase 1 + phase 2)


def _masked_mean(d: torch.Tensor, mask: torch.Tensor) -> np.float32:
    n = torch.clamp(mask.sum(), min=1)
    return np.float32((torch.where(mask, d, 0.0).sum() / n).item())


def register_frame_vfm(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    corr: VFMCorrespondences,
    initial_guess: torch.Tensor,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
) -> VFMResult:
    """Run the VFM and geometric ICP loops for one scan, given its
    correspondences (computed from the guess-transformed source).
    Tensors live on the grid's device; `initial_guess` may be anywhere."""
    points = points.to(torch.float32)
    initial_guess = initial_guess.to("cpu", torch.float32)
    source0 = transform_points(points, initial_guess)
    denom = torch.clamp(mask.sum(), min=1)
    center_dev = torch.where(mask[:, None], source0, 0.0).sum(dim=0) / denom
    center = center_dev.cpu()

    tgt_c = corr.target
    prev_mean = _masked_mean(torch.linalg.vector_norm(corr.source - tgt_c, dim=-1), corr.mask)

    # ---------------- Phase 1: VFM loop (`Registration.cpp:253-336`) -------
    T_icp = torch.eye(4, dtype=torch.float32)
    source = source0
    src_c = corr.source.to(torch.float32)
    corr_mask = corr.mask
    it = 0
    done = int(corr.count) == 0
    while it < max_iterations and not done:
        JTJ, JTr, n_corr = build_linear_system(src_c, tgt_c, corr_mask, kernel, center_dev)
        dx, n_corr = gn_step(JTJ, JTr, n_corr)
        est = _conjugate_translation(exp_se3(torch.from_numpy(dx)), center)
        source = transform_points(source, est)
        src_c = transform_points(src_c, est)
        T_icp = est @ T_icp

        d = torch.linalg.vector_norm(src_c - tgt_c, dim=-1)
        mean = _masked_mean(d, corr_mask)
        med, mad = masked_mad(d, corr_mask)
        corr_mask = corr_mask & (torch.abs(d - med) < MAD_MULTIPLIER * mad)

        converged = np.abs(prev_mean - mean) < np.float32(EUCL_DIST_THRESHOLD)
        prev_mean = mean
        it += 1
        done = bool(converged) or n_corr == 0
    T_vfm, src_c_vfm = T_icp, src_c

    # ------------- Phase 2: geometric ICP (`Registration.cpp:347-372`) -----
    s2 = geometric_icp_loop(
        grid, source, mask, T_vfm, center,
        max_correspondence_distance, kernel, max_iterations, ESTIMATION_THRESHOLD, it0=it,
    )
    # The reference moves the returned correspondence sources along with
    # phase 2 (`Registration.cpp:365`).
    src_c_final = transform_points(src_c_vfm, s2.T_icp @ inverse_se3(T_vfm))
    return VFMResult(
        pose=s2.T_icp @ initial_guess,
        src_corr=src_c_final,
        tgt_corr=tgt_c,
        corr_mask=corr_mask,
        vfm_iterations=it,
        iterations=s2.it,
    )
