"""VFM-ICP: descriptor-guided ICP with MAD-filtered correspondences.

Counterpart of `vfmreg_tpu/registration/vfm_icp.py:register_frame_vfm`
(`:62-163`), the reference's VectorNd `RegisterFrame`
(`core/Registration.cpp:197-382`), and of its `vmap` over a batch of scans
(`bench.py:117-127`, `parallel/mesh.py:581`):

Phase 1 iterates a robust GN step on the cosine correspondences, moves the
full source and the correspondence sources, and narrows the set to
|d - median| < 1.5 MAD, until the mean distance changes by less than 0.01.
Phase 2 continues with geometric ICP against the voxel grid
(`registration.icp.geometric_icp_loop_lanes`), sharing the iteration budget.

`register_frames_vfm_lanes` runs B scans as lanes, as the vmapped
`while_loop` does: phase 1's state lives on the grid's device, one step
moves every lane (a finished lane is kept by `torch.where` and its count
does not advance), and the host reads the lanes' done flags once every
`VFM_STEPS_PER_READ` steps. Phase 2 is one lane loop over the batch.
`register_frame_vfm` is the B = 1 call.

A lane's sums are taken over its own rows (`build_linear_system` and the
masked mean, lane by lane) and its products are written out
(`geometry.se3.*_lanes`), so each lane gives what its own B = 1 call gives.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.se3 import (
    conjugate_translation_lanes,
    exp_se3_lanes,
    inverse_se3,
    matmul_lanes,
    transform_points_lanes,
)
from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.ops.matching import VFMCorrespondences, _sq3, masked_mad
from vfmreg_tpu_torch.registration.icp import (
    ESTIMATION_THRESHOLD,
    MAX_NUM_ITERATIONS,
    build_linear_system,
    geometric_icp_loop_lanes,
    gn_solve_lanes,
)
from vfmreg_tpu_torch.utils.profiling import span

EUCL_DIST_THRESHOLD = 0.01  # Registration.cpp:94
MAD_MULTIPLIER = 1.5  # Registration.cpp:320
# Phase-1 steps between two reads of the lanes' done flags: a lane that
# converges waits frozen for the read, and a frozen step costs what a live
# one does. 2 is the slice's phase-1 iteration count; on the H100, 1 and 2
# took the same time, and 4 and 8 paid for 2 and 6 frozen steps
# (`profile_slice.py --path vfm`, PERF.md §6).
VFM_STEPS_PER_READ = 2


class VFMResult(NamedTuple):
    pose: torch.Tensor  # [4, 4] host f32
    src_corr: torch.Tensor  # [N_c, 3] correspondence sources, moved along
    tgt_corr: torch.Tensor  # [N_c, 3]
    corr_mask: torch.Tensor  # [N_c] phase-1 survivors
    vfm_iterations: int  # phase-1 GN iterations
    iterations: int  # all GN iterations (phase 1 + phase 2)
    rebuilds: int  # phase 2's champion-cache rebuilds
    loop: collections.Counter  # `VFMLanes.loop`


class VFMLanes(NamedTuple):
    poses: torch.Tensor  # [B, 4, 4] host f32
    src_corr: torch.Tensor  # [B, N_c, 3] correspondence sources, moved along
    tgt_corr: torch.Tensor  # [B, N_c, 3]
    corr_mask: torch.Tensor  # [B, N_c] phase-1 survivors
    vfm_iterations: np.ndarray  # [B] phase-1 GN iterations
    iterations: np.ndarray  # [B] all GN iterations (phase 1 + phase 2)
    rebuilds: np.ndarray  # [B] phase 2's champion-cache rebuilds
    # Phase 2's loop counts (`registration.icp.ICPLanes.loop`) with phase 1's
    # vfm_steps (steps of all lanes) and vfm_reads (of the done flags).
    loop: collections.Counter


def _masked_means(d: torch.Tensor, mask: torch.Tensor, lanes) -> torch.Tensor:
    """[B] mean of d [B, N_c] over each lane's mask, summed lane by lane
    over the `lanes` listed (0 elsewhere)."""
    sums = [torch.where(mask[j], d[j], 0.0).sum() if j in lanes else d.new_zeros(())
            for j in range(d.shape[0])]
    return torch.stack(sums) / torch.clamp(mask.sum(dim=-1), min=1)


def register_frames_vfm_lanes(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    corr: VFMCorrespondences,
    initial_guess: torch.Tensor,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
    merge_cache=None,
) -> VFMLanes:
    """Run the VFM and geometric ICP loops for B scans (points [B, N, 3],
    mask [B, N]) given their correspondences (corr with [B, N_c] leading
    axes, computed from the guess-transformed sources) and initial guesses
    [B, 4, 4] (anywhere). Tensors live on the grid's device. `merge_cache`
    goes to phase 2's loop (map-sharded registration,
    `registration.icp.geometric_icp_loop_lanes`); phase 1 reads no map.

    The call is the span `vfm_icp`: `vfm_icp.phase1` (the lanes' set-up and
    the VFM loop to its last read of the lanes' state), then
    `vfm_icp.phase2` (the geometric loop and the poses composed after it)."""
    with span("vfm_icp"):
        with span("vfm_icp.phase1"):
            dev = points.device
            f32 = torch.float32
            b = points.shape[0]
            points = points.to(f32)
            guesses = torch.as_tensor(initial_guess).to("cpu", f32)
            source = transform_points_lanes(points, guesses.to(dev))
            center = torch.stack([torch.where(mask[j][:, None], source[j], 0.0).sum(dim=0)
                                  for j in range(b)])
            center = center / torch.clamp(mask.sum(dim=1), min=1)[:, None]
            k = torch.full((), kernel, dtype=f32, device=dev)
            everyone = range(b)

            tgt_c = corr.target
            src_c = corr.source.to(f32)
            corr_mask = corr.mask
            prev_mean = _masked_means(torch.sqrt(_sq3(src_c - tgt_c)), corr_mask, everyone)

            # ---------------- Phase 1: VFM loop (`Registration.cpp:253-336`) ---
            T = torch.eye(4, dtype=f32, device=dev).repeat(b, 1, 1)
            it = torch.zeros(b, dtype=torch.int32, device=dev)
            done = corr.count == 0
            lanes = everyone  # the lanes live at the last read
            loop = collections.Counter(vfm_steps=0, vfm_reads=0)
            while True:
                for _ in range(VFM_STEPS_PER_READ):
                    live = ~done & (it < max_iterations)
                    systems = [build_linear_system(src_c[j], tgt_c[j], corr_mask[j], k, center[j]) if j in lanes
                               else (src_c.new_zeros((6, 6)), src_c.new_zeros(6),
                                     corr_mask.new_zeros((), dtype=torch.int64))
                               for j in everyone]
                    JTJ, JTr, n_corr = (torch.stack(c) for c in zip(*systems))
                    est = conjugate_translation_lanes(exp_se3_lanes(gn_solve_lanes(JTJ, JTr, n_corr)), center)
                    src_c_new = transform_points_lanes(src_c, est)
                    d = torch.sqrt(_sq3(src_c_new - tgt_c))
                    mean = _masked_means(d, corr_mask, lanes)
                    med, mad = masked_mad(d, corr_mask)
                    mask_new = corr_mask & (torch.abs(d - med[:, None]) < MAD_MULTIPLIER * mad[:, None])
                    stop = (torch.abs(prev_mean - mean) < EUCL_DIST_THRESHOLD) | (n_corr == 0)

                    source = torch.where(live[:, None, None], transform_points_lanes(source, est), source)
                    src_c = torch.where(live[:, None, None], src_c_new, src_c)
                    T = torch.where(live[:, None, None], matmul_lanes(est, T), T)
                    corr_mask = torch.where(live[:, None], mask_new, corr_mask)
                    prev_mean = torch.where(live, mean, prev_mean)
                    done = torch.where(live, stop, done)
                    it = it + live.to(torch.int32)
                loop["vfm_steps"] += VFM_STEPS_PER_READ
                state = torch.cat([T.reshape(b, 16), it.to(f32)[:, None],
                                   (~done & (it < max_iterations)).to(f32)[:, None]], dim=1).cpu()
                loop["vfm_reads"] += 1
                lanes = np.flatnonzero(state[:, 17].numpy()).tolist()
                if not lanes:
                    break
            T_vfm = state[:, :16].reshape(b, 4, 4)
            it_vfm = state[:, 16].numpy().astype(np.int64)

        # ------------- Phase 2: geometric ICP (`Registration.cpp:347-372`) -------
        with span("vfm_icp.phase2"):
            s2 = geometric_icp_loop_lanes(
                grid, source, mask, T, center, max_correspondence_distance, kernel, max_iterations,
                ESTIMATION_THRESHOLD, it0=it_vfm, merge_cache=merge_cache,
            )
            loop.update(s2.loop)
            # The reference moves the returned correspondence sources along with
            # phase 2 (`Registration.cpp:365`).
            motion = torch.stack([s2.T_icp[j] @ inverse_se3(T_vfm[j]) for j in everyone])
            return VFMLanes(
                poses=torch.stack([s2.T_icp[j] @ guesses[j] for j in everyone]),
                src_corr=transform_points_lanes(src_c, motion),
                tgt_corr=tgt_c,
                corr_mask=corr_mask,
                vfm_iterations=it_vfm,
                iterations=s2.it,
                rebuilds=s2.rebuilds,
                loop=loop,
            )


def register_frame_vfm(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    corr: VFMCorrespondences,
    initial_guess: torch.Tensor,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
    merge_cache=None,
) -> VFMResult:
    """`register_frames_vfm_lanes` for one scan: points [N, 3], mask [N],
    corr with [N_c] leading axes, initial_guess [4, 4]."""
    r = register_frames_vfm_lanes(
        grid, points[None], mask[None], VFMCorrespondences(*(f[None] for f in corr)),
        torch.as_tensor(initial_guess)[None], max_correspondence_distance, kernel, max_iterations,
        merge_cache,
    )
    return VFMResult(r.poses[0], r.src_corr[0], r.tgt_corr[0], r.corr_mask[0], int(r.vfm_iterations[0]),
                     int(r.iterations[0]), int(r.rebuilds[0]), r.loop)
