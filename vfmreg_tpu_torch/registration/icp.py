"""Point-to-point Gauss-Newton ICP against the voxel hash grid.

Counterpart of the scan-to-map parts of `vfmreg_tpu/registration/icp.py`:
`build_linear_system` (`:83`), the unrolled `_cholesky_solve6` (`:111`),
`gn_step` (`:141`), `_conjugate_translation` (`:151`),
`geometric_icp_loop` (`:159`) with the reference's "planes" champion
rebuild on every path (kernel B3), and the entry point `register_frame_icp_stats` (`:478`, through
`_register_frame_icp_state`, `:396`; the reference's `register_frame_icp`,
`:443`, is its `.pose`).

Split between host and device: the point clouds, candidate slabs and
champion caches live on the device; the 6-dof solve, the pose and the stop
tests run on the host in float32. Every GN iteration needs one device-to-host
read anyway (the loop decides on the host whether to go on), and the
unrolled 6x6 Cholesky is ~100 scalar operations that would otherwise be as
many kernel launches. The solve is the reference's f32 arithmetic in the
reference's order, so the |dx| < 1e-4 tests see the same numbers.

Per champion rebuild on the device: kernel B3 (`ops/champion_kernel.py`).
Per GN iteration: kernel B2 (`ops/gn_kernel.py`) gives the 17 moments, `assemble_gn_system` the 6x6 system, and the source is moved by the
step. The reference runs B lanes under `vmap` with masked carries; here each
lane runs on its own with host-side stop tests, which gives each lane the
result of the vmapped run.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.se3 import exp_se3, hat_so3, transform_points
from vfmreg_tpu_torch.ops.champion_kernel import champions_from_planes
from vfmreg_tpu_torch.ops.gn_kernel import assemble_gn_system, gn_moments_from_cache
from vfmreg_tpu_torch.ops.hash_grid import HashGrid, gather_candidate_slabs

MAX_NUM_ITERATIONS = 1000  # Registration.cpp:92
ESTIMATION_THRESHOLD = 1e-4  # Registration.cpp:93
# GN budget of the first phase of the drivers' two-phase far-field (vanilla
# ICP) rows: a lane that has not settled by then resumes from its phase-1
# pose with the rest of MAX_NUM_ITERATIONS (`parallel/mesh.py`).
FAR_FIELD_PHASE1_ITERATIONS = 256
# Champion caches are rebuilt from the epoch's gathered slabs at least every
# REFRESH_INTERVAL GN iterations (see the reference for the rationale).
REFRESH_INTERVAL = 16

_f32 = np.float32
_Z = np.float32(0.0)  # f32 start value of the unrolled sums


def build_linear_system(source, target, weight_mask, kernel, center):
    """Masked robust normal equations centred at `center`:
    (JTJ [6,6], JTr [6], n_corr) with J_i = [I | -hat(s_i - c)] and the
    Geman-McClure weight k^2 / (k + |r|^2)^2."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=source.device)
    s_c = source - center
    residual = source - target
    r2 = torch.sum(residual * residual, dim=-1)
    w = (kernel * kernel) / torch.square(kernel + r2)
    w = torch.where(weight_mask, w, 0.0)
    n = source.shape[0]
    J = torch.zeros((n, 3, 6), dtype=source.dtype, device=source.device)
    J[:, :, :3] = torch.eye(3, dtype=source.dtype, device=source.device)
    J[:, :, 3:] = -hat_so3(s_c)
    JTJ = torch.einsum("nij,n,nik->jk", J, w, J)
    JTr = torch.einsum("nij,n,ni->j", J, w, residual)
    return JTJ, JTr, weight_mask.sum()


def _cholesky_solve6(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unrolled 6x6 SPD Cholesky solve in float32, in the reference's order
    of operations (a library Cholesky rounds differently, and the iteration
    counts hinge on |dx| < 1e-4)."""
    A = [[_f32(v) for v in r] for r in A]
    b = [_f32(v) for v in b]
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j][j] - sum((L[j][k] * L[j][k] for k in range(j)), _Z)
        L[j][j] = np.sqrt(d)
        for i in range(j + 1, n):
            s = A[i][j] - sum((L[i][k] * L[j][k] for k in range(j)), _Z)
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        y[i] = (b[i] - sum((L[i][k] * y[k] for k in range(i)), _Z)) / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), _Z)) / L[i][i]
    return np.array(x, dtype=np.float32)


def gn_step(JTJ: torch.Tensor, JTr: torch.Tensor, n_corr: torch.Tensor) -> Tuple[np.ndarray, int]:
    """Solve JTJ dx = -JTr on the host: (dx, n_corr), with dx zero when the
    system is empty or singular. One device-to-host read brings the system
    and the count. A 1e-8 Tikhonov floor keeps the f32 solve finite."""
    host = torch.cat(
        [JTJ.reshape(-1), JTr.reshape(-1), n_corr.reshape(1).to(JTJ.dtype)]
    ).cpu().numpy()
    n = int(host[42])
    A = host[:36].reshape(6, 6) + _f32(1e-8) * np.eye(6, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        dx = _cholesky_solve6(A, -host[36:42])
    if n > 0 and np.all(np.isfinite(dx)):
        return dx, n
    return np.zeros(6, dtype=np.float32), n


def _conjugate_translation(T: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """T(center) @ T @ T(-center) without building the translations."""
    out = T.clone()
    out[:3, 3] = T[:3, 3] + center - T[:3, :3] @ center
    return out


def _norm(v: np.ndarray) -> np.float32:
    return np.sqrt(np.sum(v * v, dtype=np.float32), dtype=np.float32)


def champion_group(grid: HashGrid, cands) -> int:
    """Kernel B3's candidate lanes per voxel: the per-voxel cap rounded up
    to a multiple of 8, which trims the slab's sentinel lanes (20 -> 24 of 32)."""
    return min(-(-grid.max_points_per_voxel // 8) * 8, 32 * cands.slabs.shape[2])


class ICPState(NamedTuple):
    source: torch.Tensor  # [N, 3] device, current world-frame source
    T_icp: torch.Tensor  # [4, 4] host f32, accumulated correction
    it: int  # GN iterations so far (including `it0`)
    done: bool  # stopped on an empty correspondence set
    confirmed: bool  # converged on a freshly rebuilt champion cache
    rebuilds: int  # champion-cache rebuilds (kernel B3 launches)


def geometric_icp_loop(
    grid: HashGrid,
    source0: torch.Tensor,
    mask: torch.Tensor,
    T_icp0: torch.Tensor,
    center: torch.Tensor,
    max_dist: float,
    kernel: float,
    max_iterations: int,
    estimation_threshold: float,
    it0: int,
    refresh_interval: int = REFRESH_INTERVAL,
) -> ICPState:
    """The reference's three nested loops with their three rules:

    * one 27-voxel slab gather per motion epoch; the epoch ends once the
      accumulated motion bound (|dt| + |omega| * r_max) reaches half a voxel;
    * the champion cache is rebuilt from the epoch's slabs at least every
      `refresh_interval` GN iterations;
    * |dx| < threshold ends the loop only on the first iteration after a
      rebuild (fresh-confirmed); a sub-threshold step on a stale cache
      triggers a rebuild and a fresh check instead.

    Each slab gather is transposed once (`Candidates.planes`) and each
    rebuild is one launch of kernel B3, which gives `build_nn_cache`'s
    champions bit for bit (the reference's rebuild_mode="planes"; its
    "slabs" mode is not ported, and `build_nn_cache` stays as the
    reference the kernel is held against).

    `center` is a host f32 [3] tensor; `T_icp0` a host f32 [4, 4]."""
    d2c = torch.sum(torch.square(source0 - center.to(source0.device)), dim=-1)
    r_max = _f32(torch.sqrt(torch.amax(torch.where(mask, d2c, 0.0))).item())
    slack = _f32(0.5) * _f32(grid.voxel_size)
    thr = _f32(estimation_threshold)
    center_l = center.tolist()

    source, T_icp, it = source0, T_icp0, int(it0)
    dx_norm = _f32(np.inf)
    done = confirmed = False
    rebuilds = 0
    while it < max_iterations and not done and not confirmed:
        cands = gather_candidate_slabs(grid, source, mask)
        group = champion_group(grid, cands)
        planes = cands.planes(group)
        moved_g = _f32(0.0)
        while it < max_iterations and not done and not confirmed and moved_g < slack:
            cx, cy, cz = champions_from_planes(*planes, source, mask, group)
            rebuilds += 1
            s = 0
            while (
                s < refresh_interval and it < max_iterations and not done
                and not confirmed and moved_g < slack and (s == 0 or dx_norm >= thr)
            ):
                m = gn_moments_from_cache(cx, cy, cz, source, center_l, kernel, max_dist)
                JTJ, JTr, n_corr = assemble_gn_system(m)
                dx, n_corr = gn_step(JTJ, JTr, n_corr)
                est = _conjugate_translation(exp_se3(torch.from_numpy(dx)), center)
                source = transform_points(source, est)
                T_icp = est @ T_icp
                dx_norm = _norm(dx)
                confirmed = s == 0 and dx_norm < thr
                moved_g = moved_g + _norm(dx[:3]) + _norm(dx[3:]) * r_max
                done = n_corr == 0
                it += 1
                s += 1
    return ICPState(source, T_icp, it, done, confirmed, rebuilds)


class ICPStats(NamedTuple):
    pose: torch.Tensor  # [4, 4] host f32: T_icp @ initial_guess
    iterations: int  # GN iterations
    settled: bool  # stopped on its own (confirmed or no correspondences), not on the budget
    rebuilds: int  # champion-cache rebuilds


def register_frame_icp_stats(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    initial_guess,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
) -> ICPStats:
    """KISS-ICP `RegisterFrame` for 3D points (`Registration.cpp:145-195`)
    from `initial_guess` [4, 4], with its iteration count, whether it settled
    and its champion rebuilds. The GN solve is centred on the mean of the
    guess-transformed source. A run resumed from the returned pose continues
    the same trajectory up to that re-centring."""
    points = points.to(torch.float32)
    guess = torch.as_tensor(initial_guess).to("cpu", torch.float32)
    source0 = transform_points(points, guess)
    denom = torch.clamp(mask.sum(), min=1)
    center = (torch.where(mask[:, None], source0, 0.0).sum(dim=0) / denom).cpu()
    final = geometric_icp_loop(
        grid, source0, mask, torch.eye(4, dtype=torch.float32), center,
        max_correspondence_distance, kernel, max_iterations, ESTIMATION_THRESHOLD,
        it0=0,
    )
    return ICPStats(final.T_icp @ guess, final.it, final.done or final.confirmed, final.rebuilds)

