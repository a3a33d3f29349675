"""Kernel B2: Gauss-Newton steps over the champion cache, all lanes of a row at once.

Counterpart of `vfmreg_tpu/ops/gn_kernel.py`, and of the rest of one GN
iteration of the reference's vmapped `geometric_icp_loop`. Per query:
nearest cached champion (lowest k on ties), the `best < max_d2` gate, the
Geman-McClure weight k^2 / (k + d^2)^2, and 17 moments summed over the
queries:

  0 count | 1 sum w | 2-4 sum w s_c | 5-7 diag sum w s_c s_c^T
  8-10 off-diagonal (xy, xz, yz) | 11-13 sum w r | 14-16 sum w (s_c x r)

with s_c = s - center and r = s - champion. `assemble_gn_system` turns them
into the 6x6 robust normal equations of `registration.icp.build_linear_system`.

`gn_step_lanes` is one GN step of every live lane of an ICP row: the
moments, the solve, the pose update, the stop tests and the move of the
source, with the lanes' state (`GNLanes`) on the tensors' device, so that a
loop can take several steps between two reads of it. A lane is live while
the reference's inner-loop predicate holds (`lanes_live`); a step leaves
every other lane bit for bit as it was.

The CUDA kernels are `csrc/gn_moments.cu`. `gn_moments_plain` and
`gn_step_lanes_plain` are the same functions in plain PyTorch; the latter
gives, lane for lane and bit for bit, what one iteration of the per-lane
loop gives (`gn_moments_plain` -> `assemble_gn_system` -> the reference's
`gn_step` in f32, `registration.icp.gn_solve_lanes` -> `exp_se3` -> the
conjugation by the centre -> `transform_points`, their products written
out in the kernel's order: `geometry.se3.*_lanes`). The wrappers run the plain
versions for CPU tensors only; for CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.se3 import (
    conjugate_translation_lanes,
    exp_se3_lanes,
    matmul_lanes,
    transform_points_lanes,
)
from vfmreg_tpu_torch.ops import _build

NAME = "gn_moments_from_cache"
_NT = 256  # threads per block of the CUDA kernels
_NPART = 17

# Lane state layout, shared with csrc/gn_moments.cu. int32 columns of
# `GNLanes.ints`:
IT, S, DONE, CONF, PHASE, REBUILDS, MAX_IT, STEPPED = range(8)
# f32 columns of `GNLanes.floats`: last |dx|, motion bound since the
# epoch's gather, lever arm r_max, half a voxel.
DXN, MOVED, RMAX, SLACK = range(4)
# Phases: where a lane goes next. A step sets one of them; a champion
# rebuild (`mark_rebuilt`) sets STEP again.
STEP, REBUILD, GATHER, FINISHED = range(4)
# Lane flags of a rebuild round: not rebuilt, rebuilt, rebuilt after a fresh
# slab gather. Kernel B3 rebuilds every lane whose flag is not KEEP.
KEEP, REBUILT, GATHERED = range(3)


def gn_terms_plain(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, source: torch.Tensor,
    center, kernel: float, max_dist: float,
) -> torch.Tensor:
    """[17, N] per-query terms of the moments, in plain PyTorch."""
    kernel = torch.tensor(kernel, dtype=torch.float32, device=cx.device)
    max_d2 = torch.tensor(np.float32(max_dist) ** 2, device=cx.device)
    center = torch.as_tensor(center, dtype=torch.float32, device=cx.device)
    sx, sy, sz = source[:, 0], source[:, 1], source[:, 2]
    dx = cx - sx
    dy = cy - sy
    dz = cz - sz
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    best = torch.amin(d2, dim=0, keepdim=True)
    iota = torch.arange(cx.shape[0], device=cx.device)[:, None]
    ksel = torch.amin(torch.where(d2 == best, iota, 2**30), dim=0, keepdim=True)
    # A NaN query matches no row (its index is 2^30, as in the kernel it
    # never beats +inf); it is rejected below, so any row may stand in.
    ksel = ksel.clamp(max=cx.shape[0] - 1)
    bx, by, bz = (torch.gather(c, 0, ksel)[0] for c in (cx, cy, cz))
    best = best[0]
    return moment_terms(source, torch.stack([bx, by, bz], dim=1), best, best < max_d2, kernel, center)


def moment_terms(source: torch.Tensor, target: torch.Tensor, r2: torch.Tensor, accept: torch.Tensor,
                 kernel: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """[17, N] per-query terms of the moments of the pairs (source [N, 3],
    target [N, 3]) with squared residuals r2 [N], where `accept` holds."""
    sx, sy, sz = source[:, 0], source[:, 1], source[:, 2]
    w = torch.where(accept, (kernel * kernel) / torch.square(kernel + r2), 0.0)
    rx, ry, rz = (torch.where(accept, source[:, c] - target[:, c], 0.0) for c in range(3))
    px, py, pz = (torch.where(accept, s - c, 0.0) for s, c in zip((sx, sy, sz), center))
    return torch.stack([
        accept.to(torch.float32), w,
        w * px, w * py, w * pz,
        w * px * px, w * py * py, w * pz * pz,
        w * px * py, w * px * pz, w * py * pz,
        w * rx, w * ry, w * rz,
        w * (py * rz - pz * ry), w * (pz * rx - px * rz), w * (px * ry - py * rx),
    ])


def gn_moments_plain(cx, cy, cz, source, center, kernel: float, max_dist: float) -> torch.Tensor:
    """[17] moments in plain PyTorch: the per-query terms, one sum each."""
    return gn_terms_plain(cx, cy, cz, source, center, kernel, max_dist).sum(dim=1)


def _device_type(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def gn_moments_from_cache(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, source: torch.Tensor,
    center: Sequence[float], kernel: float, max_dist: float,
) -> torch.Tensor:
    """[17] moment vector (see the module docstring) in one cache pass.

    cx, cy, cz: [K, N] champion coordinates (sentinel 2e19 in dead lanes);
    source: [N, 3] current source positions; center: 3 host floats."""
    k, n = cx.shape
    f32 = torch.float32
    _build.check_args(NAME, [("cx", cx, (k, n), f32), ("cy", cy, (k, n), f32), ("cz", cz, (k, n), f32),
                          ("source", source, (n, 3), f32)], cx.device)
    if n == 0:
        raise ValueError(f"{NAME}: no queries")
    if _device_type(NAME, cx) == "cpu":
        return gn_moments_plain(cx, cy, cz, source, center, kernel, max_dist)

    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn = _build.launcher("gn_moments", "gn_moments_launch", [P] * 5 + [F] * 2 + [I] * 2 + [P] * 3)
    c = torch.tensor([float(v) for v in center], dtype=f32, device=cx.device)
    partials = torch.empty((-(-n // _NT), _NPART), dtype=f32, device=cx.device)
    out = torch.empty(_NPART, dtype=f32, device=cx.device)
    err = fn(
        cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), source.data_ptr(), c.data_ptr(),
        float(kernel), float(np.float32(max_dist) ** 2), k, n,
        partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream(cx.device).cuda_stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out


def assemble_gn_system(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """17 moments -> (JTJ [6, 6], JTr [6], n_corr), on the moments' device."""
    sw = m[1]
    s1 = m[2:5]
    sxx, syy, szz, sxy, sxz, syz = m[5], m[6], m[7], m[8], m[9], m[10]
    zero = torch.zeros_like(sw)
    hat = torch.stack([
        torch.stack([zero, -s1[2], s1[1]]),
        torch.stack([s1[2], zero, -s1[0]]),
        torch.stack([-s1[1], s1[0], zero]),
    ])
    S2 = torch.stack([
        torch.stack([sxx, sxy, sxz]),
        torch.stack([sxy, syy, syz]),
        torch.stack([sxz, syz, szz]),
    ])
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    tr = sxx + syy + szz
    JTJ = torch.cat([
        torch.cat([sw * eye, -hat], dim=1),
        torch.cat([hat, tr * eye - S2], dim=1),
    ])
    return JTJ, m[11:17], m[0].to(torch.int32)


class GNLanes(NamedTuple):
    """State of B lanes of the GN loop, on the device of the lanes' sources.
    Steps (`gn_step_lanes`) and champion rebuilds (`mark_rebuilt`) update it
    in place."""

    ints: torch.Tensor  # [B, 8] int32: IT, S, DONE, CONF, PHASE, REBUILDS, MAX_IT, STEPPED
    floats: torch.Tensor  # [B, 4] f32: DXN, MOVED, RMAX, SLACK
    T: torch.Tensor  # [B, 4, 4] f32 accumulated correction
    est: torch.Tensor  # [B, 4, 4] f32 the lane's last step
    dx: torch.Tensor  # [B, 6] f32 the lane's last increment (zero when gated)
    moments: torch.Tensor  # [B, 17] f32 the lane's last moments
    partials: torch.Tensor  # [B, ceil(N / 256), 17] f32 scratch of the CUDA kernel

    def clone(self) -> "GNLanes":
        return GNLanes(*(t.clone() for t in self))


def new_gn_lanes(T0: torch.Tensor, it0, max_iterations: int, r_max: torch.Tensor, slack: float,
                 n: int) -> GNLanes:
    """Lanes at the start of the loop (phase GATHER, or FINISHED where
    `it0 >= max_iterations`). T0: [B, 4, 4]; it0: an int or a [B] sequence;
    r_max: [B] f32; slack: half a voxel; n: queries per lane. Everything
    lands on r_max's device."""
    dev = r_max.device
    b = r_max.shape[0]
    it0 = np.broadcast_to(np.asarray(it0, dtype=np.int64), (b,))
    ints = np.zeros((b, 8), dtype=np.int32)
    ints[:, IT], ints[:, MAX_IT] = it0, max_iterations
    ints[:, PHASE] = np.where(it0 < max_iterations, GATHER, FINISHED)
    f32 = torch.float32
    floats = torch.stack([
        torch.full((b,), float("inf"), dtype=f32, device=dev), torch.zeros(b, dtype=f32, device=dev),
        r_max.to(f32), torch.full((b,), float(np.float32(slack)), dtype=f32, device=dev),
    ], dim=1)
    return GNLanes(
        ints=torch.from_numpy(ints).to(dev), floats=floats,
        T=torch.empty((b, 4, 4), dtype=f32, device=dev).copy_(T0),
        est=torch.eye(4, dtype=f32, device=dev).repeat(b, 1, 1),
        dx=torch.zeros((b, 6), dtype=f32, device=dev),
        moments=torch.zeros((b, _NPART), dtype=f32, device=dev),
        partials=torch.empty((b, -(-n // _NT), _NPART), dtype=f32, device=dev),
    )


def mark_rebuilt(st: GNLanes, flags: torch.Tensor) -> None:
    """Mark the lanes whose flag ([B] int32, on the state's device) is not
    KEEP rebuilt, in place: rebuild count + 1, inner step 0, phase STEP,
    and where the flag is GATHERED the motion bound 0."""
    hit = flags != KEEP
    st.ints[:, REBUILDS] += hit
    st.ints[:, S].masked_fill_(hit, 0)
    st.ints[:, PHASE].masked_fill_(hit, STEP)
    st.floats[:, MOVED].masked_fill_(flags == GATHERED, 0.0)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def lanes_live(st: GNLanes, threshold: float, refresh_interval: int) -> torch.Tensor:
    """[B] bool: the reference's inner-loop predicate (`inner_live`,
    `vfmreg_tpu/registration/icp.py:294-304`), on a lane inside a champion
    epoch (phase STEP)."""
    I, F = st.ints, st.floats
    thr = _f32(threshold).to(F.device)
    return ((I[:, PHASE] == STEP) & (I[:, S] < refresh_interval) & (I[:, IT] < I[:, MAX_IT])
            & (I[:, DONE] == 0) & (I[:, CONF] == 0) & (F[:, MOVED] < F[:, SLACK])
            & ((I[:, S] == 0) | (F[:, DXN] >= thr)))


def _cholesky_solve6_lanes(A, b):
    """The reference's unrolled `_cholesky_solve6`
    (`vfmreg_tpu/registration/icp.py:111`) on [B] lanes at once, operation
    for operation: A is a 6 x 6 nested list of [B] tensors (its lower
    triangle is read), b a list of 6; every sum starts from 0 and adds in
    ascending order."""
    zero = torch.zeros_like(b[0])
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        acc = zero
        for k in range(j):
            acc = acc + L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(A[j][j] - acc)
        for i in range(j + 1, 6):
            acc = zero
            for k in range(j):
                acc = acc + L[i][k] * L[j][k]
            L[i][j] = (A[i][j] - acc) / L[j][j]
    y = [None] * 6
    for i in range(6):
        acc = zero
        for k in range(i):
            acc = acc + L[i][k] * y[k]
        y[i] = (b[i] - acc) / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        acc = zero
        for k in range(i + 1, 6):
            acc = acc + L[k][i] * x[k]
        x[i] = (y[i] - acc) / L[i][i]
    return torch.stack(x, dim=1)


def _sq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, in ascending order, as numpy's f32
    sum of a short vector takes it."""
    acc = v[:, 0] * v[:, 0]
    for i in range(1, v.shape[1]):
        acc = acc + v[:, i] * v[:, i]
    return acc


def gn_finish_lanes_plain(m: torch.Tensor, st: GNLanes, center: torch.Tensor, live: torch.Tensor,
                          threshold: float, refresh_interval: int) -> None:
    """The lanes' step from their moments m [B, 17], in place, for the lanes
    in `live` (`lanes_live` before the step): the system of
    `assemble_gn_system` with `registration.icp.gn_solve_lanes`'s 1e-8
    floor, the unrolled Cholesky, the `n > 0 and finite` gate, the pose
    update and the stop flags. Leaves the sources alone
    (`gn_step_lanes_plain` moves them)."""
    sw, s1x, s1y, s1z = m[:, 1], m[:, 2], m[:, 3], m[:, 4]
    sxx, syy, szz, sxy, sxz, syz = (m[:, j] for j in range(5, 11))
    tr = sxx + syy + szz
    zero = torch.zeros_like(sw)
    fl = _f32(1e-8).to(m.device)

    def off(x):  # gn_solve_lanes adds the floor's zero off the diagonal
        return x + zero

    # assemble_gn_system's JTJ (`sw * eye`, `hat`, `tr * eye - S2`), lower triangle.
    A = [[None] * 6 for _ in range(6)]
    A[0][0], A[1][1], A[2][2] = (sw * 1.0 + fl for _ in range(3))
    A[1][0] = A[2][0] = A[2][1] = off(sw * 0.0)
    A[3][0], A[3][1], A[3][2] = off(zero), off(-s1z), off(s1y)
    A[4][0], A[4][1], A[4][2] = off(s1z), off(zero), off(-s1x)
    A[5][0], A[5][1], A[5][2] = off(-s1y), off(s1x), off(zero)
    A[3][3], A[4][4], A[5][5] = (tr * 1.0 - d + fl for d in (sxx, syy, szz))
    A[4][3], A[5][3], A[5][4] = (off(tr * 0.0 - o) for o in (sxy, sxz, syz))
    x = _cholesky_solve6_lanes(A, [-m[:, 11 + i] for i in range(6)])
    n_corr = m[:, 0].to(torch.int32)
    ok = (n_corr > 0) & torch.isfinite(x).all(dim=1)
    dx = torch.where(ok[:, None], x, 0.0)

    I, F = st.ints, st.floats
    thr = _f32(threshold).to(m.device)
    dxn = torch.sqrt(_sq_sum(dx))
    moved = F[:, MOVED] + torch.sqrt(_sq_sum(dx[:, :3])) + torch.sqrt(_sq_sum(dx[:, 3:])) * F[:, RMAX]
    conf = (I[:, S] == 0) & (dxn < thr)
    done = n_corr == 0
    it, s = I[:, IT] + 1, I[:, S] + 1
    more = (it < I[:, MAX_IT]) & ~done & ~conf
    inner = more & (s < refresh_interval) & (moved < F[:, SLACK]) & (dxn >= thr)
    phase = torch.where(inner, STEP, torch.where(~more, FINISHED,
                                                 torch.where(moved < F[:, SLACK], REBUILD, GATHER)))
    new_ints = torch.stack([c.to(torch.int32) for c in (
        it, s, done, conf, phase, I[:, REBUILDS], I[:, MAX_IT], I[:, STEPPED])], dim=1)
    new_floats = torch.stack([dxn, moved, F[:, RMAX], F[:, SLACK]], dim=1)
    st.ints.copy_(torch.where(live[:, None], new_ints, I))
    st.ints[:, STEPPED] = live.to(torch.int32)
    st.floats.copy_(torch.where(live[:, None], new_floats, F))
    st.moments.copy_(torch.where(live[:, None], m, st.moments))
    st.dx.copy_(torch.where(live[:, None], dx, st.dx))
    # The pose update with its products written out in B2's order
    # (`se3.*_lanes`): a library 3 x 3 product rounds otherwise. Every lane
    # is computed and the live ones kept, so that no step waits on a read.
    est = conjugate_translation_lanes(exp_se3_lanes(st.dx), center)
    keep = live[:, None, None]
    st.T.copy_(torch.where(keep, matmul_lanes(est, st.T), st.T))
    st.est.copy_(torch.where(keep, est, st.est))


def gn_step_lanes_plain(cx, cy, cz, source, center, kernel: float, max_dist: float,
                        threshold: float, refresh_interval: int, st: GNLanes) -> None:
    """`gn_step_lanes` in plain PyTorch (see the module docstring)."""
    live = lanes_live(st, threshold, refresh_interval)
    lanes = torch.nonzero(live).flatten().tolist()
    m = st.moments.clone()
    for j in lanes:
        m[j] = gn_moments_plain(cx[j], cy[j], cz[j], source[j], center[j], kernel, max_dist)
    gn_finish_lanes_plain(m, st, center, live, threshold, refresh_interval)
    source.copy_(torch.where(live[:, None, None], transform_points_lanes(source, st.est), source))


def gn_step_lanes(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, source: torch.Tensor,
    center: torch.Tensor, kernel: float, max_dist: float, threshold: float,
    refresh_interval: int, st: GNLanes,
) -> None:
    """One GN step of every live lane, in place (see the module docstring).

    cx, cy, cz: [B, K, N] champion planes (sentinel 2e19 in dead rows);
    source: [B, N, 3] current sources, moved in place; center: [B, 3] the
    lanes' GN centres; st: the lanes' state. One launch of the CUDA kernels
    for all lanes, whatever their state; frozen lanes do nothing there."""
    b, k, n = cx.shape
    f32, i32 = torch.float32, torch.int32
    npart = -(-n // _NT)
    _build.check_args(NAME, [
        ("cx", cx, (b, k, n), f32), ("cy", cy, (b, k, n), f32), ("cz", cz, (b, k, n), f32),
        ("source", source, (b, n, 3), f32), ("center", center, (b, 3), f32),
        ("ints", st.ints, (b, 8), i32), ("floats", st.floats, (b, 4), f32),
        ("T", st.T, (b, 4, 4), f32), ("est", st.est, (b, 4, 4), f32), ("dx", st.dx, (b, 6), f32),
        ("moments", st.moments, (b, _NPART), f32), ("partials", st.partials, (b, npart, _NPART), f32),
    ], cx.device)
    if n == 0:
        raise ValueError(f"{NAME}: no queries")
    if _device_type(NAME, cx) == "cpu":
        gn_step_lanes_plain(cx, cy, cz, source, center, kernel, max_dist, threshold,
                            refresh_interval, st)
        return

    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn = _build.launcher("gn_moments", "gn_step_lanes_launch",
                         [P] * 5 + [F] * 3 + [I] * 4 + [P] * 8)
    err = fn(
        cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), source.data_ptr(), center.data_ptr(),
        float(kernel), float(np.float32(max_dist) ** 2), float(np.float32(threshold)),
        refresh_interval, k, n, b,
        st.ints.data_ptr(), st.floats.data_ptr(), st.T.data_ptr(), st.est.data_ptr(),
        st.dx.data_ptr(), st.moments.data_ptr(), st.partials.data_ptr(),
        torch.cuda.current_stream(cx.device).cuda_stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
