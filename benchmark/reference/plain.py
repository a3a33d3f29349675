"""Plain building blocks of the benchmark's reference: voxels, the map grid,
descriptor matching, point-to-point ICP, VFM-ICP's first phase and RANSAC.

Written from the method's definition (KISS-ICP's `RegisterFrame`, the
VectorNd `RegisterFrame` of VFM-Registration, Open3D's correspondence
RANSAC) in plain PyTorch and NumPy. Nothing here imports the program: what
the program derives from the inputs (its grid, its queries, its champion
caches) is worked out again.

Every product of two operands goes through `mm`. With `tf32=True` both
operands are rounded to TF32 (10 mantissa bits, round to nearest even)
before an f32 product: the control that the comparison must reject.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KEY_BIAS = 1 << 20  # voxel coordinates packed into one int64 key, 21 bits an axis


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties to even."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """a @ b in f32 (TF32 off), or on TF32-rounded operands."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def transform(points: torch.Tensor, T: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """points [N, 3] moved by the rigid transform T [4, 4] (same dtype)."""
    return mm(points, T[:3, :3].T.contiguous(), tf32) + T[:3, 3]


# ---------------------------------------------------------------- voxels

def voxel_coords(points: torch.Tensor, size: float) -> torch.Tensor:
    """trunc(p / size) per axis (the voxel at 0 spans (-size, size)), int64."""
    s = torch.tensor(size, dtype=points.dtype, device=points.device)
    return torch.trunc(points / s).to(torch.int64)


def voxel_key(coords: torch.Tensor) -> torch.Tensor:
    """One int64 per voxel, exact for |coordinate| < 2^20."""
    c = coords + _KEY_BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def first_per_voxel(points: torch.Tensor, size: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices (ascending) of the first valid point of every occupied voxel."""
    idx = torch.arange(points.shape[0], device=points.device)
    if valid is not None:
        idx = idx[valid]
    if idx.numel() == 0:
        return idx
    key = voxel_key(voxel_coords(points[idx], size))
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), idx.numel(), dtype=torch.int64, device=points.device)
    first.scatter_reduce_(0, inv, torch.arange(idx.numel(), device=points.device), reduce="amin")
    return idx[torch.sort(first).values]


def voxel_hash(coords: torch.Tensor) -> np.ndarray:
    """The map's 32-bit voxel hash (multiplicative chain and murmur3's
    finalizer, in uint32 arithmetic that wraps) of int64 coords [N, 3]."""
    c = (coords.cpu().numpy() & MASK32).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = c[:, 0] * np.uint32(0x9E3779B1)
        h = (h + c[:, 1]) * np.uint32(0x85EBCA77)
        h = (h + c[:, 2]) * np.uint32(0xC2B2AE3D)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


# ---------------------------------------------------------------- the map

class MapGrid(NamedTuple):
    """The map's points that a 1 m voxel map keeps, and a lookup by voxel."""

    points: torch.Tensor  # [K, 3] kept points, sorted by voxel key
    feats: Optional[torch.Tensor]  # [K, D]
    keys: torch.Tensor  # [K] sorted voxel keys
    voxel_size: float
    cap: int


def build_map(points: torch.Tensor, feats: Optional[torch.Tensor], voxel_size: float, cap: int) -> MapGrid:
    """A voxel map keyed by the 32-bit hash of the voxel, as VoxelHashMap
    keys its buckets: the first `cap` points of a bucket in insertion order
    are kept (voxels whose hashes collide share one bucket and its cap)."""
    coords = voxel_coords(points, voxel_size)
    h = torch.from_numpy(voxel_hash(coords).astype(np.int64)).to(points.device)
    order = torch.sort(h, stable=True).indices
    hs = h[order]
    start = torch.ones_like(hs, dtype=torch.bool)
    start[1:] = hs[1:] != hs[:-1]
    pos = torch.arange(hs.numel(), device=points.device)
    run_start = torch.cummax(torch.where(start, pos, 0), dim=0).values
    keep = torch.zeros_like(start)
    keep[order] = (pos - run_start) < cap
    kept = torch.nonzero(keep)[:, 0]
    key = voxel_key(coords[kept])
    by_key = torch.sort(key, stable=True).indices
    sel = kept[by_key]
    return MapGrid(points[sel], None if feats is None else feats[sel], key[by_key], voxel_size, cap)


_OFFSETS = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])


def nearest_in_map(grid: MapGrid, queries: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """Distance [Q] from each query [Q, 3] to its nearest map point among
    the map points of the 27 voxels around the query's voxel (inf where
    those voxels are empty), by direct differences in f32."""
    out = torch.empty(queries.shape[0], dtype=torch.float32, device=queries.device)
    for a in range(0, queries.shape[0], block):
        q = queries[a:a + block]
        rows, ok = _gather(grid, q, block)
        d = grid.points[rows] - q[:, None, None, :]
        out[a:a + block] = torch.sqrt(torch.where(ok, (d * d).sum(dim=-1), float("inf")).amin(dim=(1, 2)))
    return out


def nearest_direct(queries: torch.Tensor, cloud: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Distance [Q] from each query to its nearest point of `cloud` [M, 3],
    by direct differences in f64 (exact enough to tell 1 mm apart)."""
    q64, c64 = queries.double(), cloud.double()
    out = torch.empty(queries.shape[0], dtype=torch.float64, device=queries.device)
    for a in range(0, queries.shape[0], block):
        d = q64[a:a + block, None, :] - c64[None]
        out[a:a + block] = torch.sqrt((d * d).sum(dim=-1).min(dim=1).values)
    return out


# ---------------------------------------------------------------- matching

def cosine_match(qfeats: torch.Tensor, map_feats: torch.Tensor, tf32: bool = False,
                 block: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best cosine [Q], best map row [Q]) of L2-normalized descriptors
    (a zero vector stays zero), the map streamed in blocks."""
    def unit(x):
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return torch.where(n > 0, x / torch.clamp(n, min=1e-20), 0.0)

    qn, mn = unit(qfeats.float()), unit(map_feats.float())
    best = torch.full((qn.shape[0],), -float("inf"), device=qn.device)
    arg = torch.zeros(qn.shape[0], dtype=torch.int64, device=qn.device)
    for a in range(0, mn.shape[0], block):
        s, j = mm(qn, mn[a:a + block].T.contiguous(), tf32).max(dim=1)
        better = s > best
        best = torch.where(better, s, best)
        arg = torch.where(better, j + a, arg)
    return best, arg


# ---------------------------------------------------------------- SE(3)

def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] with hat(w) v = w x v."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(dx: torch.Tensor) -> torch.Tensor:
    """Sophus' SE(3) exponential of dx = [translation, rotation] (6,) -> 4x4."""
    dx64 = dx.double()
    v, w = dx64[:3], dx64[3:]
    th2 = float((w * w).sum())
    K = hat(w)
    K2 = K @ K
    if th2 < 1e-8:
        a, b, c = 1 - th2 / 6, 0.5 - th2 / 24, 1 / 6 - th2 / 120
    else:
        th = np.sqrt(th2)
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th2, (th - np.sin(th)) / (th2 * th)
    eye = torch.eye(3, dtype=torch.float64, device=dx.device)
    T = torch.eye(4, dtype=torch.float64, device=dx.device)
    T[:3, :3] = eye + a * K + b * K2
    T[:3, 3] = (eye + b * K + c * K2) @ v
    return T.to(dx.dtype)


def about(T: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Trans(c) T Trans(-c): a step solved in coordinates centred at c."""
    out = T.clone()
    out[:3, 3] = T[:3, 3] + c - T[:3, :3] @ c
    return out


def gauss_newton(src: torch.Tensor, tgt: torch.Tensor, kernel: float, center: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """One robust point-to-point GN step dx (6,) for the pairs src -> tgt:
    J_i = [I | -hat(s_i - c)], Geman-McClure weight k^2 / (k + |r|^2)^2,
    (J^T W J + 1e-8 I) dx = -J^T W r; zero without pairs."""
    if src.shape[0] == 0:
        return src.new_zeros(6)
    r = src - tgt
    w = kernel * kernel / (kernel + (r * r).sum(dim=1)) ** 2
    J = torch.zeros((src.shape[0], 3, 6), dtype=src.dtype, device=src.device)
    J[:, :, :3] = torch.eye(3, dtype=src.dtype, device=src.device)
    J[:, :, 3:] = -hat(src - center)
    Jw = (J * w[:, None, None]).reshape(-1, 6)
    J2 = J.reshape(-1, 6)
    JTJ = mm(Jw.T.contiguous(), J2, tf32)
    JTr = mm(Jw.T.contiguous(), r.reshape(-1, 1), tf32)[:, 0]
    A = JTJ.double() + 1e-8 * torch.eye(6, dtype=torch.float64, device=src.device)
    dx = torch.linalg.solve(A, -JTr.double())
    if not bool(torch.isfinite(dx).all()):
        return src.new_zeros(6)
    return dx.to(src.dtype)


class ICPResult(NamedTuple):
    pose: np.ndarray  # [4, 4] f64
    iterations: int
    settled: bool  # stopped on a confirmed small step or on no pairs, not on the budget


def _gather(grid: MapGrid, source: torch.Tensor, block: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map rows of the 27 voxels around each point: (rows [N, 27, cap], ok [N, 27, cap])."""
    offs = _OFFSETS.to(source.device)
    lanes = torch.arange(grid.cap, device=source.device)
    rows, oks = [], []
    for a in range(0, source.shape[0], block):
        nk = voxel_key(voxel_coords(source[a:a + block], grid.voxel_size)[:, None, :] + offs[None])
        lo = torch.searchsorted(grid.keys, nk, right=False)
        hi = torch.searchsorted(grid.keys, nk, right=True)
        cand = lo[..., None] + lanes
        ok = cand < hi[..., None]
        rows.append(torch.where(ok, cand, 0))
        oks.append(ok)
    return torch.cat(rows), torch.cat(oks)


def _champions(grid: MapGrid, rows: torch.Tensor, ok: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Per point and gathered voxel, the voxel's point nearest to the
    point's current position: [N, 27, 3], inf where the voxel is empty."""
    p = grid.points[rows]  # [N, 27, cap, 3]
    d = p - source[:, None, None, :]
    d2 = torch.where(ok, (d * d).sum(dim=-1), float("inf"))
    best, j = torch.min(d2, dim=2)
    champ = torch.gather(p, 2, j[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    return torch.where(torch.isfinite(best)[..., None], champ, float("inf"))


def _nearest_champion(champs: torch.Tensor, source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = champs - source[:, None, :]
    d2 = (d * d).sum(dim=-1)
    best, j = torch.min(d2, dim=1)
    return torch.sqrt(best), torch.gather(champs, 1, j[:, None, None].expand(-1, 1, 3))[:, 0]


def icp(grid: MapGrid, points: torch.Tensor, guess: torch.Tensor, max_dist: float, kernel: float,
        max_iterations: int, threshold: float = 1e-4, tf32: bool = False,
        center: Optional[torch.Tensor] = None, T0: Optional[torch.Tensor] = None,
        it0: int = 0, refresh_interval: int = 16) -> ICPResult:
    """KISS-ICP's point-to-point loop as the evaluation's ICP runs it, with
    the map's neighbourhoods gathered once per motion epoch.

    The scan's points [N, 3] are moved by `guess` (and by `T0`, which
    continues a loop with `it0` iterations spent: VFM-ICP's second phase).
    Each step pairs every point with the nearest of its champions (kept
    below `max_dist`), solves one GN step centred at `center` (default: the
    points' mean after `guess`) and moves the points. The champions are,
    for each of the 27 voxels gathered around the point at the epoch's
    start, the voxel's point nearest to the point when they were last
    rebuilt. An epoch ends once the motion bound |dt| + |omega| r_max summed
    over its steps reaches half a voxel (r_max: the points' largest lever
    arm at the start); the champions are rebuilt at each epoch's start,
    after `refresh_interval` steps, and after a step below `threshold` on
    champions that are not fresh. The loop stops on a step below
    `threshold` taken on fresh champions, on a step without pairs, or on
    the budget."""
    source = transform(points, guess, tf32)
    if center is None:
        center = source.mean(dim=0)
    if T0 is None:
        T = torch.eye(4, dtype=points.dtype, device=points.device)
    else:
        T = T0.clone()
        source = transform(source, T0, tf32)
    r_max = float(torch.linalg.vector_norm(source - center, dim=1).max()) if source.shape[0] else 0.0
    slack = 0.5 * grid.voxel_size
    it, settled = it0, False
    phase, moved, fresh_steps = "gather", 0.0, 0
    while it < max_iterations:
        if phase == "gather":
            rows, ok = _gather(grid, source)
            moved = 0.0
        if phase in ("gather", "rebuild"):
            champs = _champions(grid, rows, ok, source)
            fresh_steps = 0
        dist, nbr = _nearest_champion(champs, source)
        pair = dist < max_dist
        dx = gauss_newton(source[pair], nbr[pair], kernel, center, tf32)
        step = about(exp_se3(dx), center)
        source = transform(source, step, tf32)
        T = mm(step, T, tf32)
        it += 1
        dxn = float(torch.linalg.vector_norm(dx))
        moved += float(torch.linalg.vector_norm(dx[:3])) + float(torch.linalg.vector_norm(dx[3:])) * r_max
        confirmed = fresh_steps == 0 and dxn < threshold
        fresh_steps += 1
        if confirmed or not bool(pair.any()):
            settled = True
            break
        if fresh_steps < refresh_interval and moved < slack and dxn >= threshold:
            phase = "step"
        else:
            phase = "rebuild" if moved < slack else "gather"
    pose = T.double() @ guess.double()
    return ICPResult(pose.cpu().numpy(), it, settled)


def masked_median(values: torch.Tensor) -> torch.Tensor:
    """Median (mean of the two middle values for an even count; 0 if empty)."""
    if values.numel() == 0:
        return values.new_zeros(())
    v = torch.sort(values).values
    n = v.numel()
    return 0.5 * (v[n // 2] + v[(n - 1) // 2])


def vfm_icp(grid: MapGrid, points: torch.Tensor, src_c: torch.Tensor, tgt_c: torch.Tensor,
            guess: torch.Tensor, max_dist: float, kernel: float, max_iterations: int,
            threshold: float = 1e-4, mean_tol: float = 0.01, mad_mult: float = 1.5,
            tf32: bool = False) -> np.ndarray:
    """VFM-Registration's VectorNd `RegisterFrame`: GN steps on the cosine
    correspondences (src_c -> tgt_c, src_c already moved by `guess`),
    keeping after each step the pairs with |d - median| < mad_mult x 1.4826
    MAD of their distances d, until the mean distance changes by less than
    `mean_tol`; then geometric ICP from there on the same centre and budget.
    Returns the pose [4, 4] (f64)."""
    center = transform(points, guess, tf32).mean(dim=0)
    T = torch.eye(4, dtype=points.dtype, device=points.device)
    keep = torch.ones(src_c.shape[0], dtype=torch.bool, device=points.device)
    prev = float(torch.linalg.vector_norm(src_c - tgt_c, dim=1).mean()) if src_c.shape[0] else 0.0
    it, done = 0, src_c.shape[0] == 0
    while not done and it < max_iterations:
        dx = gauss_newton(src_c[keep], tgt_c[keep], kernel, center, tf32)
        step = about(exp_se3(dx), center)
        moved = transform(src_c, step, tf32)
        d = torch.linalg.vector_norm(moved - tgt_c, dim=1)
        mean = float(d[keep].mean()) if bool(keep.any()) else 0.0
        med = masked_median(d[keep])
        mad = 1.4826 * masked_median(torch.abs(d[keep] - med))
        done = abs(prev - mean) < mean_tol or not bool(keep.any())
        src_c = moved
        T = mm(step, T, tf32)
        keep = keep & (torch.abs(d - med) < mad_mult * mad)
        prev = mean
        it += 1
    return icp(grid, points, guess, max_dist, kernel, max_iterations, threshold, tf32,
               center=center, T0=T, it0=it).pose


# ---------------------------------------------------------------- RANSAC

def kabsch(src: np.ndarray, tgt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rotations and translations [K, 3, 3], [K, 3] mapping
    src [K, n, 3] onto tgt [K, n, 3] (SVD with the reflection fix), f64."""
    cs, ct = src.mean(axis=1), tgt.mean(axis=1)
    H = np.einsum("kni,knj->kij", src - cs[:, None], tgt - ct[:, None])
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(np.einsum("kji,kjl->kil", Vt, U.transpose(0, 2, 1))))
    D = np.ones((src.shape[0], 3))
    D[:, 2] = np.where(d == 0, 1.0, d)
    R = np.einsum("kji,kj,klj->kil", Vt, D, U)
    t = ct - np.einsum("kij,kj->ki", R, cs)
    return R, t


def ransac(src: np.ndarray, tgt: np.ndarray, hypotheses: int, rng: np.random.Generator,
           block: int = 8192) -> np.ndarray:
    """Correspondence RANSAC as the evaluation driver runs it (3 picks a
    hypothesis, every pair an inlier, no early exit): the 3-pick Kabsch
    model with the least mean squared residual over all pairs: its pose
    [4, 4], f64."""
    n = src.shape[0]
    if n == 0:
        return np.eye(4)
    c = src.mean(axis=0)
    s, g = src - c, tgt - c
    a, gs = s.sum(axis=0), g.sum(axis=0)
    Sss, Stt, A = (s * s).sum(), (g * g).sum(), g.T @ s
    best, best_T = float("inf"), np.eye(4)
    picks = rng.integers(0, n, (hypotheses, 3))
    for o in range(0, hypotheses, block):
        p = picks[o:o + block]
        R, t = kabsch(s[p], g[p])
        mse = (Sss + Stt + n * (t * t).sum(1) + 2 * (t * np.einsum("kij,j->ki", R, a)).sum(1)
               - 2 * np.einsum("kij,ij->k", R, A) - 2 * (t * gs).sum(1)) / n
        mse = np.where(np.isfinite(mse), mse, np.inf)
        k = int(np.argmin(mse))
        if mse[k] < best:
            best = float(mse[k])
            best_T = np.eye(4)
            best_T[:3, :3], best_T[:3, 3] = R[k], t[k] + c - R[k] @ c
    return best_T


# ---------------------------------------------------------------- poses

def pair_mse(pose: np.ndarray, src: np.ndarray, tgt: np.ndarray) -> float:
    """Mean squared residual |R s + t - g|^2 of a pose over pairs [n, 3] (f64; 0 without pairs)."""
    if src.shape[0] == 0:
        return 0.0
    pose = np.asarray(pose, np.float64)
    r = src @ pose[:3, :3].T + pose[:3, 3] - tgt
    return float((r * r).sum(axis=1).mean())


def pose_gap(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """(translation gap in m, rotation gap in deg) between two 4x4 poses;
    the angle from the chord, exact to ~1e-9 rad."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return dt, float(np.rad2deg(2.0 * np.arcsin(min(chord, 1.0))))


def truth_gate(pose: np.ndarray, truth: np.ndarray, rte: float = 0.3, rre: float = 1.5) -> bool:
    """The paper's recall gate: within rte metres and rre degrees of the truth."""
    dt, dr = pose_gap(pose, truth)
    return dt < rte and dr < rre
