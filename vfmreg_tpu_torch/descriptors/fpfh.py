"""FPFH (Fast Point Feature Histograms).

Counterpart of `vfmreg_tpu/descriptors/fpfh.py`, Open3D's `estimate_normals`
+ `compute_fpfh_feature` as `extract_fpfh_features` calls them: normals from
the 30 nearest points within 2 voxels (smallest covariance eigenvector, its
sign toward +z), a first-wins voxel downsample that keeps each survivor's
normal, and the 33-bin FPFH within 5 voxels and 100 neighbours, optionally
L2-normalized.

For a pair (p, q) with normals, the source is the one whose normal makes
the larger angle with the connecting line; in its Darboux frame (u = n_s,
v = d x u, w = u x v) the pair gives f1 = v . n_t, f2 = u . d and
f3 = atan2(w . n_t, u . n_t), binned into 11 bins each over [-1, 1], [-1, 1]
and [-pi, pi] (SPFH, each pair weighing 100 / k). FPFH(p) = SPFH(p) + the
1 / |p - q|-weighted sum of the neighbours' SPFHs, each 11-bin block
renormalized to 100.

The bin of a value is trunc((f - lo) * c) in f32 with c = f32(1 / (hi -
lo)) * 11, the arithmetic of the reference's compiled program, so a value
on an edge lands in the same bin. The
neighbourhoods are `ops/knn.radius_knn`'s (27-voxel grid candidates,
capped per voxel, as the reference). Queries run in chunks of
QUERY_CHUNK rows.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfmreg_tpu_torch.geometry.linalg3 import covariance3, cross3, dot3, eigh3
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.knn import radius_knn
from vfmreg_tpu_torch.ops.voxel import INVALID_HASH, bucket_size, voxel_coords, voxel_down_sample_masked, voxel_hash
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

N_BINS = 11
QUERY_CHUNK = 32768


def _grid_input_order(points: torch.Tensor, mask: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Input row held by each grid row (the grid's stable hash sort)."""
    h = torch.where(mask, voxel_hash(voxel_coords(points, voxel_size)), INVALID_HASH)
    return torch.sort(h, stable=True).indices


def _normals_chunk(grid, q_pts, q_mask, radius, max_nn: int) -> torch.Tensor:
    knn = radius_knn(grid, q_pts, q_mask, k=max_nn, radius=radius)
    _, vecs = eigh3(covariance3(grid.points[knn.idx], knn.mask.to(torch.float32)))
    normal = vecs[..., 0]
    sign = torch.where(
        normal[:, 2] != 0,
        torch.sign(normal[:, 2]),
        torch.where(normal[:, 1] != 0, torch.sign(normal[:, 1]), torch.sign(normal[:, 0] + 1e-30)),
    )
    return normal * sign[:, None]


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, radius, max_nn: int = 30,
                     chunk: int = QUERY_CHUNK) -> torch.Tensor:
    """PCA normals (smallest covariance eigenvector), the sign toward +z:
    Open3D's KDTreeSearchParamHybrid(radius, max_nn), unoriented."""
    grid = build_hash_grid(points, radius, mask=mask, max_points_per_voxel=max_nn + 8)
    return torch.cat([
        _normals_chunk(grid, points[b : b + chunk], mask[b : b + chunk], radius, max_nn)
        for b in range(0, points.shape[0], chunk)
    ])


def _pair_features(p, n_p, q, n_q, valid):
    """(f1, f2, f3, valid) of the pairs, PCL's source / target ordering."""
    d = q - p
    dist = torch.sqrt(dot3(d, d))
    dn = d / torch.clamp(dist[..., None], min=1e-12)
    dot1 = dot3(n_p, dn)
    dot2 = dot3(n_q, -dn)
    swap = (torch.abs(dot1) < torch.abs(dot2))[..., None]
    src_n = torch.where(swap, n_q, n_p)
    tgt_n = torch.where(swap, n_p, n_q)
    d_st = torch.where(swap, -dn, dn)
    u = src_n
    v = cross3(d_st, u)
    v_norm = torch.sqrt(dot3(v, v))[..., None]
    v = v / torch.clamp(v_norm, min=1e-12)
    w = cross3(u, v)
    f1 = dot3(v, tgt_n)
    f2 = dot3(u, d_st)
    f3 = torch.atan2(dot3(w, tgt_n), dot3(u, tgt_n))
    degenerate = (dist < 1e-12) | (v_norm[..., 0] < 1e-12)
    return f1, f2, f3, valid & ~degenerate


def _histogram(f: torch.Tensor, lo: float, hi: float, weights: torch.Tensor) -> torch.Tensor:
    # The reference's XLA program folds `/ (hi - lo) * 11` into one product
    # by the f32 constant f32(1 / (hi - lo)) * 11; the same single rounding
    # here puts a value on a bin edge in the same bin.
    scale = np.float32(np.float32(1.0) / np.float32(hi - lo)) * np.float32(N_BINS)
    bins = torch.clamp(((f - lo) * float(scale)).to(torch.int32), 0, N_BINS - 1)
    onehot = F.one_hot(bins.to(torch.int64), N_BINS).to(torch.float32)
    return torch.einsum("nkb,nk->nb", onehot, weights)


def _spfh_chunk(grid, order, points, normals, q_pts, q_normals, q_mask, radius, max_nn: int):
    knn = radius_knn(grid, q_pts, q_mask, k=max_nn, radius=radius, exclude_self=True)
    rows = order[knn.idx]
    f1, f2, f3, valid = _pair_features(q_pts[:, None, :], q_normals[:, None, :], points[rows], normals[rows],
                                       knn.mask)
    k_count = torch.clamp(valid.to(torch.float32).sum(dim=1, keepdim=True), min=1.0)
    incr = torch.where(valid, 100.0 / k_count, 0.0)
    spfh = torch.cat([
        _histogram(f1, -1.0, 1.0, incr),
        _histogram(f2, -1.0, 1.0, incr),
        _histogram(f3, -math.pi, math.pi, incr),
    ], dim=1)
    return spfh, knn.idx, knn.dist, valid


def _fpfh_chunk(spfh_all, order, own_spfh, nbr_idx, nbr_dist, valid):
    """The 1 / distance-weighted neighbour SPFH sum, each block renormalized
    to 100, plus the point's own SPFH."""
    inv_d = torch.where(valid, 1.0 / torch.clamp(nbr_dist, min=1e-12), 0.0)
    acc = torch.einsum("nkf,nk->nf", spfh_all[order[nbr_idx]], inv_d)
    blocks = acc.reshape(-1, 3, N_BINS)
    acc = (blocks / torch.clamp(blocks.sum(dim=2, keepdim=True), min=1e-12) * 100.0).reshape(-1, 3 * N_BINS)
    has_nbr = valid.sum(dim=1) > 0
    return torch.where(has_nbr[:, None], acc + own_spfh, own_spfh)


def fpfh_on_cloud(points, normals, mask, radius, max_nn: int = 100, chunk: int = QUERY_CHUNK) -> torch.Tensor:
    """[N, 33] FPFH of the masked cloud [N, 3] with its normals."""
    grid = build_hash_grid(points, radius, mask=mask, max_points_per_voxel=48)
    order = _grid_input_order(points, mask, grid.voxel_size)
    parts = [
        _spfh_chunk(grid, order, points, normals, points[b : b + chunk], normals[b : b + chunk],
                    mask[b : b + chunk], radius, max_nn)
        for b in range(0, points.shape[0], chunk)
    ]
    spfh_all = torch.cat([p[0] for p in parts])
    return torch.cat([_fpfh_chunk(spfh_all, order, *p) for p in parts])


def extract_fpfh_features(
    pcl: np.ndarray, voxel_size: float, normalize: bool = False, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """`descriptors.py:19-42`: (points [M, 3] f64, features [M, 33] f64) of
    the cloud [N, >= 3], computed on `device` (default: the card)."""
    dev = resolve_device(device)
    full_precision()
    pcl = np.ascontiguousarray(np.asarray(pcl)[:, :3], dtype=np.float32)
    n = bucket_size(max(pcl.shape[0], 1))
    pts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pts[: pcl.shape[0]] = torch.from_numpy(pcl).to(dev)
    mask = torch.arange(n, device=dev) < pcl.shape[0]
    with torch.no_grad():
        normals = estimate_normals(pts, mask, radius=2.0 * voxel_size, max_nn=30)
        down_pts, down_normals, down_mask = voxel_down_sample_masked(pts, voxel_size, mask=mask, feats=normals)
        feats = fpfh_on_cloud(down_pts, down_normals, down_mask, radius=5.0 * voxel_size, max_nn=100)
    m = down_mask.cpu().numpy()
    out_pts = down_pts.cpu().numpy()[m].astype(np.float64)
    out_feats = feats.cpu().numpy()[m].astype(np.float64)
    if normalize:
        out_feats = out_feats / (np.linalg.norm(out_feats, axis=1, keepdims=True) + 1e-6)
    return out_pts, out_feats
