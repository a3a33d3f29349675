"""DIP extractor: `extract_dip_features` (`descriptors.py:45-83`).

Counterpart of `vfmreg_tpu/descriptors/dip.py`: a first-wins voxel
downsample, the 384 nearest points within the LRF kernel (0.6 sqrt(3) m) of
each point on a grid of that voxel size (24 points a voxel), an LRF patch of
256 of them per point (`models/dip.compute_lrf_patches`), and the PointNet
descriptor. Points run in chunks of CHUNK; the network in batches of
`batch_size`. The patch subsample is drawn on the CPU from a generator
seeded with `seed` (`models/dip.draw_patch_perm`), chunk by chunk, or
injected as `perm`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.descriptors._weights import learned_net
from vfmreg_tpu_torch.descriptors.fpfh import _grid_input_order
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.models.dip import (
    LRF_KERNEL, compute_lrf_patches, dip_forward, draw_patch_perm, init_dip_params,
    load_dip_state_dict,
)
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.knn import radius_knn
from vfmreg_tpu_torch.ops.voxel import bucket_size
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

K_NEIGHBOURS = 384
CHUNK = 16384


def get_dip_net(device=None, weight_path: Optional[str] = None):
    """The DIP network: `weight_path` or $VFMREG_DIP_WEIGHTS, else seeded
    random weights."""
    return learned_net("VFMREG_DIP_WEIGHTS", load_dip_state_dict, init_dip_params, resolve_device(device),
                       weight_path)


def extract_dip_features(
    pcl: np.ndarray,
    voxel_size: float,
    weight_path: Optional[str] = None,
    batch_size: int = 512,
    device=None,
    seed: int = 0,
    perm: Optional[torch.Tensor] = None,  # [M, PATCH_SIZE] slots, M = the downsampled count
) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, 3] f64, 32-d descriptors [M, 32] f64) of the cloud."""
    dev = resolve_device(device)
    full_precision()
    net = get_dip_net(dev, weight_path)
    down = voxel_down_sample(np.asarray(pcl)[:, :3], voxel_size).astype(np.float32)
    m0 = down.shape[0]
    n = bucket_size(m0)
    pts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pts[:m0] = torch.from_numpy(down).to(dev)
    mask = torch.arange(n, device=dev) < m0
    gen = torch.Generator().manual_seed(seed)
    feats = []
    with torch.no_grad():
        grid = build_hash_grid(pts, LRF_KERNEL, mask=mask, max_points_per_voxel=24)
        order = _grid_input_order(pts, mask, grid.voxel_size)
        for c0 in range(0, m0, CHUNK):
            q, qm = pts[c0 : min(c0 + CHUNK, m0)], mask[c0 : min(c0 + CHUNK, m0)]
            knn = radius_knn(grid, q, qm, k=K_NEIGHBOURS, radius=LRF_KERNEL)
            p = (draw_patch_perm(q.shape[0], K_NEIGHBOURS, gen, dev) if perm is None
                 else perm[c0 : c0 + q.shape[0]].to(dev))
            patches, _ = compute_lrf_patches(pts, order[knn.idx], knn.mask, p, q)
            for b in range(0, q.shape[0], batch_size):
                feats.append(dip_forward(net, patches[b : b + batch_size]))
    out = torch.cat(feats).cpu().numpy() if feats else np.zeros((0, 32), np.float32)
    return down.astype(np.float64), out.astype(np.float64)
