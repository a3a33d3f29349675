"""GeDi extractor: `extract_gedi_features` (`descriptors.py:118-146`).

Counterpart of `vfmreg_tpu/descriptors/gedi.py`: a first-wins voxel
downsample, at most `n_points` of its points (a `np.random.RandomState(0)`
choice, as the reference), the 768 nearest points within R_LRF = 0.5 m of
each on a grid of that voxel size (32 points a voxel; the reference
samples 4,000 of all in-radius points), an LRF patch of 512 per point
(`models/gedi.gedi_lrf_patches`), and the PointNet++ descriptor. Points run
in chunks of CHUNK; the network in batches of `batch_size` (the reference's
256 keeps its jit shapes; a larger batch here only saves launches of the
sampling loops). The patch sampling is drawn on the CPU from a generator
seeded with `seed` (`models/gedi.draw_patch_keys`), chunk by chunk, or
injected as `draws` = (keys [M, 768], replica [M, 512]).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.descriptors._weights import learned_net
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.models.gedi import (
    R_LRF, draw_patch_keys, gedi_forward, gedi_lrf_patches, init_gedi_params,
    load_gedi_state_dict, replicas,
)
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.knn import radius_knn
from vfmreg_tpu_torch.ops.voxel import bucket_size
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

K_NEIGHBOURS = 768
BATCH = 2048
CHUNK = 8192


def get_gedi_net(device=None, weight_path: Optional[str] = None):
    """The GeDi network: `weight_path` or $VFMREG_GEDI_WEIGHTS (a file of the
    state dict, or `chkpt.tar` holding it under `pnet_model_state_dict`),
    else seeded random weights."""
    return learned_net("VFMREG_GEDI_WEIGHTS", load_gedi_state_dict, init_gedi_params, resolve_device(device),
                       weight_path, unwrap="pnet_model_state_dict")


def extract_gedi_features(
    pcl: np.ndarray,
    voxel_size: float,
    n_points=np.inf,
    weight_path: Optional[str] = None,
    batch_size: int = BATCH,
    device=None,
    seed: int = 0,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, 3] f64, 32-d descriptors [M, 32] f64) of the cloud."""
    dev = resolve_device(device)
    full_precision()
    net = get_gedi_net(dev, weight_path)
    down = voxel_down_sample(np.asarray(pcl)[:, :3], voxel_size).astype(np.float32)
    if np.isfinite(n_points) and down.shape[0] > n_points:
        sel = np.random.RandomState(0).choice(down.shape[0], int(n_points), replace=False)
        down = down[sel]
    m0 = down.shape[0]
    n = bucket_size(m0)
    pts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pts[:m0] = torch.from_numpy(down).to(dev)
    mask = torch.arange(n, device=dev) < m0
    gen = torch.Generator().manual_seed(seed)
    feats = []
    with torch.no_grad():
        grid = build_hash_grid(pts, R_LRF, mask=mask, max_points_per_voxel=32)
        for c0 in range(0, m0, CHUNK):
            c1 = min(c0 + CHUNK, m0)
            knn = radius_knn(grid, pts[c0:c1], mask[c0:c1], k=K_NEIGHBOURS, radius=R_LRF)
            if draws is None:
                keys, frac = draw_patch_keys(c1 - c0, K_NEIGHBOURS, gen, dev)
                rep = replicas(frac, knn.mask)
            else:
                keys, rep = draws[0][c0:c1].to(dev), draws[1][c0:c1].to(dev)
            nbr = grid.points[knn.idx]
            for b in range(0, c1 - c0, batch_size):
                s = slice(b, b + batch_size)
                patches = gedi_lrf_patches(pts[c0:c1][s], nbr[s], knn.mask[s], keys[s], rep[s], r_lrf=R_LRF)
                feats.append(gedi_forward(net, patches))
    out = torch.cat(feats).cpu().numpy() if feats else np.zeros((0, 32), np.float32)
    return down.astype(np.float64), out.astype(np.float64)

