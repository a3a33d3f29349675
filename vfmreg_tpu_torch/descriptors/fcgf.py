"""FCGF extractor: `extract_fcgf_features` (`descriptors.py:86-115`).

Counterpart of `vfmreg_tpu/descriptors/fcgf.py`: MinkowskiEngine's
`sparse_quantize` on the host (floor-quantize, the first point of each
voxel, in input order), all-ones input features, and `ResUNetBN2C`
(`models/sparse_resunet.py`) at the voxels' exact count (the reference pads
to `bucket_size`; padding changes no valid row). Weights from `weight_path`
or $VFMREG_FCGF_WEIGHTS (a MinkowskiEngine checkpoint: its ['state_dict'],
or the state dict itself), else seeded random ones.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.descriptors._weights import learned_net
from vfmreg_tpu_torch.models.sparse_resunet import (
    FCGF_CONFIG, ResUNetConfig, init_resunet_params, load_me_state_dict, resunet_forward,
)
from vfmreg_tpu_torch.ops.sparse_conv import COORD_BIAS, coord_key
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision


def sparse_quantize(pcl: np.ndarray, voxel_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """`ME.utils.sparse_quantize`: floor-quantize, the first index of each
    voxel (`descriptors.py:100-104`). (coords int32 [M, 3], inds [M]), in
    input order."""
    coords = np.floor(np.asarray(pcl)[:, :3] / voxel_size).astype(np.int64)
    if coords.size and (coords.min() < -COORD_BIAS or coords.max() >= COORD_BIAS):
        raise ValueError(f"voxel coordinates outside [-2^20, 2^20) at voxel size {voxel_size}")
    _, first = np.unique(coord_key(torch.from_numpy(coords)).numpy(), return_index=True)
    first = np.sort(first)
    return coords[first].astype(np.int32), first


def resunet_features(env: str, cfg: ResUNetConfig, pcl: np.ndarray, voxel_size: float,
                     weight_path: Optional[str], device) -> Tuple[np.ndarray, np.ndarray]:
    """(the first point of each voxel [M, 3] f32, descriptors [M, 32] f64)
    of the cloud through the ResUNet of `cfg`, weights from `weight_path` or
    $`env`, on `device` (default: the card)."""
    dev = resolve_device(device)
    full_precision()
    net = learned_net(env, partial(load_me_state_dict, cfg=cfg), partial(init_resunet_params, cfg=cfg), dev,
                      weight_path, unwrap="state_dict")
    pcl = np.asarray(pcl)[:, :3]
    coords, inds = sparse_quantize(pcl, voxel_size)
    m = coords.shape[0]
    out = resunet_forward(net, torch.from_numpy(coords).to(dev), torch.ones((m, 1), device=dev),
                          torch.ones(m, dtype=torch.bool, device=dev))
    return pcl[inds].astype(np.float32), out.cpu().numpy().astype(np.float64)


def extract_fcgf_features(pcl: np.ndarray, voxel_size: float, weight_path: Optional[str] = None,
                          device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, 3] f32, 32-d descriptors [M, 32] f64) of the cloud."""
    return resunet_features("VFMREG_FCGF_WEIGHTS", FCGF_CONFIG, pcl, voxel_size, weight_path, device)
