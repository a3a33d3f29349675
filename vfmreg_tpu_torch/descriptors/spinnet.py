"""SpinNet extractor: `extract_spinnet_features` (`descriptors.py:181-235`).

Counterpart of `vfmreg_tpu/descriptors/spinnet.py`: at most `n_points`
keypoints of the cloud (a `np.random.RandomState(seed)` choice without
replacement, as the reference), each with its patch of the first 2,048
points within 2 m (ball-query order; the padding slots, those repeating
slot 0, replaced by the keypoint, and slot -1 forced to the keypoint,
`select_patches`, `descriptors.py:199-214`), and the cylindrical network's
descriptor (`models/spinnet.spinnet_forward`). Keypoints run in batches of
`batch_size` (the reference's 8 bounds its dense ball query; here the
ball queries are blocked on their own).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.descriptors._weights import learned_net
from vfmreg_tpu_torch.models.spinnet import (
    AZI_N, ELE_N, RAD_N, VOXEL_R, VOXEL_SAMPLE, get_voxel_coordinate, init_spinnet_params,
    load_spinnet_state_dict, spinnet_forward,
)
from vfmreg_tpu_torch.ops.pointnet2 import ball_query
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

VICINITY = 2.0  # descriptors.py:186
POINTS_PER_PATCH = 2048  # descriptors.py:217
BATCH = 32


def get_spinnet_net(device=None, weight_path: Optional[str] = None):
    """The SpinNet network: `weight_path` or $VFMREG_SPINNET_WEIGHTS, else
    seeded random weights."""
    return learned_net("VFMREG_SPINNET_WEIGHTS", load_spinnet_state_dict, init_spinnet_params,
                       resolve_device(device), weight_path)


def select_keypoints(pcl: np.ndarray, n_points: int, seed: int = 0) -> np.ndarray:
    pcl = np.ascontiguousarray(np.asarray(pcl)[:, :3], dtype=np.float32)
    if pcl.shape[0] > n_points:
        return pcl[np.random.RandomState(seed).choice(pcl.shape[0], n_points, replace=False)]
    return pcl


def select_patches(cloud: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """cloud [P, 3], keypoints [B, 3] -> patches [B, POINTS_PER_PATCH, 3]."""
    gidx = ball_query(VICINITY, POINTS_PER_PATCH, cloud[None], keypoints[None])[0]  # [B, P]
    patch = cloud[gidx]
    pad = gidx == gidx[:, 0:1]
    pad[:, 0] = False
    pad[:, -1] = True
    return torch.where(pad[..., None], keypoints[:, None, :], patch)


def extract_spinnet_features(
    pcl: np.ndarray,
    n_points: int,
    weight_path: Optional[str] = None,
    batch_size: int = BATCH,
    seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(keypoints [K, 3] f64, 32-d descriptors [K, 32] f64) of the cloud."""
    dev = resolve_device(device)
    full_precision()
    net = get_spinnet_net(dev, weight_path)
    pcl = np.ascontiguousarray(np.asarray(pcl)[:, :3], dtype=np.float32)
    keypoints = select_keypoints(pcl, n_points, seed)
    grid_pts = torch.as_tensor(get_voxel_coordinate(VICINITY, RAD_N, AZI_N, ELE_N), dtype=torch.float32,
                               device=dev)
    cloud = torch.from_numpy(pcl).to(dev)
    kp = torch.from_numpy(keypoints).to(dev)
    descs = []
    with torch.no_grad():
        for b in range(0, kp.shape[0], batch_size):
            patch = select_patches(cloud, kp[b : b + batch_size])
            descs.append(spinnet_forward(net, patch, grid_pts, RAD_N, AZI_N, ELE_N, VOXEL_R, VOXEL_SAMPLE))
    out = torch.cat(descs).cpu().numpy() if descs else np.zeros((0, 32), np.float32)
    return keypoints.astype(np.float64), out.astype(np.float64)
