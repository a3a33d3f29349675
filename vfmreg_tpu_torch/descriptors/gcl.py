"""GCL extractor: `extract_gcl_features` (`descriptors.py:149-178`).

Counterpart of `vfmreg_tpu/descriptors/gcl.py`: `ResUNetFatBN` at the
given voxel size (0.3 m in the scene loop), all-ones input features,
normalised output, as FCGF's extractor (`descriptors/fcgf.py`). Weights
from `weight_path` or $VFMREG_GCL_WEIGHTS, else seeded random ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vfmreg_tpu_torch.descriptors.fcgf import resunet_features
from vfmreg_tpu_torch.models.sparse_resunet import GCL_CONFIG


def extract_gcl_features(pcl: np.ndarray, voxel_size: float, weight_path: Optional[str] = None,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, 3] f32, 32-d descriptors [M, 32] f64) of the cloud."""
    return resunet_features("VFMREG_GCL_WEIGHTS", GCL_CONFIG, pcl, voxel_size, weight_path, device)
