"""The subset of `vfmreg_tpu/config.py` that the evaluation driver reads.

A copy of the reference's defaults (`config.py:22-57`, `:143`), kept here so
the port imports nothing of the JAX package: the KISS data range sets the
map voxel size (max_range / 100), the per-voxel cap, and the adaptive
threshold's initial sigma, which scales the driver's ICP rows.
"""

from __future__ import annotations

MAX_RANGE = 100.0  # DataConfig.max_range
VOXEL_SIZE = MAX_RANGE / 100.0  # MappingConfig.voxel_size default (`config.py:143`)
MAX_POINTS_PER_VOXEL = 20  # MappingConfig.max_points_per_voxel
INITIAL_THRESHOLD = 2.0  # AdaptiveThresholdConfig.initial_threshold (sigma)
