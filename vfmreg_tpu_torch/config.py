"""The subset of `vfmreg_tpu/config.py` that the evaluation driver reads.

A copy of the reference's defaults (`config.py:18-57`, `:83-143`), kept here
so the port imports nothing of the JAX package: the KISS data range sets the
map voxel size (max_range / 100), the per-voxel cap, and the adaptive
threshold's initial sigma, which scales the driver's ICP rows.

The module constants are those defaults, read by the batched method row;
`load_config` returns them as the reference's `KISSConfig` tree, which
`RegistrationNode` and `kiss.mapping.get_voxel_hash_map` read. Reading a
YAML file waits for the KISS odometry port (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MAX_RANGE = 100.0  # DataConfig.max_range
VOXEL_SIZE = MAX_RANGE / 100.0  # MappingConfig.voxel_size default (`config.py:143`)
MAX_POINTS_PER_VOXEL = 20  # MappingConfig.max_points_per_voxel
INITIAL_THRESHOLD = 2.0  # AdaptiveThresholdConfig.initial_threshold (sigma)


@dataclasses.dataclass
class DataConfig:
    """kiss_icp DataConfig (`config/config.py:28-32`), the fields `load_config`
    and the map read."""

    max_range: float = MAX_RANGE
    min_range: float = 5.0
    deskew: bool = False


@dataclasses.dataclass
class MappingConfig:
    """kiss_icp MappingConfig (`config/config.py:35-37`) with the reference's
    merge interval of the device-resident map (1: merge every update)."""

    voxel_size: Optional[float] = None  # default: max_range / 100
    max_points_per_voxel: int = MAX_POINTS_PER_VOXEL
    map_merge_interval: int = 1


@dataclasses.dataclass
class AdaptiveThresholdConfig:
    """kiss_icp AdaptiveThresholdConfig (`config/config.py:40-43`): the
    initial sigma, which scales the driver's ICP rows."""

    initial_threshold: float = INITIAL_THRESHOLD


@dataclasses.dataclass
class KISSConfig:
    """The odometry-side config (`config/parser.py:39-83`), the part the
    evaluation driver reads; the odometry's fields wait for ROADMAP A10."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    adaptive_threshold: AdaptiveThresholdConfig = dataclasses.field(
        default_factory=AdaptiveThresholdConfig
    )


def load_config(
    config_file=None, deskew: Optional[bool] = None, max_range: Optional[float] = None
) -> KISSConfig:
    """kiss_icp `load_config` (`config/parser.py:61-83`) without a file: the
    defaults, the deskew / max_range overrides, min_range cut to 0 above
    max_range, and voxel_size = max_range / 100."""
    if config_file is not None:
        raise NotImplementedError(
            "load_config: reading a YAML config waits for the KISS odometry port (ROADMAP A10)"
        )
    config = KISSConfig()
    if deskew is not None:
        config.data.deskew = deskew
    if max_range is not None:
        config.data.max_range = max_range
    if config.data.max_range < config.data.min_range:
        print("[WARNING] max_range is smaller than min_range, setting min_range to 0.0")
        config.data.min_range = 0.0
    if config.mapping.voxel_size is None:
        config.mapping.voxel_size = float(config.data.max_range / 100.0)
    return config
