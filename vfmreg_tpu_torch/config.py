"""The KISS configuration tree of `vfmreg_tpu/config.py`, for the port.

A copy of the reference's odometry-side config (`config.py:18-57`, `:83-153`;
the reference's `kiss_icp/config/{config,parser}.py`), kept here so the port
imports nothing of the JAX package. The KISS data range sets the map voxel
size (max_range / 100), the per-voxel cap and the adaptive threshold's
initial sigma, which also scales the evaluation driver's ICP rows.

The module constants are those defaults, read by the batched method row;
`load_config` returns the `KISSConfig` tree, from the defaults or a YAML file
(`configs/basic.yaml`, `configs/advanced.yaml`), and `write_config` dumps
one. `yaml` is imported only by those two.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

MAX_RANGE = 100.0  # DataConfig.max_range
VOXEL_SIZE = MAX_RANGE / 100.0  # MappingConfig.voxel_size default (`config.py:143`)
MAX_POINTS_PER_VOXEL = 20  # MappingConfig.max_points_per_voxel
INITIAL_THRESHOLD = 2.0  # AdaptiveThresholdConfig.initial_threshold (sigma)


@dataclasses.dataclass
class DataConfig:
    """kiss_icp DataConfig (`config/config.py:28-32`)."""

    preprocess: bool = True
    max_range: float = MAX_RANGE
    min_range: float = 5.0
    deskew: bool = False


@dataclasses.dataclass
class MappingConfig:
    """kiss_icp MappingConfig (`config/config.py:35-37`) with the merge
    interval of the device-resident map (1: merge every update; see
    `kiss/mapping.py`)."""

    voxel_size: Optional[float] = None  # default: max_range / 100
    max_points_per_voxel: int = MAX_POINTS_PER_VOXEL
    map_merge_interval: int = 1


@dataclasses.dataclass
class AdaptiveThresholdConfig:
    """kiss_icp AdaptiveThresholdConfig (`config/config.py:40-43`)."""

    fixed_threshold: Optional[float] = None
    initial_threshold: float = INITIAL_THRESHOLD
    min_motion_th: float = 0.1


@dataclasses.dataclass
class KISSConfig:
    """The odometry-side config (`config/parser.py:39-83`)."""

    out_dir: str = "results"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    adaptive_threshold: AdaptiveThresholdConfig = dataclasses.field(
        default_factory=AdaptiveThresholdConfig
    )


def load_config(
    config_file: Optional[Path] = None, deskew: Optional[bool] = None, max_range: Optional[float] = None
) -> KISSConfig:
    """kiss_icp `load_config` (`config/parser.py:61-83`): the defaults with the
    YAML file's overrides (sections `data`, `mapping`, `adaptive_threshold`
    and `out_dir`; unknown keys ignored), then the deskew / max_range
    overrides, min_range cut to 0 above max_range, and voxel_size =
    max_range / 100 where the file sets none."""
    config = KISSConfig()
    if config_file is not None:
        import yaml

        with open(config_file) as f:
            data = yaml.safe_load(f) or {}
        for section_name in ("data", "mapping", "adaptive_threshold"):
            target = getattr(config, section_name)
            for k, v in (data.get(section_name) or {}).items():
                if hasattr(target, k):
                    setattr(target, k, v)
        if "out_dir" in data:
            config.out_dir = data["out_dir"]
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


def write_config(config: KISSConfig, filename: str) -> None:
    """Dump a KISSConfig to YAML (`config/parser.py:86-93`)."""
    import yaml

    with open(filename, "w") as f:
        yaml.dump(dataclasses.asdict(config), f, default_flow_style=False)
