"""Scene JSON specs (`data/{nclt,robotcar}/scene_*.json`).

A copy of `vfmreg_tpu/data/scene.py`.

Schema (verified against `data/nclt/scene_000.json`, consumed at
`prepare_scenes.py:123-166`):

  {
    "mapping": {
      "point_clouds": [relpath, ...],       # map scans of the mapping session
      "images":       [[relpath x cams],...],  # surround images per scan
      "poses":        [[4x4], ...]          # world poses per map scan
    },
    "registration": [
      {"point_cloud": relpath, "images": [relpath x cams], "pose": [4x4]},
      ...
    ]
  }

This module loads/validates/writes the schema and carries the release-file GT
update utility (the `data["registration"][i]["pose"] = gt` path at
`registration_node.py:652-662`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def load_scene_spec(path: Path) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        spec = json.load(f)
    validate_scene_spec(spec)
    return spec


def validate_scene_spec(spec: Dict[str, Any]) -> None:
    if "mapping" not in spec or "registration" not in spec:
        raise ValueError("scene spec must have 'mapping' and 'registration'")
    m = spec["mapping"]
    n = len(m["point_clouds"])
    if len(m["images"]) != n or len(m["poses"]) != n:
        raise ValueError("mapping point_clouds/images/poses lengths differ")
    for pose in m["poses"]:
        if np.asarray(pose).shape != (4, 4):
            raise ValueError("mapping poses must be 4x4")
    for reg in spec["registration"]:
        for key in ("point_cloud", "images", "pose"):
            if key not in reg:
                raise ValueError(f"registration entry missing '{key}'")
        if np.asarray(reg["pose"]).shape != (4, 4):
            raise ValueError("registration poses must be 4x4")


def write_scene_spec(path: Path, spec: Dict[str, Any]) -> None:
    validate_scene_spec(spec)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False, indent=4)


def make_scene_spec(
    map_point_clouds: List[str],
    map_images: List[List[str]],
    map_poses: List[np.ndarray],
    reg_point_clouds: List[str],
    reg_images: List[List[str]],
    reg_poses: List[np.ndarray],
) -> Dict[str, Any]:
    spec = {
        "mapping": {
            "point_clouds": list(map_point_clouds),
            "images": [list(x) for x in map_images],
            "poses": [np.asarray(p).tolist() for p in map_poses],
        },
        "registration": [
            {"point_cloud": pc, "images": list(im), "pose": np.asarray(p).tolist()}
            for pc, im, p in zip(reg_point_clouds, reg_images, reg_poses)
        ],
    }
    validate_scene_spec(spec)
    return spec


def update_release_gt_pose(release_file: Path, scan_index: int, gt_pose: np.ndarray) -> None:
    """Write a refined GT pose back into a release scene file
    (`registration_node.py:652-662`)."""
    with open(release_file, "r", encoding="utf-8") as f:
        data = json.load(f)
    data["registration"][scan_index]["pose"] = np.asarray(gt_pose).tolist()
    with open(release_file, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)
