"""Scene HDF5 reader and writer, in the reference's layout.

A copy of `vfmreg_tpu/data/h5io.py` (`save_scene` `:20`, `read_scenes`
`:48`):

  /map/<map-sequence>/pose/<jjj>            [4,4]
  /map/<map-sequence>/point_cloud/<jjj>     [N, 3+D]
  /map/<map-sequence>/clip/<jjj>            (optional)
  /scans/<scan-sequence>/pose               [4,4]
  /scans/<scan-sequence>/point_cloud        [N, 3+D]

`h5py` is imported inside the functions: the card machine has none, and
nothing else of the package needs it. Without it they raise ImportError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def _h5py(filename):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading or writing the scene file {filename} needs h5py") from e
    return h5py


def save_scene(
    filename: Path,
    sequences: Sequence[str],
    map_poses,
    map_point_clouds,
    seq_poses,
    seq_point_clouds,
) -> None:
    """`save_scene` (`prepare_scenes.py:16-47`): the map clouds under the
    first sequence name, scan j under sequence j + 1 (None poses skipped)."""
    filename = Path(filename)
    h5py = _h5py(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(filename, "w") as file:
        map_group = file.create_group(f"map/{sequences[0]}")
        pose_group = map_group.create_group("pose")
        pcl_group = map_group.create_group("point_cloud")
        for j in range(len(map_poses)):
            pose_group.create_dataset(f"{j:03}", data=map_poses[j])
            pcl_group.create_dataset(f"{j:03}", data=map_point_clouds[j])

        scans_group = file.create_group("scans")
        for j in range(len(seq_poses)):
            if seq_poses[j] is None:
                continue
            scan_group = scans_group.create_group(f"{sequences[j + 1]}")
            scan_group.create_dataset("pose", data=seq_poses[j])
            scan_group.create_dataset("point_cloud", data=seq_point_clouds[j])


def read_scenes(filename: Path) -> Dict[str, List[np.ndarray]]:
    """`read_scenes` (`read_h5.py:17-49`): map poses, clouds and optional
    CLIP arrays, then the scans' poses and clouds, in the file's order."""
    h5py = _h5py(filename)
    with h5py.File(filename, "r") as file:
        map_poses, map_point_clouds, map_clip = [], [], []
        map_root = file["map"]
        for key in map_root.keys():
            map_group = map_root[key]
            for pose, pcl in zip(map_group["pose"].values(), map_group["point_cloud"].values()):
                map_poses.append(pose[()])
                map_point_clouds.append(pcl[()])
            if "clip" in map_group.keys():
                for clip in map_group["clip"].values():
                    map_clip.append(clip[()])

        scene_poses, scene_point_clouds = [], []
        scans_group = file["scans"]
        for scan in scans_group:
            scan_group = scans_group[scan]
            scene_poses.append(scan_group["pose"][()])
            scene_point_clouds.append(scan_group["point_cloud"][()])

    return {
        "map_poses": map_poses,
        "map_point_clouds": map_point_clouds,
        "map_clip": map_clip,
        "scene_poses": scene_poses,
        "scene_point_clouds": scene_point_clouds,
    }
