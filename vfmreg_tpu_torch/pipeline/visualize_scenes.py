"""Scene visualizer: `visualize_scenes.py` without Open3D.

Counterpart of `vfmreg_tpu/pipeline/visualize_scenes.py` (host numpy).
Renders the voxelized map (blue) against the GT-posed query scans (red),
z-flipped as the reference shows them, to a matplotlib 3-D scatter
(interactive or PNG; matplotlib is imported only then), and exports ASCII
PLY files for other viewers. The node's `--dump-viz` writes its files with
`write_ply` and `write_ply_segments`.

    python -m vfmreg_tpu_torch.pipeline.visualize_scenes FOLDER [--png-dir D] [--ply-dir D] [--show]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from vfmreg_tpu_torch.data.h5io import read_scenes
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.utils.pcl import transform_pcl


def write_ply(path: Path, points: np.ndarray, color=(128, 128, 128)) -> None:
    """An ASCII PLY of the points, one colour for all."""
    path = Path(path)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {points.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        r, g, b = color
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")


def write_ply_segments(
    path: Path,
    src: np.ndarray,
    tgt: np.ndarray,
    src_color=(230, 60, 60),
    tgt_color=(60, 60, 230),
) -> None:
    """Correspondences as coloured segment pairs, one edge per (src, tgt)
    row: the ROS-free equivalent of the reference's correspondence
    MarkerArray (`vfm_reg/utils.py:195-226`)."""
    path = Path(path)
    n = src.shape[0]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {2 * n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element edge {n}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        for pts, (r, g, b) in ((src, src_color), (tgt, tgt_color)):
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
        for k in range(n):
            f.write(f"{k} {k + n}\n")


def visualize_scene(
    scene_file: Path,
    voxel_size: float = 0.25,
    save_png: Optional[Path] = None,
    export_ply_dir: Optional[Path] = None,
    max_points: int = 200000,
    show: bool = False,
):
    """(map points, scan points) of a scene file as drawn: the map clouds
    voxelized, posed and voxelized again, the scans voxelized and posed,
    z-flipped, subsampled to `max_points` (a quarter of it for the scans)
    with `RandomState(0)`; written as PLYs to `export_ply_dir` and drawn to
    `save_png` or the screen."""
    scene = read_scenes(scene_file)

    parts = []
    for pose, pcl in zip(scene["map_poses"], scene["map_point_clouds"]):
        pcl = voxel_down_sample(pcl[:, :3], voxel_size)
        parts.append(transform_pcl(pcl, pose))
    map_pts = voxel_down_sample(np.concatenate(parts), voxel_size)

    scan_parts = []
    for pose, pcl in zip(scene["scene_poses"], scene["scene_point_clouds"]):
        scan_parts.append(transform_pcl(voxel_down_sample(pcl[:, :3], voxel_size), pose))
    scan_pts = np.concatenate(scan_parts) if scan_parts else np.zeros((0, 3))

    map_pts = map_pts * np.array([1, 1, -1])
    scan_pts = scan_pts * np.array([1, 1, -1])

    rng = np.random.RandomState(0)
    if map_pts.shape[0] > max_points:
        map_pts = map_pts[rng.choice(map_pts.shape[0], max_points, replace=False)]
    if scan_pts.shape[0] > max_points // 4:
        scan_pts = scan_pts[rng.choice(scan_pts.shape[0], max_points // 4, replace=False)]

    if export_ply_dir is not None:
        export_ply_dir = Path(export_ply_dir)
        export_ply_dir.mkdir(parents=True, exist_ok=True)
        write_ply(export_ply_dir / f"{Path(scene_file).stem}_map.ply", map_pts, (60, 90, 220))
        write_ply(export_ply_dir / f"{Path(scene_file).stem}_scans.ply", scan_pts, (220, 60, 60))

    if save_png is not None or show:
        import matplotlib

        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 10))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(map_pts[:, 0], map_pts[:, 1], map_pts[:, 2], s=0.2, c="tab:blue", alpha=0.4)
        if scan_pts.shape[0]:
            ax.scatter(scan_pts[:, 0], scan_pts[:, 1], scan_pts[:, 2], s=0.5, c="tab:red")
        ax.set_title(Path(scene_file).name)
        if save_png is not None:
            fig.savefig(save_png, dpi=120, bbox_inches="tight")
        if show:
            plt.show()
        plt.close(fig)
    return map_pts, scan_pts


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("folder", type=str)
    parser.add_argument("--png-dir", type=str, default=None)
    parser.add_argument("--ply-dir", type=str, default=None)
    parser.add_argument("--show", action="store_true")
    args = parser.parse_args(argv)

    folder = Path(args.folder)
    files = sorted(folder.glob("scene_*.h5")) if folder.is_dir() else [folder]
    for f in files:
        png = Path(args.png_dir) / f"{f.stem}.png" if args.png_dir else None
        if png is not None:
            png.parent.mkdir(parents=True, exist_ok=True)
        visualize_scene(f, save_png=png, export_ply_dir=args.ply_dir, show=args.show)
        print(f"visualized {f.name}")


if __name__ == "__main__":
    main()
