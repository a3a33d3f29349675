"""Seeded synthetic inputs: the evaluation driver's scene and a camera rig.

A numpy copy of `bench.py:_make_synthetic_scene` (`:156-201`), the scene of
the reference's driver benchmark, with the same seed semantics: one world map
with descriptors and `batch` query scans in their own local frames, each
sampling a 30 m-radius region of a ground-dominated world (70 % ground
returns), with the stored GT poses carrying a release GT's 0.2-0.5 m /
0.5-2 deg noise. It also returns each scan's true pose (a translation to its
region's centre), which the copy in `bench.py` drops.

`scene_file_layout` puts that scene in the layout of a processed scene file
for `RegistrationNode.run_scene`. Run as a script to register a small
synthetic scene through the batched method row and print the recall table:

    python -m vfmreg_tpu_torch.pipeline.synthetic [--device cpu]

`SyntheticCameraRig` and `make_rig_cloud` feed the descriptor pass
(`pipeline/prepare_scenes.create_descriptors`): five seeded camera images per
cloud and their projections, in place of a dataset sequence.

`SyntheticDrive` feeds the KISS odometry (`kiss.kiss_icp.KissICP`): the
reference example's corridor (`examples/odometry_corridor.py`), scaled out
to a street drive with KITTI-sized sweeps.
"""

from __future__ import annotations

import argparse
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vfmreg_tpu_torch.config import MAX_RANGE

# SyntheticDrive: 1 m a frame (KITTI's ~10 m/s at its 10 Hz sweep rate), a
# yaw rate of up to 2 deg a frame, and each return's range off by a normal
# error of 2 cm (the HDL-64E's stated range accuracy, under 2 cm: Velodyne
# HDL-64E S2 data sheet).
DRIVE_STEP_M, DRIVE_MAX_YAW_DEG, DRIVE_RANGE_SIGMA_M = 1.0, 2.0, 0.02


def make_synthetic_scene(
    batch: int, n_map: int, n_scan: int, d: int, seed: int = 0, extent: float = 100.0
) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """(scene, local_map, true_poses): `scene` holds "scene_poses" (noisy
    4x4 f64 GT poses) and "scene_point_clouds" ([n, 3 + d] f32 scans),
    `local_map` is [n_map, 3 + d] f32, `true_poses` [batch, 4, 4] f64."""
    rng = np.random.RandomState(seed)
    n_ground = int(n_map * 0.7)
    xy = rng.uniform(-extent, extent, (n_map, 2))
    z = np.concatenate([rng.uniform(0, 0.3, n_ground), rng.uniform(0, 8, n_map - n_ground)])
    mp = np.c_[xy, z[rng.permutation(n_map)]].astype(np.float32)
    W = rng.normal(size=(3, d)).astype(np.float32)
    mf = np.sin(mp @ W * 0.1).astype(np.float32)
    local_map = np.c_[mp, mf]

    scene_poses, scene_clouds, true_poses = [], [], []
    for _ in range(batch):
        center = rng.uniform(-extent * 0.4, extent * 0.4, 2)
        near = np.flatnonzero(np.linalg.norm(mp[:, :2] - center, axis=1) < 30.0)
        sel = rng.choice(near, min(n_scan, near.size), replace=False)
        pts = mp[sel] + rng.normal(0, 0.02, (sel.size, 3)).astype(np.float32)

        T = np.eye(4)
        T[:2, 3] = center
        local = (pts - T[:3, 3]).astype(np.float32)

        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.deg2rad(rng.uniform(0.5, 2.0))
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        Rn = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        noisy = T.copy()
        noisy[:3, :3] = Rn @ T[:3, :3]
        t_dir = rng.normal(size=3)
        noisy[:3, 3] += t_dir / np.linalg.norm(t_dir) * rng.uniform(0.2, 0.5)

        scene_poses.append(noisy)
        scene_clouds.append(np.c_[local, mf[sel]])
        true_poses.append(T)
    scene = {"scene_poses": scene_poses, "scene_point_clouds": scene_clouds}
    return scene, local_map, np.stack(true_poses)


def _positive_descriptors(cloud: np.ndarray) -> np.ndarray:
    """The rows whose descriptor sum is not positive, negated. The driver's
    map accumulation drops such rows as points without a descriptor
    (`RegistrationNode._accumulate_map`); a negated row sums to exactly
    minus the sum (negation is exact at every rounding step)."""
    flip = np.sum(cloud[:, 3:], axis=1) <= 0
    out = cloud.copy()
    out[flip, 3:] = -out[flip, 3:]
    return out


def scene_file_layout(scene: Dict, local_map: np.ndarray) -> Dict:
    """`make_synthetic_scene`'s output in the layout of a processed scene
    file (`data.h5io.read_scenes`): "map_point_clouds" / "map_poses" (the
    map split at x = 0 into two map clouds), "map_clip" (empty),
    "scene_point_clouds" / "scene_poses".

    `sin(p W 0.1)` descriptors sum to a negative for about half the points,
    which the driver's map accumulation drops; so every descriptor row whose
    sum is not positive is negated, in the map and in the scans alike (a
    scan row is a copy of its map row, so each pair keeps its cosine).

    The map clouds are posed at the identity: a cloud in a frame of its own
    is voxelized there first, and a frame offset moves the 0.25 m voxel
    boundaries (truncation makes the voxel at 0 twice as wide), so the
    accumulated map would no longer hold one point per occupied 0.25 m
    voxel of the world map."""
    mp = _positive_descriptors(local_map)
    left = mp[:, 0] < 0
    return {
        "map_poses": [np.eye(4), np.eye(4)],
        "map_point_clouds": [mp[left], mp[~left]],
        "map_clip": [],
        "scene_poses": [np.asarray(p, dtype=np.float64) for p in scene["scene_poses"]],
        "scene_point_clouds": [_positive_descriptors(c) for c in scene["scene_point_clouds"]],
    }


class SyntheticCameraRig:
    """A seeded surround-view camera rig for the descriptor pass.

    Five pinhole cameras at 72-degree steps around the vehicle, each with a
    90-degree horizontal field of view, so neighbouring cameras overlap by
    18 degrees (a point seen by two cameras takes the first one's
    descriptor). It offers what `create_descriptors` reads of a dataset
    sequence: `read_images(filenames=...)`, one image per camera in camera
    order, and `project_pcl_to_image(pcl_h, image, camera)` with the
    RobotCar loader's semantics (`vfmreg_tpu/data/oxford_robotcar.py`):
    depth strictly above 0, u = f x / z + c, and pixels at or beyond the
    width or height cut. Images are uint8 noise made from the seed and the
    file name, with the bottom rows black (the vehicle's own hood), so that
    the empty-pixel rule runs. Numpy only, so both packages can use it.
    """

    cameras = ("cam0", "cam1", "cam2", "cam3", "cam4")
    height, width = 1232, 1616  # RobotCar's image size
    hfov_deg = 90.0
    hood_rows = 185  # the bottom 15 % of the image

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.focal = (self.width / 2.0) / np.tan(np.deg2rad(self.hfov_deg) / 2.0)
        self.principal_point = (self.width / 2.0, self.height / 2.0)
        self.extrinsics = {}  # LiDAR frame (x forward, y left, z up) -> camera (x right, y down, z forward)
        for i, cam in enumerate(self.cameras):
            yaw = 2.0 * np.pi * i / len(self.cameras)
            fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            R = np.stack([np.array([np.sin(yaw), -np.cos(yaw), 0.0]), np.array([0.0, 0.0, -1.0]), fwd])
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ (0.3 * fwd)
            self.extrinsics[cam] = E

    def read_images(self, filenames) -> Dict[str, np.ndarray]:
        """{camera: [height, width, 3] uint8}, the i-th file for the i-th camera."""
        if len(filenames) != len(self.cameras):
            raise ValueError(f"{len(filenames)} files for {len(self.cameras)} cameras")
        images = {}
        for cam, name in zip(self.cameras, filenames):
            rng = np.random.default_rng([self.seed, zlib.crc32(str(name).encode())])
            img = rng.integers(0, 256, (self.height, self.width, 3), dtype=np.uint8)
            img[self.height - self.hood_rows :] = 0
            images[cam] = img
        return images

    def project_pcl_to_image(self, pcl, image, camera: str):
        """Homogeneous LiDAR points [4, N] -> (u, v, indices) of the points
        that land in `image`."""
        pc = self.extrinsics[camera] @ pcl
        in_front = np.flatnonzero(pc[2, :] > 0)
        p = pc[:, in_front]
        u = self.focal * p[0, :] / p[2, :] + self.principal_point[0]
        v = self.focal * p[1, :] / p[2, :] + self.principal_point[1]
        outlier = (u < 0) | (u >= image.shape[1]) | (v < 0) | (v >= image.shape[0])
        return u[~outlier].astype(int), v[~outlier].astype(int), in_front[~outlier]

    def coverage(self, pcl: np.ndarray, images: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """(seen [N] int, first_empty [N] bool): how many cameras see each
        point of `pcl` [N, 3], and whether the first of them sees it on an
        empty pixel. The points that get a descriptor are seen > 0 and not
        first_empty."""
        pcl_h = np.insert(pcl, 3, values=1, axis=1).T
        seen = np.zeros(pcl.shape[0], dtype=np.int64)
        first_empty = np.zeros(pcl.shape[0], dtype=bool)
        for cam, img in images.items():
            u, v, idx = self.project_pcl_to_image(pcl_h, img, cam)
            empty = np.all(img[v, u] == 0, axis=-1)
            first_empty[idx[(seen[idx] == 0) & empty]] = True
            seen[idx] += 1
        return seen, first_empty


def make_rig_cloud(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] f32 LiDAR points around the rig: 60 % ground returns 1.7 m
    below the sensor within 1-40 m, the rest structure up to 6 m above it
    within 3-40 m. Some fall under the hood, some above every camera's view."""
    rng = np.random.RandomState(seed)
    n_ground = int(n * 0.6)
    r = np.r_[rng.uniform(1.0, 40.0, n_ground), rng.uniform(3.0, 40.0, n - n_ground)]
    yaw = rng.uniform(0.0, 2.0 * np.pi, n)
    z = np.r_[-1.7 + rng.normal(0.0, 0.03, n_ground), rng.uniform(-1.7, 6.0, n - n_ground)]
    return np.c_[r * np.cos(yaw), r * np.sin(yaw), z].astype(np.float32)


class SyntheticDrive:
    """A seeded drive through a synthetic street, for the odometry.

    The reference example's `CorridorDataset` scaled out: one fixed world
    of ground (z in [0, 0.1] m), facade panels 11-14 m to each side of the
    road with gaps, a pole every 12 m on each side, and boxes of 4-20 m (walls
    4-15 m high) set back from the road. The vehicle drives DRIVE_STEP_M a
    frame with a yaw rate of up to DRIVE_MAX_YAW_DEG a frame (a slow sine, so
    the road winds), its sensor 1.8 m above the ground. The world's frame is
    the first sensor pose's, as an odometry's. Frame i is `n_points` world
    points within MAX_RANGE of that sensor, drawn without replacement
    (seed, frame), in the sensor's frame, each moved along its ray by a
    normal range error of DRIVE_RANGE_SIGMA_M drawn from (seed, frame), f32:
    122,880 points is a KITTI HDL-64E sweep. With d > 0 each point carries d
    descriptor columns, a smooth function of its world position (the
    example's sin(p W * 0.2)); every 11th world point's is zero. `gt_poses`
    [n, 4, 4] f64, the first the identity."""

    def __init__(self, n_frames: int = 200, n_points: int = 122880, d: int = 0, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.n_points, self.d, self.seed = n_points, d, seed
        yaw = np.deg2rad(DRIVE_MAX_YAW_DEG) * np.sin(2 * np.pi * np.arange(n_frames) / 67.0)
        heading = np.concatenate([[0.0], np.cumsum(yaw[:-1])])
        xy = np.zeros((n_frames, 2))
        for i in range(1, n_frames):
            xy[i] = xy[i - 1] + DRIVE_STEP_M * np.array([np.cos(heading[i - 1]), np.sin(heading[i - 1])])
        self.gt_poses = np.tile(np.eye(4), (n_frames, 1, 1))
        c, s_ = np.cos(heading), np.sin(heading)
        self.gt_poses[:, 0, 0], self.gt_poses[:, 0, 1], self.gt_poses[:, 1, 0], self.gt_poses[:, 1, 1] = c, -s_, s_, c
        self.gt_poses[:, :2, 3] = xy
        self.gt_poses[:, 2, 3] = 1.8

        lo, hi = xy.min(axis=0) - MAX_RANGE - 5.0, xy.max(axis=0) + MAX_RANGE + 5.0
        area = float(np.prod(hi - lo))
        parts = [np.c_[rng.uniform(lo, hi, (int(5.0 * area), 2)), rng.uniform(0.0, 0.1, int(5.0 * area))]]
        # Road-side facades and poles, along the path (every 3rd frame's pose).
        for i in range(0, n_frames, 3):
            fwd, left = np.array([c[i], s_[i]]), np.array([-s_[i], c[i]])
            for side in (-1.0, 1.0):
                if rng.rand() < 0.8:  # a facade panel, or a gap
                    n = 900
                    off = side * rng.uniform(11.0, 14.0)
                    along = rng.uniform(-2.0, 2.0, n)
                    pts = xy[i] + np.outer(along, fwd) + off * left
                    parts.append(np.c_[pts, rng.uniform(0.0, 8.0, n)])
                if i % 12 == 0:
                    n = 240
                    a = rng.uniform(0, 2 * np.pi, n)
                    base = xy[i] + side * 8.0 * left
                    parts.append(np.c_[base + 0.15 * np.c_[np.cos(a), np.sin(a)], rng.uniform(0.0, 6.0, n)])
        # Boxes set back from the road: four walls each.
        centers = rng.uniform(lo, hi, (600, 2))
        dist = np.min(np.linalg.norm(centers[:, None] - xy[None, ::5], axis=-1), axis=1)
        for (cx, cy), w, h, height, ang in zip(centers[dist > 25.0], rng.uniform(4, 20, 600),
                                               rng.uniform(4, 20, 600), rng.uniform(4, 15, 600),
                                               rng.uniform(0, np.pi, 600)):
            n = int(0.6 * 2 * (w + h) * height)
            t = rng.uniform(0, 2 * (w + h), n)
            u = np.where(t < w, t, np.where(t < w + h, w, np.where(t < 2 * w + h, 2 * w + h - t, 0.0)))
            v = np.where(t < w, 0.0, np.where(t < w + h, t - w, np.where(t < 2 * w + h, h, 2 * (w + h) - t)))
            R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
            pts = (np.c_[u - w / 2, v - h / 2] @ R.T) + [cx, cy]
            parts.append(np.c_[pts, rng.uniform(0.0, height, n)])
        # World coordinates are the first sensor pose's: it is the identity.
        self.world = (np.concatenate(parts) - [0.0, 0.0, 1.8]).astype(np.float32)
        self.gt_poses[:, 2, 3] = 0.0
        self._W = rng.normal(size=(3, d)).astype(np.float32) if d else None

    def __len__(self) -> int:
        return self.gt_poses.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        T = self.gt_poses[i]
        rel = self.world - T[:3, 3].astype(np.float32)
        near = np.flatnonzero(np.einsum("ij,ij->i", rel, rel) < np.float32(MAX_RANGE**2))
        rng = np.random.RandomState([self.seed, i])
        sel = np.sort(rng.choice(near, self.n_points, replace=near.size < self.n_points))
        frame = (self.world[sel].astype(np.float64) - T[:3, 3]) @ T[:3, :3]
        r = np.maximum(np.linalg.norm(frame, axis=1), 1e-6)
        frame = (frame * (1.0 + rng.normal(0.0, DRIVE_RANGE_SIGMA_M, r.shape) / r)[:, None]).astype(np.float32)
        if not self.d:
            return frame
        feats = np.sin(self.world[sel] @ self._W * np.float32(0.2)).astype(np.float32)
        feats[sel % 11 == 0] = 0.0
        return np.c_[frame, feats]


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Register a small synthetic scene through the batched method row and
    print the recall table."""
    from vfmreg_tpu_torch.pipeline import registration_node as rn
    from vfmreg_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scene, local_map, _ = make_synthetic_scene(3, 32768, 2048, 24, seed=0)
    res = rn.precompute_scene_batched(scene, local_map, device=dev)
    print(f"corr_counts: {res['corr_counts']}  snap_counts: {res['snap_counts']}  "
          f"retried: {res['retried']}  GN iterations: {res['stats']['iterations']}")
    print(rn.format_recall_table(rn.recall_table(rn.method_errors(res))))


if __name__ == "__main__":
    main()
