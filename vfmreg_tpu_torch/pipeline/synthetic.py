"""A seeded synthetic scene in the evaluation driver's layout.

A numpy copy of `bench.py:_make_synthetic_scene` (`:156-201`), the scene of
the reference's driver benchmark, with the same seed semantics: one world map
with descriptors and `batch` query scans in their own local frames, each
sampling a 30 m-radius region of a ground-dominated world (70 % ground
returns), with the stored GT poses carrying a release GT's 0.2-0.5 m /
0.5-2 deg noise. It also returns each scan's true pose (a translation to its
region's centre), which the copy in `bench.py` drops.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
