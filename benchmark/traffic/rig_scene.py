"""The descriptor pass's scene: a surround camera rig's images, the LiDAR
clouds around it and the ViT's weights, made from `--seed` (traffic files
with `"scene": "rig"`).

`batches` distinct batches of `batch` scans. A scan is one cloud of the
configuration's `n_scan` points around the rig and one image a camera of
`pipeline.synthetic.SyntheticCameraRig` (five pinhole cameras at 72-degree
steps, 90-degree field of view), at the traffic's `image_height` x
`image_width`, uint8 noise with the bottom `hood_rows` rows black (the
vehicle's hood). A cloud is drawn as `pipeline.synthetic.make_rig_cloud`
draws it: `ground_share` of the points on the ground `sensor_height_m`
below the sensor at a range in `range_m`, the rest structure up to
`structure_top_m` above the sensor at a range in `structure_range_m`, at a
uniform bearing. The images are the rig's own (its seed is `--seed`, each
image drawn from the seed and its file name) and are served from memory by
`ServedRig.read_images`, so that the window measures the pass and not the
noise generator.

The ViT's weights are drawn here too, from the seed on the run's device
(a CUDA generator on the card), in facebookresearch/dinov2's layout
(`hub_weights`), before any code of the program runs: the entry loads them
into the program through its checkpoint loader, and the plain reference
reads this copy.

What the plain reference takes as data besides the images and the weights:
the rig's calibration (each camera's LiDAR-to-camera extrinsic, the focal
length and the principal point, as a dataset's calibration files give
them), from which it projects the clouds itself. The entry's check reads
the covered points (seen by a camera whose pixel is not empty, the first
camera deciding) from `rig.coverage`, and keeps the descriptors of
`kept_rows` covered points a scan drawn from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig


class ServedRig(SyntheticCameraRig):
    """`SyntheticCameraRig` at the traffic's image size, whose `read_images`
    serves the images that `make_images` drew once."""

    def __init__(self, seed: int, height: int, width: int, hood_rows: int):
        self.height, self.width, self.hood_rows = height, width, hood_rows
        super().__init__(seed)
        self.images: Dict[str, np.ndarray] = {}

    def make_images(self, filenames) -> Dict[str, np.ndarray]:
        drawn = super().read_images(filenames)
        self.images.update({str(f): drawn[cam] for cam, f in zip(self.cameras, filenames)})
        return drawn

    def read_images(self, filenames) -> Dict[str, np.ndarray]:
        if len(filenames) != len(self.cameras):
            raise ValueError(f"{len(filenames)} files for {len(self.cameras)} cameras")
        return {cam: self.images[str(f)] for cam, f in zip(self.cameras, filenames)}


@dataclasses.dataclass
class RigScene:
    seed: int
    rig: ServedRig
    # Per batch: "files" [B][cameras], "clouds" [B] x [N, 3] f32, "covered" [B] x [N] bool,
    # "kept" [B] x [K] int64 (sorted covered rows).
    batches: List[Dict]
    # "extrinsics" [cameras, 4, 4] f64 (LiDAR -> camera, camera order), "focal", "principal_point" (cx, cy).
    calibration: Dict
    # The ViT's weights in facebookresearch/dinov2's layout (`hub_weights`).
    weights: Dict[str, torch.Tensor]


def hub_weights(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """Random weights of the configuration's ViT in facebookresearch/dinov2's
    layout (fused `attn.qkv`, `mlp.w12`, `mlp.w3`, `ls*.gamma`,
    `register_tokens`), drawn on `dev` from `seed` in one fixed order: dense
    weights N(0, 1/n_in); biases, LayerNorm shifts and the patch, cls,
    register and position embeddings N(0, 0.02^2); LayerNorm scales
    1 + N(0, 0.02^2); LayerScale the file's `layerscale_value`. Biases and
    norms are not left at 0 and 1, so that a weight loaded into another
    place shows."""
    d, p, f = cfg["hidden_size"], cfg["patch_size"], cfg["ffn_hidden_size"]
    grid = cfg["image_size"] // p
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(*shape, std=0.02, mean=0.0):
        return torch.empty(shape, dtype=torch.float32, device=dev).normal_(mean, std, generator=gen)

    w = {"patch_embed.proj.weight": normal(d, 3, p, p), "patch_embed.proj.bias": normal(d),
         "cls_token": normal(1, 1, d), "pos_embed": normal(1, 1 + grid * grid, d)}
    if cfg["num_register_tokens"]:
        w["register_tokens"] = normal(1, cfg["num_register_tokens"], d)
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        for name, n_out, n_in in (("attn.qkv", 3 * d, d), ("attn.proj", d, d), ("mlp.w12", 2 * f, d),
                                  ("mlp.w3", d, f)):
            w[f"{b}{name}.weight"] = normal(n_out, n_in, std=n_in**-0.5)
            w[f"{b}{name}.bias"] = normal(n_out)
        for name in ("norm1", "norm2"):
            w[f"{b}{name}.weight"], w[f"{b}{name}.bias"] = normal(d, mean=1.0), normal(d)
        for name in ("ls1", "ls2"):
            w[f"{b}{name}.gamma"] = torch.full((d,), float(cfg["layerscale_value"]), device=dev)
    w["norm.weight"], w["norm.bias"] = normal(d, mean=1.0), normal(d)
    return w


def rig_cloud(rng: np.random.Generator, n: int, traffic: Dict) -> np.ndarray:
    """[n, 3] f32 points around the rig (x forward, y left, z up)."""
    n_ground = int(n * traffic["ground_share"])
    r = np.r_[rng.uniform(*traffic["range_m"], n_ground), rng.uniform(*traffic["structure_range_m"], n - n_ground)]
    yaw = rng.uniform(0.0, 2.0 * np.pi, n)
    h = traffic["sensor_height_m"]
    z = np.r_[-h + rng.normal(0.0, 0.03, n_ground), rng.uniform(-h, traffic["structure_top_m"], n - n_ground)]
    return np.c_[r * np.cos(yaw), r * np.sin(yaw), z].astype(np.float32)


def make(cfg: Dict, traffic: Dict, seed: int, dev) -> RigScene:
    """The rig scene of a traffic file at the configuration's sizes (`n_scan`,
    `kept_rows`), with the ViT's weights on `dev`."""
    seed = int(seed)
    weights = hub_weights(cfg, seed, dev)
    rig = ServedRig(seed, traffic["image_height"], traffic["image_width"], traffic["hood_rows"])
    if traffic["cameras"] != len(rig.cameras):
        raise ValueError(f"the rig has {len(rig.cameras)} cameras, the traffic asks for {traffic['cameras']}")
    batches = []
    for k in range(traffic["batches"]):
        files, clouds, covered, kept = [], [], [], []
        for j in range(traffic["batch"]):
            rng = np.random.default_rng([seed, k, j])
            cloud = rig_cloud(rng, cfg["n_scan"], traffic)
            names = [f"batch{k}/scan{j}/{cam}.png" for cam in rig.cameras]
            images = rig.make_images(names)
            seen, first_empty = rig.coverage(cloud, images)
            cov = (seen > 0) & ~first_empty
            rows = np.flatnonzero(cov)
            kept.append(np.sort(rng.choice(rows, size=min(cfg["kept_rows"], rows.size), replace=False)))
            files.append(names)
            clouds.append(cloud)
            covered.append(cov)
        batches.append({"files": files, "clouds": clouds, "covered": covered, "kept": kept})
    calibration = {"extrinsics": np.stack([rig.extrinsics[cam] for cam in rig.cameras]),
                   "focal": float(rig.focal), "principal_point": tuple(float(c) for c in rig.principal_point)}
    return RigScene(seed, rig, batches, calibration, weights)
