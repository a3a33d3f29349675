"""Scene preparation: the offline descriptor pass.

Counterpart of `vfmreg_tpu/pipeline/prepare_scenes.py:create_descriptors`:
per point cloud, DINOv2 patch features for each surround camera, the cloud
projected into each camera, per-point descriptors sampled from the patch grid
at the projected pixels (`ops/projection.sample_patch_features`), zeros where
the image pixel is empty, the first camera winning where several see a
point, and zero rows for points no camera sees.

NCLT's rotated cameras, `prepare_scene` and `main` wait for the dataset
loaders and the HDF5 writer (ROADMAP A11b).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vfmreg_tpu_torch.ops.projection import sample_patch_features


def create_descriptors(image_files, sequence, feature_generator, pcl: np.ndarray) -> np.ndarray:
    """[N, D] f32 descriptors of the points `pcl` [N, 3] from the images
    `sequence.read_images(filenames=image_files)`; zeros for uncovered points.

    `feature_generator` is a `models.image_features.ImageFeatureGenerator`;
    the patch sampling runs on its device. `sequence` projects with
    `project_pcl_to_image(pcl_h, image, camera)` (a dataset loader, or
    `pipeline.synthetic.SyntheticCameraRig`)."""
    if type(sequence).__name__ == "NCLT":
        raise NotImplementedError("NCLT's rotated cameras wait for the NCLT loader (ROADMAP A11b)")
    dev = feature_generator.device
    images = sequence.read_images(filenames=image_files)
    pcl_h = np.insert(pcl, 3, values=1, axis=1).T  # 4 x N homogeneous

    indices: List[np.ndarray] = []
    features: List[np.ndarray] = []
    for camera, image in images.items():
        patch_feats = feature_generator.get_image_features(image, upsample=False)
        u, v, idx = sequence.project_pcl_to_image(pcl_h, image, camera)
        if len(idx) == 0:
            continue
        feats = sample_patch_features(
            torch.from_numpy(patch_feats).to(dev), torch.from_numpy(u).to(dev),
            torch.from_numpy(v).to(dev), image.shape[0], image.shape[1],
        ).cpu().numpy()
        feats[np.all(image[v, u] == 0, axis=-1)] = 0.0  # empty pixels
        indices.append(idx)
        features.append(feats)

    descriptors = np.zeros((pcl.shape[0], feature_generator.feature_size), dtype=np.float32)
    if not indices:
        return descriptors
    # Several cameras may see a point: the first occurrence wins, on the host
    # as in the reference (a scatter with duplicate indices has no defined
    # winner on the card).
    all_idx = np.concatenate(indices)
    _, first = np.unique(all_idx, return_index=True)
    descriptors[all_idx[first]] = np.concatenate(features)[first]
    return descriptors
