"""Scene preparation: the offline descriptor pass.

Counterpart of `vfmreg_tpu/pipeline/prepare_scenes.py`:

* `create_descriptors`: per point cloud, the foundation model's patch
  features for each surround camera, the cloud projected into each camera,
  per-point descriptors sampled from the patch grid at the projected pixels
  (`ops/projection.sample_patch_features`), zeros where the image pixel is
  empty, the first camera winning where several see a point, and zero rows
  for points no camera sees. NCLT's images are stored rotated 90 degrees
  clockwise while its projection works in the unrotated frame, so for an
  `data.nclt.NCLT` sequence the image and the patch grid are rotated back
  (`np.rot90`, which equals cv2's 90-degree counter-clockwise rotation).
* `prepare_scene`: a dataset folder and a scene spec -> voxel-downsampled
  map clouds (0.2 m) and registration clouds (0.1 m) with their
  descriptors and poses, written through `data/h5io.save_scene`.
* `main`: the reference's CLI over a folder of scene specs (or one spec).

The module imports without `cv2`, `PIL` and `h5py`; reading NCLT or
RobotCar images and writing the HDF5 need them.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List

import numpy as np
import torch

from vfmreg_tpu_torch.data.h5io import save_scene
from vfmreg_tpu_torch.data.nclt import NCLT
from vfmreg_tpu_torch.data.oxford_robotcar import OxfordRobotcar
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator
from vfmreg_tpu_torch.ops.projection import sample_patch_features
from vfmreg_tpu_torch.utils.profiling import span


def create_descriptors(image_files, sequence, feature_generator, pcl: np.ndarray, timer=None) -> np.ndarray:
    """[N, D] f32 descriptors of the points `pcl` [N, 3] from the images
    `sequence.read_images(filenames=image_files)`; zeros for uncovered points.

    `feature_generator` is a `models.image_features.ImageFeatureGenerator`;
    the patch sampling runs on its device. `sequence` projects with
    `project_pcl_to_image(pcl_h, image, camera)` (a dataset loader, or
    `pipeline.synthetic.SyntheticCameraRig`). Spans: the call is
    `vfmreg.descriptors`, each image's forward `vfmreg.vit`, and each
    image's projection and sampling, and the first-camera scatter,
    `vfmreg.descriptors.assemble`; a `utils.profiling.Timer` as `timer`
    clocks them."""
    dev = feature_generator.device
    with span("descriptors", timer, dev):
        images = sequence.read_images(filenames=image_files)
        is_nclt = isinstance(sequence, NCLT)
        pcl_h = np.insert(pcl, 3, values=1, axis=1).T  # 4 x N homogeneous

        indices: List[np.ndarray] = []
        features: List[np.ndarray] = []
        for camera, image in images.items():
            patch_feats = feature_generator.get_image_features(image, upsample=False, timer=timer)
            with span("descriptors.assemble", timer, dev):
                if is_nclt:
                    # Project in the unrotated frame: the image and its patch
                    # grid rotated back counter-clockwise.
                    image = np.rot90(image, k=1, axes=(0, 1))
                    patch_feats = np.ascontiguousarray(np.rot90(patch_feats, k=1, axes=(0, 1)))
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

        with span("descriptors.assemble", timer, dev):
            descriptors = np.zeros((pcl.shape[0], feature_generator.feature_size), dtype=np.float32)
            if not indices:
                return descriptors
            # Several cameras may see a point: the first occurrence wins, on
            # the host as in the reference (a scatter with duplicate indices
            # has no defined winner on the card).
            all_idx = np.concatenate(indices)
            _, first = np.unique(all_idx, return_index=True)
            descriptors[all_idx[first]] = np.concatenate(features)[first]
            return descriptors


def prepare_scene(dataset_dir: Path, scene_file: Path, output_dir: Path, feature_generator=None) -> Path:
    """One scene spec -> `<output_dir>/<spec name>.h5` (the reference's
    `prepare_scene`); returns the file's path. The dataset is chosen by the
    folder's name ("nclt" or "robotcar"); `feature_generator` defaults to
    random-weight DINOv2 ViT-S/14 on the card."""
    dataset_dir = Path(dataset_dir)
    if "nclt" in dataset_dir.name:
        dataset, date_idx = NCLT, 1
    elif "robotcar" in dataset_dir.name:
        dataset, date_idx = OxfordRobotcar, 0
    else:
        raise ValueError("Unknown dataset")
    if feature_generator is None:
        feature_generator = ImageFeatureGenerator("dinov2", use_featup=False)

    with open(scene_file, "r") as f:
        scene_data = json.load(f)

    # The reference indexes the file list at date_idx, which assumes at
    # least two mapping clouds; clamped so that one-cloud scenes work too.
    map_files = scene_data["mapping"]["point_clouds"]
    sequences = [map_files[min(date_idx, len(map_files) - 1)].split("/")[1]]
    for seq in scene_data["registration"]:
        sequences.append(seq["point_cloud"].split("/")[date_idx])

    map_sequence = dataset(sequences[0], dataset_dir, high_level_api=True)
    map_point_clouds = []
    for i, pcl_file in enumerate(map_files):
        pcl = map_sequence.read_pcl(filename=dataset_dir / pcl_file)
        pcl = voxel_down_sample(pcl, 0.2).astype(pcl.dtype)
        image_files = [dataset_dir / f for f in scene_data["mapping"]["images"][i]]
        descriptors = create_descriptors(image_files, map_sequence, feature_generator, pcl)
        map_point_clouds.append(np.c_[pcl, descriptors])
    map_poses = [np.array(p) for p in scene_data["mapping"]["poses"]]

    seq_point_clouds, seq_poses = [], []
    for i, registration in enumerate(scene_data["registration"]):
        reg_sequence = dataset(sequences[i + 1], dataset_dir, high_level_api=True)
        pcl = reg_sequence.read_pcl(filename=dataset_dir / registration["point_cloud"])
        pcl = voxel_down_sample(pcl, 0.1).astype(pcl.dtype)
        image_files = [dataset_dir / f for f in registration["images"]]
        descriptors = create_descriptors(image_files, reg_sequence, feature_generator, pcl)
        seq_point_clouds.append(np.c_[pcl, descriptors])
        seq_poses.append(np.array(registration["pose"]))

    output_filename = Path(output_dir) / Path(scene_file).name.replace(".json", ".h5")
    save_scene(output_filename, sequences, map_poses, map_point_clouds, seq_poses, seq_point_clouds)
    return output_filename


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset_folder", type=str)
    parser.add_argument("scene_folder", type=str)
    parser.add_argument("--output_folder", type=str, required=False, default=None)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dataset_dir = Path(args.dataset_folder)
    scene_dir = Path(args.scene_folder)
    if args.output_folder is not None:
        output_dir = Path(args.output_folder)
    elif args.scene_folder.endswith(".json"):
        output_dir = scene_dir.parent / "processed_scenes"
    else:
        output_dir = scene_dir / "processed_scenes"

    scene_files = [scene_dir] if args.scene_folder.endswith(".json") else sorted(scene_dir.glob("*.json"))
    print(f"Found {len(scene_files)} scene file(s).")
    generator = ImageFeatureGenerator("dinov2", use_featup=False, device=args.device)
    for scene_file in scene_files:
        prepare_scene(dataset_dir, scene_file, output_dir, feature_generator=generator)


if __name__ == "__main__":
    main()
