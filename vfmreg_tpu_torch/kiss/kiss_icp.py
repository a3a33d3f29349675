"""The KissICP odometry class: counterpart of `vfmreg_tpu/kiss/kiss_icp.py`
(`kiss_icp/kiss_icp.py:36-122`).

Per frame, on the host: range crop, then the double voxelization (0.5 v for
the map, 1.5 v for the registration source), the adaptive sigma and the
constant-velocity guess; then `register_frame` against the map on its device
(3-D, or with `use_descriptors` the XD cosine-weighted path, as the
reference's odometry server's v2 mode; never VFM-ICP), and the map update,
skipped when the motion is below `map_update_threshold`. Descriptor clouds
are cropped and voxelized on xyz plus a row index, and their descriptor
columns gathered back (`kiss_icp.py:54-76`). As in the reference, the
motion compensator is built from the config but not applied here.
"""

from __future__ import annotations

import numpy as np

from vfmreg_tpu_torch.config import KISSConfig
from vfmreg_tpu_torch.kiss.deskew import get_motion_compensator
from vfmreg_tpu_torch.kiss.mapping import get_voxel_hash_map
from vfmreg_tpu_torch.kiss.preprocess import get_preprocessor
from vfmreg_tpu_torch.kiss.registration import register_frame
from vfmreg_tpu_torch.kiss.threshold import get_threshold_estimator
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample


class KissICP:
    def __init__(self, config: KISSConfig, map_update_threshold: float = 0.0, device=None):
        self.poses = []
        self.config = config
        self.compensator = get_motion_compensator(config)
        self.adaptive_threshold = get_threshold_estimator(config)
        self.local_map = get_voxel_hash_map(config, device=device)
        self.preprocess = get_preprocessor(config)
        self.map_update_threshold = map_update_threshold

    def _with_columns(self, frame: np.ndarray, step):
        """`step` run on xyz plus a row index; the other columns gathered back."""
        if frame.shape[1] == 3:
            return step(frame)
        xyzi = np.c_[frame[:, :3], np.arange(frame.shape[0], dtype=frame.dtype)]
        out = step(xyzi)
        out = out if isinstance(out, tuple) else (out,)
        back = tuple(np.c_[o[:, :3], frame[o[:, 3].astype(int), 3:]] for o in out)
        return back if len(back) > 1 else back[0]

    def register_frame(self, frame: np.ndarray, timestamps, use_descriptors: bool = False):
        """(pose [4, 4] f64, the frame's 0.5 v downsample, whether the map was updated)."""
        frame = self._with_columns(np.asarray(frame), self.preprocess)
        source, frame_downsample = self._with_columns(frame, self.voxelize)
        original_frame_downsample = frame_downsample
        if not use_descriptors:
            source = source[:, :3]
            original_frame_downsample = frame_downsample.copy()
            frame_downsample = frame_downsample[:, :3]

        sigma = self.get_adaptive_threshold()
        prediction = self.get_prediction_model()
        last_pose = self.poses[-1] if self.poses else np.eye(4)
        initial_guess = last_pose @ prediction

        new_pose = register_frame(
            points=source,
            voxel_map=self.local_map,
            initial_guess=initial_guess,
            max_correspondance_distance=3 * sigma,
            kernel=sigma / 3,
            force_xd=use_descriptors,
        )

        # The map update, gated by motion (`kiss_icp.py:104-111`).
        motion = np.linalg.inv(last_pose) @ new_pose
        if np.linalg.norm(motion[:3, -1]) < self.map_update_threshold and len(self.poses) > 1:
            return new_pose, original_frame_downsample, False
        self.adaptive_threshold.update_model_deviation(np.linalg.inv(initial_guess) @ new_pose)
        self.local_map.update(frame_downsample, new_pose)
        self.poses.append(new_pose)
        return new_pose, original_frame_downsample, True

    def voxelize(self, iframe: np.ndarray):
        """Double downsample: 0.5 v map cloud, 1.5 v source (`kiss_icp.py:114-120`)."""
        frame_downsample = voxel_down_sample(iframe, self.config.mapping.voxel_size * 0.5)
        source = voxel_down_sample(frame_downsample, self.config.mapping.voxel_size * 1.5)
        return source, frame_downsample

    def get_adaptive_threshold(self) -> float:
        if not self.has_moved():
            return self.config.adaptive_threshold.initial_threshold
        return self.adaptive_threshold.get_threshold()

    def get_prediction_model(self) -> np.ndarray:
        if len(self.poses) < 2:
            return np.eye(4)
        return np.linalg.inv(self.poses[-2]) @ self.poses[-1]

    def has_moved(self) -> bool:
        if len(self.poses) < 1:
            return False
        motion = np.linalg.inv(self.poses[0]) @ self.poses[-1]
        return float(np.linalg.norm(motion[:3, 3])) > 5 * self.config.adaptive_threshold.min_motion_th
