"""OdometryPipeline: counterpart of `vfmreg_tpu/kiss/pipeline.py` (`kiss_icp/pipeline.py:40-207`).

Runs KissICP over a dataset (any indexable yielding [N, 3 (+ D)] frames or
(frame, timestamps) tuples) on `device` (default: the card), evaluates the
KITTI sequence error, the ATE and the frame rate, and writes the poses as
npy, KITTI and TUM text, the config (needs `yaml`) and a results log under
`config.out_dir/<date>/` with a `latest` link.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from vfmreg_tpu_torch.config import load_config, write_config
from vfmreg_tpu_torch.geometry.metrics import absolute_trajectory_error, seq_error
from vfmreg_tpu_torch.kiss.kiss_icp import KissICP
from vfmreg_tpu_torch.utils.prefetch import prefetch


class PipelineResults:
    """Append-only metric log (`kiss_icp/tools/pipeline_results.py`)."""

    def __init__(self):
        self._entries = []

    def append(self, desc: str, units: str, value, trunc: bool = False):
        self._entries.append((desc, units, int(value) if trunc else value))

    def empty(self) -> bool:
        return not self._entries

    def __str__(self):
        lines = [f"{desc:<40} {value:10.3f} {units}" for desc, units, value in self._entries]
        return "\n".join(lines)

    def log_to_file(self, filename: str, title: str):
        with open(filename, "w") as f:
            f.write(title + "\n" + str(self) + "\n")

    def items(self):
        return list(self._entries)


def _rotation_to_quaternion(R: np.ndarray):
    """w, x, y, z from a rotation matrix (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


class OdometryPipeline:
    def __init__(
        self,
        dataset,
        config: Optional[Path] = None,
        deskew: Optional[bool] = False,
        max_range: Optional[float] = None,
        n_scans: int = -1,
        jump: int = 0,
        visualizer=None,
        use_descriptors: bool = False,
        device=None,
    ):
        self._dataset = dataset
        self._n_scans = (
            len(dataset) - jump if n_scans == -1 else min(len(dataset) - jump, n_scans)
        )
        self._jump = jump
        self._first = jump
        self._last = jump + self._n_scans

        self.config = load_config(config, deskew=deskew, max_range=max_range)
        self.results_dir = None

        self.odometry = KissICP(config=self.config, device=device)
        self.results = PipelineResults()
        self.times: List[int] = []
        self.poses = self.odometry.poses
        # Loaders expose gt_poses=None when the GT file is absent (NCLT):
        # the same as no attribute.
        self.has_gt = getattr(dataset, "gt_poses", None) is not None
        self.gt_poses = dataset.gt_poses[self._first : self._last] if self.has_gt else None
        self.dataset_name = dataset.__class__.__name__
        self.dataset_sequence = (
            dataset.sequence_id
            if hasattr(dataset, "sequence_id")
            else os.path.basename(getattr(dataset, "data_dir", "sequence"))
        )
        # A callback (pose, keypoints, map) per frame stands in for the
        # rviz / Open3D visualizer.
        self.visualizer = visualizer
        # The odometry server's modes (`ros/ros1/OdometryServer.cpp:77-95`):
        # v0 / v1 register on xyz (extra columns dropped); v2 keeps the
        # descriptor columns and registers on the XD cosine-weighted path.
        self.use_descriptors = use_descriptors

    # ------------------------------------------------------------------ public
    def run(self) -> PipelineResults:
        self._run_pipeline()
        self._run_evaluation()
        self._create_output_dir()
        self._write_result_poses()
        self._write_gt_poses()
        self._write_cfg()
        self._write_log()
        return self.results

    # ----------------------------------------------------------------- private
    def _next(self, idx):
        dataframe = self._dataset[idx]
        try:
            frame, timestamps = dataframe
        except ValueError:
            frame = dataframe
            timestamps = np.zeros(frame.shape[0])
        return frame, timestamps

    def _run_pipeline(self):
        # Dataset reads (disk IO, decode) overlap with the registration on a
        # background thread.
        frames = prefetch(
            (self._next(idx) for idx in range(self._first, self._last)), size=2
        )
        for raw_frame, timestamps in frames:
            start = time.perf_counter_ns()
            pose, keypoints, _ = self.odometry.register_frame(
                raw_frame, timestamps, use_descriptors=self.use_descriptors
            )
            self.times.append(time.perf_counter_ns() - start)
            if self.visualizer is not None:
                self.visualizer(pose, keypoints, self.odometry.local_map)

    @staticmethod
    def save_poses_kitti_format(filename: str, poses):
        kitti = np.array([np.concatenate((p[0], p[1], p[2])) for p in poses])
        np.savetxt(fname=f"{filename}_kitti.txt", X=kitti)

    @staticmethod
    def save_poses_tum_format(filename, poses, timestamps):
        tum = []
        with contextlib.suppress(ValueError):
            for idx in range(len(poses)):
                tx, ty, tz = poses[idx][:3, -1].flatten()
                qw, qx, qy, qz = _rotation_to_quaternion(poses[idx][:3, :3])
                tum.append([float(timestamps[idx]), tx, ty, tz, qx, qy, qz, qw])
        np.savetxt(fname=f"{filename}_tum.txt", X=np.array(tum, dtype=np.float64), fmt="%.4f")

    def _calibrate_poses(self, poses):
        if hasattr(self._dataset, "apply_calibration"):
            return self._dataset.apply_calibration(poses)
        return poses

    def _get_frames_timestamps(self):
        if hasattr(self._dataset, "get_frames_timestamps"):
            return self._dataset.get_frames_timestamps()
        return np.arange(0, len(self.poses), 1.0)

    def _save_poses(self, filename: str, poses, timestamps):
        np.save(filename, poses)
        self.save_poses_kitti_format(filename, poses)
        self.save_poses_tum_format(filename, poses, timestamps)

    def _write_result_poses(self):
        self._save_poses(
            f"{self.results_dir}/{self.dataset_sequence}_poses",
            self._calibrate_poses(self.poses),
            self._get_frames_timestamps(),
        )

    def _write_gt_poses(self):
        if not self.has_gt:
            return
        self._save_poses(
            f"{self.results_dir}/{self.dataset_sequence}_gt",
            self._calibrate_poses(self.gt_poses),
            self._get_frames_timestamps(),
        )

    def _run_evaluation(self):
        if self.has_gt:
            avg_tra, avg_rot = seq_error(self.gt_poses, self.poses)
            ate_rot, ate_trans = absolute_trajectory_error(self.gt_poses, self.poses)
            self.results.append("Average Translation Error", "%", avg_tra)
            self.results.append("Average Rotational Error", "deg/m", avg_rot)
            self.results.append("Average Rotational Error", "deg/100m", 100 * avg_rot)
            self.results.append("Absolute Trajectory Error (ATE)", "m", ate_trans)
            self.results.append("Absolute Rotational Error (ARE)", "rad", ate_rot)

        total_time_s = sum(self.times) * 1e-9
        fps = len(self.times) / max(total_time_s, 1e-12)
        self.results.append("Average Frequency", "Hz", int(np.ceil(fps)), trunc=True)
        self.results.append("Average Runtime", "ms", int(np.ceil(1e3 / fps)), trunc=True)

    def _write_log(self):
        if not self.results.empty():
            self.results.log_to_file(
                f"{self.results_dir}/result_metrics.log",
                f"Results for {self.dataset_name} Sequence {self.dataset_sequence}",
            )

    def _write_cfg(self):
        write_config(self.config, os.path.join(self.results_dir, "config.yml"))

    @staticmethod
    def _get_results_dir(out_dir: str) -> str:
        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        results_dir = os.path.join(os.path.realpath(out_dir), ts)
        latest_dir = os.path.join(os.path.realpath(out_dir), "latest")
        os.makedirs(results_dir, exist_ok=True)
        if os.path.exists(latest_dir) or os.path.islink(latest_dir):
            os.unlink(latest_dir)
        os.symlink(results_dir, latest_dir)
        return results_dir

    def _create_output_dir(self):
        self.results_dir = self._get_results_dir(self.config.out_dir)
