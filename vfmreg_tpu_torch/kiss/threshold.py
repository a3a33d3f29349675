"""Adaptive correspondence threshold: a copy of `vfmreg_tpu/kiss/threshold.py`
(`core/Threshold.{hpp,cpp}`, `kiss_icp/threshold.py:28-59`), host numpy.

sigma = sqrt(sum(model_error^2) / num_samples), where the model error of the
last deviation is 2 * max_range * sin(theta / 2) + |t|, counted only above
`min_motion_th` (`Threshold.cpp:29-50`).
"""

from __future__ import annotations

import numpy as np

from vfmreg_tpu_torch.config import KISSConfig


def get_threshold_estimator(config: KISSConfig):
    if config.adaptive_threshold.fixed_threshold is not None:
        return FixedThreshold(config.adaptive_threshold.fixed_threshold)
    return AdaptiveThreshold(config)


class FixedThreshold:
    def __init__(self, fixed_threshold: float):
        self.fixed_threshold = float(fixed_threshold)

    def get_threshold(self) -> float:
        return self.fixed_threshold

    def update_model_deviation(self, model_deviation):
        pass


class AdaptiveThreshold:
    def __init__(self, config: KISSConfig):
        self.initial_threshold = float(config.adaptive_threshold.initial_threshold)
        self.min_motion_th = float(config.adaptive_threshold.min_motion_th)
        self.max_range = float(config.data.max_range)
        self.model_error_sse2 = 0.0
        self.num_samples = 0
        self._model_deviation = np.eye(4)

    def _compute_model_error(self, model_deviation: np.ndarray) -> float:
        R = model_deviation[:3, :3]
        cos = min(max((np.trace(R) - 1.0) / 2.0, -1.0), 1.0)
        theta = float(np.arccos(cos))
        delta_rot = 2.0 * self.max_range * np.sin(theta / 2.0)
        delta_trans = float(np.linalg.norm(model_deviation[:3, 3]))
        return delta_trans + delta_rot

    def get_threshold(self) -> float:
        model_error = self._compute_model_error(self._model_deviation)
        if model_error > self.min_motion_th:
            self.model_error_sse2 += model_error * model_error
            self.num_samples += 1
        if self.num_samples < 1:
            return self.initial_threshold
        return float(np.sqrt(self.model_error_sse2 / self.num_samples))

    def update_model_deviation(self, model_deviation: np.ndarray):
        self._model_deviation = np.asarray(model_deviation)
