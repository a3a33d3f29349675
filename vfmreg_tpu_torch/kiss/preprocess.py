"""Range crop: a copy of `vfmreg_tpu/kiss/preprocess.py` (`kiss_icp/preprocess.py`,
`Preprocessing.cpp:139-197`), host numpy: keep min_range < |p| < max_range."""

from __future__ import annotations

import numpy as np

from vfmreg_tpu_torch.config import KISSConfig


def get_preprocessor(config: KISSConfig):
    return Preprocessor(config) if config.data.preprocess else Stubcessor()


class Stubcessor:
    def __call__(self, frame: np.ndarray) -> np.ndarray:
        return frame


class Preprocessor(Stubcessor):
    def __init__(self, config: KISSConfig):
        self.config = config

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        norm = np.linalg.norm(frame[:, :3], axis=1)
        keep = (norm < self.config.data.max_range) & (norm > self.config.data.min_range)
        return frame[keep]
