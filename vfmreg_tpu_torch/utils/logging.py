"""Coloured pose printing (a copy of `vfmreg_tpu/utils/logging.py:16`)."""

from __future__ import annotations

import numpy as np

_COLORS = {
    "green": "\033[92m",
    "yellow": "\033[93m",
    "red": "\033[91m",
    None: "",
}
_END = "\033[0m"


def print_msg(pose: np.ndarray, title: str = "", color: str = None) -> None:
    prefix = _COLORS.get(color, "")
    suffix = _END if prefix else ""
    t = pose[:3, 3]
    print(f"{prefix}{title:<22} t=[{t[0]:8.2f} {t[1]:8.2f} {t[2]:8.2f}]{suffix}")
    with np.printoptions(precision=3, suppress=True):
        print(f"{prefix}{np.asarray(pose)}{suffix}")
