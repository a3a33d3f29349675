"""Full-f32 matmul guard for the registration core.

Counterpart of `vfmreg_tpu/utils/precision.py:19`. Reduced-precision matmuls
(TF32 keeps ~3 decimal digits) at LiDAR map coordinates (|p| ~ 100 m) carry
rounding errors that eat the 0.6 m recall budget (DESIGN.md §2), so the
geometry runs in true f32. PyTorch's f32 convolutions default to TF32 through
cuDNN; both switches are set explicitly.
"""

from __future__ import annotations

import torch


def full_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
