"""Kernel B5: non-causal multi-head attention with an online softmax.

Counterpart of `vfmreg_tpu/ops/flash_attention.py`, which the ViT backbone
calls once per block (`models/vit.py`): q, k, v [B, T, H, hd] f32 ->
[B, T, H, hd]. q is scaled by 1/sqrt(hd) in f32 before the product, key
columns past T are masked to -1e30, and out = acc / max(l, 1e-30).

The CUDA kernel is `csrc/flash_attention.cu` (both products in 3xTF32 on
the tensor cores); `flash_attention_plain` is the einsum softmax of the
reference's `reference_attention`, the function the kernel is held against. The wrapper runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vfmreg_tpu_torch.ops import _build

NAME = "flash_attention"
_HEAD_DIMS = (32, 64)  # the head widths csrc/flash_attention.cu is instantiated for
# 1/sqrt(hd) rounded to f32, as the reference scales q.
_SCALE = {hd: float(np.float32(1.0 / math.sqrt(hd))) for hd in _HEAD_DIMS}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention [B, T, H, hd] in plain PyTorch (the reference's
    `reference_attention`)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q, k, v):
    # One pass over the common case first: the ViT calls this 12 times per
    # image, and each check below costs host time that the card waits for.
    if (q.ndim == 4 and q.dtype == k.dtype == v.dtype == torch.float32
            and q.shape == k.shape == v.shape and q.shape[1] > 0
            and q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and q.device == k.device == v.device):
        return
    if q.ndim != 4:
        raise ValueError(f"{NAME}: q must be [B, T, H, hd], got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, q on {q.device}")
    if q.shape[1] == 0:
        raise ValueError(f"{NAME}: no tokens")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) attention over q, k, v [B, T, H, hd] f32; returns
    [B, T, H, hd]."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError(f"{NAME}: the CUDA kernel has no backward; call it under torch.no_grad()")
    b, t, h, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{NAME}: head width {hd} is not one of {_HEAD_DIMS}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError(f"{NAME}: q, k and v must be 16-byte aligned")

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.launcher(NAME, "flash_attention_launch", [P] * 4 + [I] * 4 + [F, P])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*ptrs, out.data_ptr(), b, t, h, hd, _SCALE[hd], stream)
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out
