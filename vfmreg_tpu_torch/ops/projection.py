"""Patch-feature sampling at projected pixels.

Counterpart of `vfmreg_tpu/ops/projection.py:sample_patch_features`: the
ViT patch grid is sampled directly at the projected pixel coordinates with
the align_corners=False bilinear mapping, which equals bilinear upsampling
of the grid to the full image followed by a gather at (v, u), without the
[H, W, D] map. Plain tensor code, as the reference's is plain XLA.
"""

from __future__ import annotations

import torch


def sample_patch_features(
    patch_feats: torch.Tensor,  # [h, w, D]
    u: torch.Tensor,  # [N] integer pixel column in the full image
    v: torch.Tensor,  # [N] integer pixel row
    img_h: int,
    img_w: int,
) -> torch.Tensor:
    """bilinear-upsample(patch_feats -> img_h x img_w)[v, u], [N, D], with
    torch's align_corners=False mapping src = (dst + 0.5) * (src / dst) - 0.5,
    edge-clamped."""
    h, w, _ = patch_feats.shape
    y = ((v.to(torch.float32) + 0.5) * (h / img_h) - 0.5).clamp(0.0, h - 1.0)
    x = ((u.to(torch.float32) + 0.5) * (w / img_w) - 0.5).clamp(0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    return (
        patch_feats[y0, x0] * (1 - wy) * (1 - wx)
        + patch_feats[y0, x1] * (1 - wy) * wx
        + patch_feats[y1, x0] * wy * (1 - wx)
        + patch_feats[y1, x1] * wy * wx
    )
