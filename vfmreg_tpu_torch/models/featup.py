"""Guided feature upsampling: the `use_featup=True` path.

Counterpart of `vfmreg_tpu/models/featup.py`, two upsamplers of the ViT's
patch grid, both plain PyTorch (the reference has no Pallas kernel here):

* `jbu_upsample` (`:33`), the classical image-guided joint bilateral
  upsampler, evaluated once at the target resolution:
  F_hr(p) = sum_q w_s(p, q) w_r(I(p), I(q)) F_lr(q) / sum_q w_s w_r over the
  3 x 3 low-resolution neighbours q of p's nearest cell, a Gaussian spatial
  kernel in low-resolution cells and a Gaussian range kernel on guidance
  colour differences; the guidance is area-averaged onto the feature grid
  as `jax.image.resize(method="linear")` does (`_linear_resize_matrix`).
* `JBUStack` (`:104-231`), FeatUp's learned `jbu_stack` upsampler: four x2
  stages and a residual 1 x 1 fixup (out = fixup(x) * 0.1 + x). Each stage
  (`jbu_learned_one`) pools the guidance to twice the feature grid
  (torch's adaptive average pool, as two matrices), maps it through a
  1 x 1 conv -> tanh-GELU -> 1 x 1 conv to 32-d keys, forms a softmax range
  kernel over each pixel's 7 x 7 reflect-padded neighbourhood, scaled by
  exp(range_temp) clamped at 1e4, times a Gaussian spatial kernel on a
  [-1, 1] window with learned sigma, normalised, and applies it to the
  features upsampled x2 by torch's bicubic (`_bicubic_x2`). The 49
  neighbours are streamed as shifted slices; the [2h, 2w, 49, K] unfold is
  never made.

Images and features are [H, W, C] (the reference's layout). The 1 x 1
convolutions are matmuls, so nothing runs through cuDNN's TF32. Parameter
names follow the FeatUp hub checkpoint (`up1..up4.range_temp`,
`up{i}.range_proj.{0,3}.*`, `up{i}.sigma_spatial`, `fixup_proj.1.*`), so
`load_featup_state_dict` only drops an `upsampler.` prefix.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfmreg_tpu_torch.models.vit import _torch_bicubic_matrix
from vfmreg_tpu_torch.utils.device import resolve_device

_JBU_RADIUS = 3
_JBU_KEY_DIM = 32


# ----------------------------------------------------------- classical JBU
def _linear_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] weights of `jax.image.resize(method="linear")` along one
    axis (antialiased: the triangle kernel widened by n_in / n_out when
    shrinking; half-pixel centres; weights normalised per output)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[:, None], w, 0.0).astype(np.float32))


def jbu_upsample(
    feats_lr: torch.Tensor,
    guidance: torch.Tensor,
    out_h: int,
    out_w: int,
    radius: int = 1,
    sigma_spatial: float = 1.0,
    sigma_range: float = 0.15,
) -> torch.Tensor:
    """Joint bilateral upsample of the patch grid `feats_lr` [h, w, D] to
    [out_h, out_w, D], guided by `guidance` [H, W, 3] in [0, 1] (H, W =
    out_h, out_w), on their device."""
    h, w, d = feats_lr.shape
    dev = feats_lr.device
    rh = _linear_resize_matrix(guidance.shape[0], h).to(dev)
    rw = _linear_resize_matrix(guidance.shape[1], w).to(dev)
    guide_lr = torch.einsum("wj,hjc->hwc", rw, torch.einsum("hi,ijc->hjc", rh, guidance))

    # The source coordinate (i + 0.5) * f32(h / out_h) - 0.5 rounded once to
    # f32, as the reference's compiled multiply-add gives it: the nearest
    # cell of a coordinate on a half-integer depends on that rounding.
    ys = ((torch.arange(out_h, device=dev, dtype=torch.float64) + 0.5) * float(np.float32(h / out_h))
          - 0.5).to(torch.float32)
    xs = ((torch.arange(out_w, device=dev, dtype=torch.float64) + 0.5) * float(np.float32(w / out_w))
          - 0.5).to(torch.float32)
    y0 = torch.round(ys).to(torch.int64).clamp(0, h - 1)
    x0 = torch.round(xs).to(torch.int64).clamp(0, w - 1)

    acc = torch.zeros((out_h, out_w, d), device=dev)
    norm = torch.zeros((out_h, out_w, 1), device=dev)
    inv2ss = 1.0 / (2.0 * sigma_spatial**2)
    inv2sr = 1.0 / (2.0 * sigma_range**2)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            qy = (y0 + dy).clamp(0, h - 1)
            qx = (x0 + dx).clamp(0, w - 1)
            f = feats_lr[qy][:, qx]  # [out_h, out_w, D]
            g = guide_lr[qy][:, qx]  # [out_h, out_w, 3]
            d_spatial = (qy.to(torch.float32) - ys)[:, None] ** 2 + (qx.to(torch.float32) - xs)[None, :] ** 2
            w_s = torch.exp(-d_spatial * inv2ss)[..., None]
            w_r = torch.exp(-((guidance - g) ** 2).sum(dim=-1, keepdim=True) * inv2sr)
            wgt = w_s * w_r
            acc += wgt * f
            norm += wgt
    return acc / norm.clamp_min(1e-8)


def upsample_features(feats_lr: np.ndarray, image: np.ndarray, radius: int = 1, device=None) -> np.ndarray:
    """[h, w, D] features + a uint8 image [H, W, 3] -> [H, W, D] f32 numpy,
    computed on `device` (default: the card)."""
    dev = resolve_device(device)
    H, W = image.shape[:2]
    guide = torch.from_numpy(np.ascontiguousarray(image)).to(dev).to(torch.float32) / 255.0
    out = jbu_upsample(torch.from_numpy(np.asarray(feats_lr, dtype=np.float32)).to(dev), guide, H, W, radius=radius)
    return out.cpu().numpy()


# -------------------------------------------------------- learned JBU stack
class Conv1x1(nn.Module):
    """A 1 x 1 convolution on [H, W, C_in] as a matmul; weight [out, in, 1, 1]
    as the checkpoint holds it."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, 1, 1))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class JBULearnedRange(nn.Module):
    """One learned x2 stage's parameters (`range_proj.0` -> GELU ->
    `range_proj.3`, `range_temp`, `sigma_spatial`)."""

    def __init__(self, guidance_dim: int = 3, key_dim: int = _JBU_KEY_DIM):
        super().__init__()
        self.range_temp = nn.Parameter(torch.zeros(()))
        self.sigma_spatial = nn.Parameter(torch.ones(()))
        self.range_proj = nn.ModuleDict({"0": Conv1x1(guidance_dim, key_dim), "3": Conv1x1(key_dim, key_dim)})

    def forward(self, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        return jbu_learned_one(self, source, guidance)


def _reflect_pad2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """[H, W, C] reflect-padded by r on both spatial axes (`jnp.pad(mode="reflect")`)."""
    return F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="reflect")[0].permute(1, 2, 0)


def _bicubic_x2(x: torch.Tensor) -> torch.Tensor:
    """torch's `Upsample(mode="bicubic", align_corners=False)` x2 of [h, w, D],
    as the reference's two weight matmuls."""
    h, w, _ = x.shape
    wh = _torch_bicubic_matrix(h, 2 * h).to(x.device)
    ww = _torch_bicubic_matrix(w, 2 * w).to(x.device)
    return torch.einsum("wj,hjd->hwd", ww, torch.einsum("hi,ijd->hjd", wh, x))


def _adaptive_pool_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] averaging weights of torch's `adaptive_avg_pool1d`: bin i
    spans [floor(i n / o), ceil((i + 1) n / o))."""
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -(-((i + 1) * n_in) // n_out)
        mat[i, s:e] = 1.0 / (e - s)
    return torch.from_numpy(mat)


def _adaptive_avg_pool(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """torch's `F.adaptive_avg_pool2d` on [H, W, C], as two matmuls."""
    H, W, _ = x.shape
    rh = _adaptive_pool_matrix(H, oh).to(x.device)
    rw = _adaptive_pool_matrix(W, ow).to(x.device)
    return torch.einsum("wj,hjd->hwd", rw, torch.einsum("hi,ijd->hjd", rh, x))


def jbu_learned_one(stage: JBULearnedRange, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """One learned-JBU x2 stage: [h, w, D] + [2h, 2w, G] -> [2h, 2w, D]."""
    r, dia = _JBU_RADIUS, 2 * _JBU_RADIUS + 1
    gh, gw, _ = guidance.shape

    # jax.nn.gelu's default, the tanh approximation.
    proj = stage.range_proj["3"](F.gelu(stage.range_proj["0"](guidance), approximate="tanh"))
    proj_pad = _reflect_pad2d(proj, r)
    temp = torch.exp(stage.range_temp).clamp_max(1e4)

    hr = _bicubic_x2(source)
    hr_pad = _reflect_pad2d(hr, r)

    logits = torch.stack([(proj * proj_pad[dy : dy + gh, dx : dx + gw]).sum(dim=-1)
                          for dy in range(dia) for dx in range(dia)], dim=-1) * temp
    range_kernel = torch.softmax(logits, dim=-1)  # [2h, 2w, dia^2]

    lin = torch.linspace(-1.0, 1.0, dia, device=source.device)
    d2 = (lin[:, None] ** 2 + lin[None, :] ** 2).reshape(-1)
    spatial = torch.exp(-d2 / (2.0 * stage.sigma_spatial**2))
    kernel = range_kernel * spatial
    kernel = kernel / kernel.sum(dim=-1, keepdim=True).clamp_min(1e-7)

    out = torch.zeros_like(hr)
    for k in range(dia * dia):
        dy, dx = divmod(k, dia)
        out += kernel[..., k : k + 1] * hr_pad[dy : dy + gh, dx : dx + gw]
    return out


class JBUStack(nn.Module):
    """FeatUp's `jbu_stack`: `forward(source [h, w, D], guidance [H, W, 3])`
    -> [16h, 16w, D]."""

    def __init__(self, feat_dim: int, guidance_dim: int = 3):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"up{i}", JBULearnedRange(guidance_dim))
        self.fixup_proj = nn.ModuleDict({"1": Conv1x1(feat_dim, feat_dim)})

    def forward(self, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        x = source
        for i in range(1, 5):
            h, w, _ = x.shape
            x = jbu_learned_one(getattr(self, f"up{i}"), x, _adaptive_avg_pool(guidance, 2 * h, 2 * w))
        return self.fixup_proj["1"](x) * 0.1 + x


def jbu_stack_upsample(stack: JBUStack, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """[h, w, D] features + [H, W, 3] image -> [16h, 16w, D] (the reference's
    `jbu_stack_upsample`), on the stack's device."""
    with torch.no_grad():
        return stack(source, guidance)


def init_jbu_stack(feat_dim: int, generator: torch.Generator, guidance_dim: int = 3, device=None) -> JBUStack:
    """A `JBUStack` with the reference's init (`init_jbu_stack_params`):
    range_temp 0, sigma_spatial 1, key projections N(0, 0.2^2), fixup
    N(0, 0.02^2), zero biases. Drawn on the CPU from `generator`, then moved
    to `device` (default: the card)."""
    dev = resolve_device(device)
    stack = JBUStack(feat_dim, guidance_dim)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    with torch.no_grad():
        for i in range(1, 5):
            proj = getattr(stack, f"up{i}").range_proj
            for key in ("0", "3"):
                proj[key].weight.copy_(normal(proj[key].weight.shape, 0.2))
        stack.fixup_proj["1"].weight.copy_(normal((feat_dim, feat_dim, 1, 1), 0.02))
    return stack.to(dev).eval()


def load_featup_state_dict(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The port's `JBUStack` state dict from a FeatUp hub `jbu_stack`
    upsampler's (numpy- or tensor-valued; keys with or without an
    `upsampler.` prefix); scalars become 0-d. Load with
    `JBUStack(feat_dim).load_state_dict(...)`, feat_dim =
    `out["fixup_proj.1.bias"].shape[0]`."""
    sd = {k.replace("upsampler.", ""): v for k, v in state_dict.items()}
    out = {}
    for i in range(1, 5):
        p = f"up{i}."
        for name in ("range_temp", "sigma_spatial"):
            out[p + name] = torch.as_tensor(np.asarray(sd[p + name]), dtype=torch.float32).reshape(())
        for j in ("0", "3"):
            for part in ("weight", "bias"):
                out[f"{p}range_proj.{j}.{part}"] = torch.as_tensor(
                    np.asarray(sd[f"{p}range_proj.{j}.{part}"]), dtype=torch.float32).clone()
    for part in ("weight", "bias"):
        out[f"fixup_proj.1.{part}"] = torch.as_tensor(np.asarray(sd[f"fixup_proj.1.{part}"]),
                                                      dtype=torch.float32).clone()
    return out


def stack_from_state_dict(state_dict: Mapping[str, torch.Tensor], device=None) -> JBUStack:
    """A `JBUStack` on `device` (default: the card) holding `state_dict`
    (`load_featup_state_dict`, `convert.jbu_stack_params_from_numpy`)."""
    stack = JBUStack(int(state_dict["fixup_proj.1.bias"].shape[0]),
                     int(state_dict["up1.range_proj.0.weight"].shape[1]))
    stack.load_state_dict(state_dict)
    return stack.to(resolve_device(device)).eval()
