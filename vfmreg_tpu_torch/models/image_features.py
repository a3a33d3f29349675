"""Image features from the DINOv2 ViT: the `ImageFeatureGenerator`.

Counterpart of `vfmreg_tpu/models/image_features.py` for `"dinov2"`:

* `preprocess_image`: resize to (14 * 16, 14 * patch_w) with
  patch_w = int(scale * img_w / 14), bilinear with align_corners=False and
  antialias=False, then ImageNet normalisation;
* `ImageFeatureGenerator.get_image_features(image, upsample)`: ViT forward
  -> [h, w, D] patch features, optionally bilinearly upsampled to the input
  resolution (align_corners=False), with the `.npy` cache named
  `<stem>_{use_featup}_{upsample}.npy`;
* `TorchPCA` and `pca_to_rgb`, numpy copies of the reference's PCA-to-RGB.

FeatUp's learned upsampler (`use_featup=True`) and MaskCLIP wait for their
weights (ROADMAP A11b) and raise NotImplementedError. The reference
generator's PCA-fit and text-similarity methods wait with the CLIP text
tower (A11b).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfmreg_tpu_torch.models.vit import PRESETS, ViT, ViTConfig, init_vit
from vfmreg_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
_WAITS = "waits for its weights (ROADMAP A11b)"


def preprocess_image(
    image: np.ndarray, patch_size: int, patch_h: int, device=None
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """uint8 or float H x W x 3 -> normalised [1, H', W', 3] on `device`
    (default: the card), resized to patch multiples; and (H, W)."""
    dev = resolve_device(device)
    img_h, img_w = image.shape[:2]
    scale = (patch_size * patch_h) / img_h
    patch_w = int(scale * img_w / patch_size)
    out_h, out_w = patch_size * patch_h, patch_size * patch_w

    x = torch.from_numpy(np.ascontiguousarray(image)).to(dev).to(torch.float32) / 255.0
    x = F.interpolate(x.permute(2, 0, 1)[None], size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    return (x.permute(0, 2, 3, 1) - mean) / std, (img_h, img_w)


class TorchPCA:
    """Plain-numpy PCA matching featup.util.TorchPCA (mean-center + SVD projection)."""

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "TorchPCA":
        self.mean_ = x.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(x - self.mean_, full_matrices=False)
        self.components_ = vt[: self.n_components].T  # [D, k]
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) @ self.components_


def pca_to_rgb(
    features: np.ndarray, fit_pca: Optional[TorchPCA] = None, n_components: int = 3
) -> Tuple[np.ndarray, TorchPCA]:
    """featup.util.pca semantics: project, then min-max normalise per component."""
    flat = features.reshape(-1, features.shape[-1]).astype(np.float32)
    if fit_pca is None:
        fit_pca = TorchPCA(n_components).fit(flat)
    red = fit_pca.transform(flat)
    red = red - red.min(axis=0, keepdims=True)
    denom = red.max(axis=0, keepdims=True)
    red = red / np.where(denom > 0, denom, 1.0)
    return red.reshape(features.shape[:-1] + (n_components,)), fit_pca


class ImageFeatureGenerator:
    """The reference's `ImageFeatureGenerator` for DINOv2, on `device`
    (default: the card). `params` is a `ViT` state dict
    (`models.vit.load_dinov2_state_dict`, `convert.vit_params_from_numpy`);
    without it the weights are random, from `seed`."""

    def __init__(
        self,
        foundation_model: str = "dinov2",
        use_featup: bool = False,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        config: Optional[ViTConfig] = None,
        seed: int = 0,
        device=None,
    ) -> None:
        if foundation_model == "maskclip":
            raise NotImplementedError(f"MaskCLIP {_WAITS}")
        if foundation_model != "dinov2":
            raise ValueError(f"Unsupported foundation model: {foundation_model}")
        if use_featup:
            raise NotImplementedError(f"FeatUp's learned upsampler {_WAITS}")
        self.use_featup = use_featup
        self.device = resolve_device(device)
        self.config = config or PRESETS["dinov2_vits14"]
        self.patch_size = self.config.patch_size
        self.patch_h = 16  # as FeatUp
        self.feature_size = self.config.hidden_size
        if params is None:
            self.model = init_vit(self.config, torch.Generator().manual_seed(seed), self.device)
        else:
            self.model = ViT(self.config)
            self.model.load_state_dict(params)
            self.model = self.model.to(self.device).eval()

    @torch.no_grad()
    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        return self.model(batch)["patches"]  # [B, h, w, D]

    def get_image_features(
        self, image: np.ndarray, upsample: bool = False, cache_file: Optional[Path] = None
    ) -> np.ndarray:
        """[H, W, D] (upsample=True) or [h, w, D] patch-grid features, f32 numpy."""
        if cache_file:
            cache_file = Path(cache_file)
            cache_file = cache_file.parent / f"{cache_file.stem}_{self.use_featup}_{upsample}.npy"
            if cache_file.exists():
                return np.load(cache_file)

        batch, (img_h, img_w) = preprocess_image(image, self.patch_size, self.patch_h, self.device)
        feats = self._forward(batch)  # [1, h, w, D]
        if upsample:
            feats = F.interpolate(feats.permute(0, 3, 1, 2), size=(img_h, img_w), mode="bilinear",
                                  align_corners=False, antialias=False).permute(0, 2, 3, 1)
        out = feats[0].cpu().numpy().astype(np.float32, copy=False)

        if cache_file:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache_file, out)
        return out
