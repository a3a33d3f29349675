"""Image features from a visual foundation model: the `ImageFeatureGenerator`.

Counterpart of `vfmreg_tpu/models/image_features.py`:

* `preprocess_image`: resize to (p * 16, p * patch_w) with patch size p
  (14 for DINOv2, 16 for MaskCLIP) and patch_w = int(scale * img_w / p),
  bilinear with align_corners=False and antialias=False, then ImageNet
  normalisation;
* `ImageFeatureGenerator.get_image_features(image, upsample)`: the
  foundation model's forward -> [h, w, D] patch features (DINOv2's ViT,
  `models/vit.py`, 384-d at ViT-S/14; MaskCLIP, `models/maskclip.py`,
  512-d), optionally upsampled to the input resolution: bilinearly
  (align_corners=False) with `use_featup=False`; with `use_featup=True`
  by FeatUp's learned JBU stack (`models/featup.py`) when its parameters
  are given or `VFMREG_FEATUP_WEIGHTS` names a checkpoint, then bilinearly
  from 16h x 16w, else by the classical joint bilateral upsampler at the
  input resolution; with the `.npy` cache named
  `<stem>_{use_featup}_{upsample}.npy`;
* `TorchPCA`, `pca_to_rgb`, `get_image_features_pca` and `run_pca`: numpy
  copies of the reference's PCA-to-RGB with the fit kept per component
  count (and pickled to `pca_fit_file`);
* `set_text_encoder`, `encode_text` and `compute_similarity`: CLIP's text
  tower (`models/clip_text.py`) and the cosine similarity of point
  descriptors to a prompt.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfmreg_tpu_torch.models import featup
from vfmreg_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from vfmreg_tpu_torch.models.maskclip import MaskCLIP, MaskCLIPConfig, init_maskclip
from vfmreg_tpu_torch.models.vit import PRESETS, ViT, init_vit
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.profiling import Timer, span

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


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
    """The reference's `ImageFeatureGenerator` on `device` (default: the card).

    `foundation_model` is "dinov2" (`config` a `ViTConfig`, ViT-S/14 by
    default) or "maskclip" (`config` a `MaskCLIPConfig`, ViT-B/16 by
    default). `params` is the model's state dict: `models.vit.ViT`'s
    (`vit.load_dinov2_state_dict`, or `convert.vit_params_from_numpy` of the
    reference's parameter pytree) or `models.maskclip.MaskCLIP`'s
    (`maskclip.load_clip_visual_state_dict`, `convert.maskclip_params_from_numpy`);
    without it the weights are random, from `seed`. The model is built
    without an initialisation of its own and takes the given tensors (no copy
    where they are float32 on `device` already). `featup_params` is a
    `models.featup.JBUStack` state dict (`featup.load_featup_state_dict`,
    `convert.jbu_stack_params_from_numpy`) for `use_featup=True`; the text
    tower is attached with `set_text_encoder` (`clip_text.load_clip_text_state_dict`,
    `convert.clip_text_params_from_numpy`)."""

    def __init__(
        self,
        foundation_model: str = "dinov2",
        use_featup: bool = False,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        config=None,
        seed: int = 0,
        pca_fit_file: Optional[Path] = None,
        featup_params: Optional[Mapping[str, torch.Tensor]] = None,
        device=None,
    ) -> None:
        self.use_featup = use_featup
        self.device = resolve_device(device)
        if foundation_model == "dinov2":
            self.config = config or PRESETS["dinov2_vits14"]
            self.feature_size = self.config.hidden_size
            model_cls, init = ViT, init_vit
        elif foundation_model == "maskclip":
            self.config = config or MaskCLIPConfig()
            self.feature_size = self.config.embed_dim
            model_cls, init = MaskCLIP, init_maskclip
        else:
            raise ValueError(f"Unsupported foundation model: {foundation_model}")
        if params is None:
            self.model = init(self.config, torch.Generator().manual_seed(seed), self.device)
        else:
            with torch.device("meta"):
                self.model = model_cls(self.config)
            self.model.load_state_dict(
                {k: torch.as_tensor(v, dtype=torch.float32, device=self.device) for k, v in params.items()},
                assign=True)
            self.model = self.model.eval()
        self.patch_size = self.config.patch_size
        self.patch_h = 16  # as FeatUp
        self.featup_params = featup_params
        self._featup_stack: Optional[featup.JBUStack] = None

        self.fit_pca: Dict[int, TorchPCA] = {}
        self.fit_pca_file = pca_fit_file
        if pca_fit_file is not None and Path(pca_fit_file).exists():
            with open(pca_fit_file, "rb") as f:
                self.fit_pca = pickle.load(f)
        self.text_model: Optional[CLIPText] = None
        self.tokenizer = None

    @torch.no_grad()
    def _forward(self, batch: torch.Tensor, timer: Optional[Timer] = None) -> torch.Tensor:
        with span("vit", timer, self.device):
            return self.model(batch)["patches"]  # [B, h, w, D]

    def _learned_stack(self) -> Optional[featup.JBUStack]:
        """FeatUp's JBU stack from `featup_params`, else from the checkpoint
        that `VFMREG_FEATUP_WEIGHTS` names; None when neither is there."""
        if self._featup_stack is None:
            if self.featup_params is None:
                wpath = os.environ.get("VFMREG_FEATUP_WEIGHTS")
                if wpath and Path(wpath).exists():
                    self.featup_params = featup.load_featup_state_dict(torch.load(wpath, map_location="cpu"))
            if self.featup_params is not None:
                self._featup_stack = featup.stack_from_state_dict(self.featup_params, self.device)
        return self._featup_stack

    def get_image_features(
        self, image: np.ndarray, upsample: bool = False, cache_file: Optional[Path] = None,
        timer: Optional[Timer] = None,
    ) -> np.ndarray:
        """[H, W, D] (upsample=True) or [h, w, D] patch-grid features, f32
        numpy. `timer` (a `utils.profiling.Timer`) clocks the forward's span
        `vfmreg.vit`, ending it in a synchronize."""
        if cache_file:
            cache_file = Path(cache_file)
            cache_file = cache_file.parent / f"{cache_file.stem}_{self.use_featup}_{upsample}.npy"
            if cache_file.exists():
                return np.load(cache_file)

        batch, (img_h, img_w) = preprocess_image(image, self.patch_size, self.patch_h, self.device)
        feats = self._forward(batch, timer)  # [1, h, w, D]
        if upsample:
            stack = self._learned_stack() if self.use_featup else None
            if self.use_featup and stack is None:
                guide = torch.from_numpy(np.ascontiguousarray(image)).to(self.device).to(torch.float32) / 255.0
                feats = featup.jbu_upsample(feats[0], guide, img_h, img_w)[None]
            else:
                if stack is not None:
                    feats = featup.jbu_stack_upsample(stack, feats[0], batch[0])[None]
                feats = F.interpolate(feats.permute(0, 3, 1, 2), size=(img_h, img_w), mode="bilinear",
                                      align_corners=False, antialias=False).permute(0, 2, 3, 1)
        out = feats[0].cpu().numpy().astype(np.float32, copy=False)

        if cache_file:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache_file, out)
        return out

    def get_image_features_pca(
        self, image: np.ndarray, upsample: bool = False, n_components: int = 3
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(features, their PCA image): uint8 RGB for 3 components, with the
        fit kept for the next image."""
        feats = self.get_image_features(image, upsample=upsample)
        pca_feats, fit = pca_to_rgb(feats, self.fit_pca.get(n_components), n_components)
        self.fit_pca.setdefault(n_components, fit)
        if n_components == 3:
            pca_feats = (pca_feats * 255.0).astype(np.uint8)
        return feats, pca_feats

    def run_pca(self, features: np.ndarray, refit_pca: bool = False, n_components: int = 3) -> np.ndarray:
        """PCA-to-RGB of point descriptors [N, D] (the reference's `run_pca`):
        a new fit is pickled to `pca_fit_file`; for 3 components uint8 RGB
        with zero-descriptor rows black."""
        if refit_pca:
            self.fit_pca.pop(n_components, None)
        pca_feats, fit = pca_to_rgb(features, self.fit_pca.get(n_components), n_components)
        if n_components not in self.fit_pca:
            self.fit_pca[n_components] = fit
            if self.fit_pca_file is not None:
                with open(self.fit_pca_file, "wb") as f:
                    pickle.dump(self.fit_pca, f)
        if n_components == 3:
            pca_feats = (pca_feats * 255.0).astype(np.uint8)
            pca_feats[np.all(features == 0, axis=-1)] = 0
        return pca_feats

    def set_text_encoder(self, text_params: Mapping[str, torch.Tensor], text_config: Optional[CLIPTextConfig] = None,
                         tokenizer=None) -> None:
        """Attach CLIP's text tower (a `clip_text.CLIPText` state dict) on the
        generator's device, and a `clip_text.SimpleTokenizer`."""
        model = CLIPText(text_config or CLIPTextConfig())
        model.load_state_dict(text_params)
        self.text_model = model.to(self.device).eval()
        self.tokenizer = tokenizer

    @torch.no_grad()
    def encode_text(self, prompt: str) -> np.ndarray:
        """prompt -> CLIP text embedding [embed_dim] f32 (tokenize, then the
        text tower)."""
        if self.text_model is None or self.tokenizer is None:
            raise RuntimeError("text encoder not attached: call set_text_encoder(params, cfg, tokenizer)")
        tokens = self.tokenizer.tokenize(prompt, self.text_model.cfg.context_length)
        emb = self.text_model(torch.from_numpy(tokens).to(self.device))
        return emb[0].cpu().numpy()

    def compute_similarity(self, features: np.ndarray, embedding) -> np.ndarray:
        """Cosine similarity of point features [N, D] to a prompt (a string,
        encoded by the text tower) or an embedding vector; zero rows stay 0."""
        if isinstance(embedding, str):
            embedding = self.encode_text(embedding)
        emb = embedding.reshape(-1)
        emb = emb / np.linalg.norm(emb)
        norm = np.linalg.norm(features, axis=-1, keepdims=True)
        feats_n = np.where(norm > 0, features / np.maximum(norm, 1e-20), 0.0)
        return feats_n @ emb
