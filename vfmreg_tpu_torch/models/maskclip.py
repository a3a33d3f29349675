"""MaskCLIP dense features: the reference's second foundation model.

Counterpart of `vfmreg_tpu/models/maskclip.py` (FeatUp's "maskclip", the
reference's `image_features.py:44-51`: patch 16, 512-d). CLIP's ViT-B/16
visual tower:

  bias-free 16 x 16 patch embedding -> [class] + patches + position embedding
  (bicubic resize by the port's `vit._torch_bicubic_matrix` off the 14 x 14
  pretrain grid) -> ln_pre
  -> num_layers - 1 x { LN -> softmax MHSA -> residual, LN -> quickGELU MLP -> residual }
  -> the last block value-only (MaskCLIP, Zhou et al., ECCV 2022: x + out_proj(v(LN(x))),
     then the MLP), or a plain block with `standard_last_layer=True`
  -> ln_post -> @ proj (768 -> 512).

Images come as [B, H, W, 3] normalised, resized to patch multiples
(`models/image_features.preprocess_image`); patches go out as [B, h, w, 512].
Each softmax attention goes through kernel B5
(`ops/flash_attention.flash_attention`): the CUDA kernel for tensors on the
card, its plain einsum softmax for tensors on the CPU. The patch embedding is
an unfold plus a matmul (`vit.PatchEmbed`), so nothing runs through cuDNN's
TF32; every product is full f32.

Parameter names and layouts follow the OpenAI checkpoint's `visual.`
subtree, so `load_clip_visual_state_dict` only selects its entries;
`init_maskclip` draws random weights in the reference's shapes and scales.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from vfmreg_tpu_torch.models.clip_text import Transformer
from vfmreg_tpu_torch.models.vit import PatchEmbed, interpolate_pos_embed
from vfmreg_tpu_torch.ops.flash_attention import flash_attention
from vfmreg_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MaskCLIPConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    patch_size: int = 16
    embed_dim: int = 512  # output projection width
    pretrain_img_size: int = 224
    layernorm_eps: float = 1e-5

    @property
    def pos_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size


class MaskCLIP(nn.Module):
    """`forward(images [B, H, W, 3], standard_last_layer=False)` ->
    {"cls": [B, embed_dim], "patches": [B, h, w, embed_dim]}."""

    def __init__(self, cfg: MaskCLIPConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layernorm_eps
        self.cfg = cfg
        self.conv1 = PatchEmbed(cfg.patch_size, d, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.positional_embedding = nn.Parameter(torch.zeros(1 + cfg.pos_grid**2, d))
        self.ln_pre = nn.LayerNorm(d, eps=eps)
        self.transformer = Transformer(d, cfg.num_layers, cfg.num_heads, eps)
        self.ln_post = nn.LayerNorm(d, eps=eps)
        self.proj = nn.Parameter(torch.zeros(d, cfg.embed_dim))

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """ln_pre of the embedded tokens [B, 1 + h * w, D]."""
        p = self.cfg.patch_size
        gh, gw = images.shape[1] // p, images.shape[2] // p
        x = self.conv1(images)
        cls = self.class_embedding.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embed(self.positional_embedding[None], gh, gw, self.cfg)
        return self.ln_pre(x)

    def forward(self, images: torch.Tensor, standard_last_layer: bool = False) -> Dict[str, torch.Tensor]:
        b = images.shape[0]
        p = self.cfg.patch_size
        gh, gw = images.shape[1] // p, images.shape[2] // p
        x = self.tokens(images)
        *blocks, last = self.transformer.resblocks
        for blk in blocks:
            x = blk(x, flash_attention)
        x = last(x, flash_attention if standard_last_layer else None)
        x = self.ln_post(x) @ self.proj
        return {"cls": x[:, 0], "patches": x[:, 1:].reshape(b, gh, gw, -1)}


def init_maskclip(cfg: MaskCLIPConfig, generator: torch.Generator, device=None) -> MaskCLIP:
    """A `MaskCLIP` with random weights in the reference's shapes and scales
    (`init_maskclip_params`): dense N(0, 1/n_in), zero biases, patch, class
    and position embeddings N(0, 0.02^2), projection N(0, 1/D), unit norms.
    Drawn on the CPU from `generator`, then moved to `device` (default: the
    card)."""
    dev = resolve_device(device)
    model = MaskCLIP(cfg)
    d = cfg.hidden_size

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    with torch.no_grad():
        model.conv1.weight.copy_(normal(model.conv1.weight.shape, 0.02))
        model.class_embedding.copy_(normal((d,), 0.02))
        model.positional_embedding.copy_(normal(model.positional_embedding.shape, 0.02))
        model.proj.copy_(normal((d, cfg.embed_dim), 1.0 / math.sqrt(d)))
        for blk in model.transformer.resblocks:
            blk.attn.in_proj_weight.copy_(normal((3 * d, d), 1.0 / math.sqrt(d)))
            for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                lin.weight.copy_(normal(lin.weight.shape, 1.0 / math.sqrt(lin.in_features)))
                lin.bias.zero_()
    return model.to(dev).eval()


def load_clip_visual_state_dict(state_dict: Mapping[str, object], cfg: MaskCLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's `MaskCLIP` state dict from an OpenAI CLIP checkpoint
    (numpy- or tensor-valued): its `visual.` entries, or the whole dict when
    it has none. Load with `MaskCLIP(cfg).load_state_dict(...)`."""
    sd = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    if not sd:
        sd = dict(state_dict)
    with torch.device("meta"):
        names = list(MaskCLIP(cfg).state_dict())
    return {n: torch.as_tensor(np.asarray(sd[n]), dtype=torch.float32).clone() for n in names}
