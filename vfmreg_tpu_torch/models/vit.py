"""DINOv2 Vision Transformer, the VFM backbone of the descriptor pass.

Counterpart of `vfmreg_tpu/models/vit.py` (which matches
`transformers.Dinov2Model` and facebookresearch/dinov2):

  patch embedding (14x14, stride 14) -> [cls] + patches + position embedding
  resized by torch-bicubic weight matrices
  -> [cls] + register tokens + patches (registers: no position embedding)
  -> num_layers x { LN -> MHSA (qkv bias) -> LayerScale -> residual
                    LN -> FFN -> LayerScale -> residual }
  -> final LN (eps 1e-6).

The FFN is the GELU MLP (exact erf) of ViT-S/B/L, or for `ffn="swiglu"` the
SwiGLU of the giant models: W3 (silu(a) * b) with [a; b] = W12 x split in
halves, hidden width (int(4 D * 2 / 3) + 7) // 8 * 8. DINOv2's models with
registers (`dinov2_vitg14_reg`; Darcet et al., arXiv:2309.16588) insert
`num_register_tokens` learned tokens after cls and resize the position grid
with an antialiased bicubic (`interpolate_antialias`), as the hub builds them.

Images come in the reference's layout, [B, H, W, 3] NHWC, already resized to
patch multiples and normalised (`models/image_features.preprocess_image`);
patch features go out as [B, h, w, D]. Attention goes through kernel B5
(`ops/flash_attention.flash_attention`) when `use_flash_attention` is set,
else through its plain einsum softmax.

Precision: every product here is a matmul, which PyTorch runs in full f32 on
the card unless TF32 is switched on. The patch embedding is written as an
unfold plus a matmul, not as a convolution, because PyTorch sends f32
convolutions through cuDNN in TF32 by default.

Weights: `init_vit` draws random weights from a `torch.Generator` with the
reference's shapes and scales (no checkpoint is in the repository);
`load_dinov2_state_dict` converts a DINOv2 checkpoint in either the
transformers or the facebook/FeatUp layout.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfmreg_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from vfmreg_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    layernorm_eps: float = 1e-6
    pretrain_img_size: int = 518  # position grid 37 x 37 for DINOv2
    layerscale_init: float = 1.0
    use_flash_attention: bool = True
    ffn: str = "mlp"  # "mlp" (GELU) or "swiglu"
    num_register_tokens: int = 0
    interpolate_antialias: bool = False

    @property
    def pos_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size

    @property
    def ffn_hidden(self) -> int:
        """The FFN's hidden width: D x mlp_ratio, or for SwiGLU two thirds of
        it rounded up to a multiple of 8 (facebookresearch/dinov2's
        `SwiGLUFFNFused`, transformers' `Dinov2SwiGLUFFN`)."""
        width = self.hidden_size * self.mlp_ratio
        if self.ffn == "swiglu":
            return (int(width * 2 / 3) + 7) // 8 * 8
        if self.ffn != "mlp":
            raise ValueError(f"unknown FFN kind {self.ffn!r}: 'mlp' or 'swiglu'")
        return width


PRESETS = {
    "dinov2_vits14": ViTConfig(hidden_size=384, num_layers=12, num_heads=6),
    "dinov2_vitb14": ViTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "dinov2_vitl14": ViTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    # hub `dinov2_vitg14_reg`: vit_giant2, ffn_layer="swiglufused", 4 registers,
    # interpolate_antialias=True, interpolate_offset=0.0, img_size 518, init_values 1.0.
    "dinov2_vitg14_reg": ViTConfig(hidden_size=1536, num_layers=40, num_heads=24, ffn="swiglu",
                                   num_register_tokens=4, interpolate_antialias=True),
}

# Images and tokens (cls and registers included) through `ViT.forward`, summed
# over the process; read by the benchmark.
FORWARD_COUNTS: collections.Counter = collections.Counter()


def _torch_bicubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] weights of `F.interpolate(mode="bicubic",
    align_corners=False)` along one axis: cubic convolution with a = -0.75
    and border-replicated taps (the reference's `_torch_bicubic_matrix`)."""
    a = -0.75
    x = (torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out) - 0.5
    base = torch.floor(x)
    t = x - base

    def w1(s):  # |s| <= 1
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def w2(s):  # 1 < |s| < 2
        return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

    weights = torch.stack([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], dim=-1)
    taps = (base[:, None].to(torch.int64) + torch.arange(-1, 3)[None, :]).clamp(0, n_in - 1)
    mat = torch.zeros((n_out, n_in), dtype=torch.float32)
    rows = torch.arange(n_out).repeat_interleave(4)
    return mat.index_put_((rows, taps.reshape(-1)), weights.reshape(-1), accumulate=True)


@functools.lru_cache(maxsize=None)
def _torch_bicubic_aa_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] weights of `F.interpolate(mode="bicubic",
    align_corners=False, antialias=True)` along one axis. PyTorch's
    antialiased resize is separable (one pass an axis), so resizing an
    identity along the width, the height left at size 1, gives the axis's
    weights; formed on the CPU. (Along the height of an [n, 1] input the CPU
    kernel gives other weights than it applies to a 2-D grid.)"""
    eye = torch.eye(n_in, dtype=torch.float32).reshape(n_in, 1, 1, n_in)
    out = F.interpolate(eye, size=(1, n_out), mode="bicubic", align_corners=False, antialias=True)
    return out[:, 0, 0, :].T.contiguous()


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int, grid_w: int, cfg, antialias: bool = False):
    """Bicubic resize of the patch position embeddings [1, 1 + g*g, D] to
    (grid_h, grid_w) (g = `cfg.pos_grid`), as two 1-D weight matmuls,
    antialiased where `antialias`; unchanged at the pretrain grid."""
    g = cfg.pos_grid
    if grid_h == g and grid_w == g:
        return pos_embed
    patch_pos = pos_embed[0, 1:].reshape(g, g, -1)
    matrix = _torch_bicubic_aa_matrix if antialias else _torch_bicubic_matrix
    wh = matrix(g, grid_h).to(pos_embed.device)
    ww = matrix(g, grid_w).to(pos_embed.device)
    patch_pos = torch.einsum("hi,ijd->hjd", wh, patch_pos)
    patch_pos = torch.einsum("wj,hjd->hwd", ww, patch_pos)
    return torch.cat([pos_embed[:, :1], patch_pos.reshape(1, grid_h * grid_w, -1)], dim=1)


class PatchEmbed(nn.Module):
    """The p x p / stride-p patch convolution, weight [D, 3, p, p] (OIHW, the
    checkpoints' layout), computed as unfold + matmul (full f32). CLIP's
    has no bias (`bias=False`)."""

    def __init__(self, patch_size: int, dim: int, bias: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.zeros(dim, 3, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, h * w, D]."""
        b, H, W, c = images.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = images[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)  # (kh, kw, c) order
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(x, w, self.bias)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.use_flash = cfg.use_flash_attention
        self.q, self.k, self.v, self.proj = (nn.Linear(d, d) for _ in range(4))

    def qkv(self, x: torch.Tensor):
        """q, k, v [B, T, H, hd] of the normalised tokens x [B, T, D]."""
        b, t, d = x.shape
        h = self.num_heads
        return tuple(lin(x).reshape(b, t, h, d // h) for lin in (self.q, self.k, self.v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        out = (flash_attention if self.use_flash else flash_attention_plain)(q, k, v)
        return self.proj(out.reshape(x.shape))


class Block(nn.Module):
    """One pre-LN block; its FFN is `fc1`, GELU, `fc2` (ffn "mlp") or `w12`,
    SwiGLU, `w3` (ffn "swiglu")."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, eps, f = cfg.hidden_size, cfg.layernorm_eps, cfg.ffn_hidden
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = Attention(cfg)
        self.ls1 = nn.Parameter(torch.full((d,), cfg.layerscale_init))
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.swiglu = cfg.ffn == "swiglu"
        if self.swiglu:
            self.w12 = nn.Linear(d, 2 * f)
            self.w3 = nn.Linear(f, d)
        else:
            self.fc1 = nn.Linear(d, f)
            self.fc2 = nn.Linear(f, d)
        self.ls2 = nn.Parameter(torch.full((d,), cfg.layerscale_init))

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            a, b = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(a) * b)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x))
        return x + self.ls2 * self.ffn(self.norm2(x))


class ViT(nn.Module):
    """DINOv2 ViT; `forward(images [B, H, W, 3])` returns {"cls": [B, D],
    "patches": [B, h, w, D]} (post final-LN tokens)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid**2, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(d, eps=cfg.layernorm_eps)

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """Embedded tokens [B, 1 + R + h * w, D]: cls, the R register tokens,
        patches; the position embedding on cls and patches."""
        p = self.cfg.patch_size
        gh, gw = images.shape[1] // p, images.shape[2] // p
        x = self.patch_embed(images)
        cls = self.cls_token.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, gh, gw, self.cfg, self.cfg.interpolate_antialias)
        if self.cfg.num_register_tokens:
            reg = self.register_tokens.expand(x.shape[0], -1, -1)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
        return x

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = images.shape[0]
        p = self.cfg.patch_size
        gh, gw = images.shape[1] // p, images.shape[2] // p
        x = self.tokens(images)
        FORWARD_COUNTS["images"] += b
        FORWARD_COUNTS["tokens"] += b * x.shape[1]
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        first = 1 + self.cfg.num_register_tokens
        return {"cls": x[:, 0], "patches": x[:, first:].reshape(b, gh, gw, -1)}


def init_vit(cfg: ViTConfig, generator: torch.Generator, device=None) -> ViT:
    """A `ViT` with random weights in the reference's shapes and scales
    (`init_vit_params`): dense N(0, 1/n_in), zero biases, patch, cls,
    register and position embeddings N(0, 0.02^2), unit norms, LayerScale at
    its init value. Drawn on the generator's device in one fixed order (a
    CPU generator: on the CPU, then moved to `device`, default the card), each
    weight in place: a CUDA generator draws a 1 B-parameter model on the card
    with no pass over its weights on the CPU."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = ViT(cfg)
    model = model.to_empty(device=generator.device)

    def normal_(t, std):
        t.normal_(generator=generator).mul_(std)

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ls1", "ls2"):
                p.fill_(cfg.layerscale_init)
            elif leaf == "weight" and "norm" in name:
                p.fill_(1.0)
            else:
                p.zero_()
        normal_(model.patch_embed.weight, 0.02)
        normal_(model.cls_token, 0.02)
        normal_(model.pos_embed, 0.02)
        if cfg.num_register_tokens:
            normal_(model.register_tokens, 0.02)
        for blk in model.blocks:
            ffn = (blk.w12, blk.w3) if blk.swiglu else (blk.fc1, blk.fc2)
            for lin in (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.proj, *ffn):
                normal_(lin.weight, 1.0 / math.sqrt(lin.in_features))
    return model.to(dev).eval()


def load_dinov2_state_dict(state_dict: Mapping[str, object], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """The port's `ViT` state dict from a DINOv2 checkpoint's (numpy- or
    tensor-valued), in either layout (the reference's `load_torch_state_dict`):

    * transformers `Dinov2Model`: `embeddings.*`, `encoder.layer.N.*`, separate
      `attention.attention.{query,key,value}`;
    * facebookresearch dinov2 / FeatUp backbone: `patch_embed.proj.*`,
      `blocks.N.*`, fused `attn.qkv`.

    Linear weights stay [out, in] and the patch weight stays OIHW, as the
    checkpoints hold them. A SwiGLU model's FFN is `mlp.weights_in` /
    `mlp.weights_out` (transformers) or `mlp.w12` / `mlp.w3` (facebook), its
    registers `embeddings.register_tokens` / `register_tokens`; the unused
    `mask_token` is left out. A tensor's values stay on its device (a
    checkpoint drawn on the card loads there); the result's tensors are the
    port's own copies. Load with `ViT(cfg).load_state_dict(...)`."""
    sd = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(torch.float32)
          for k, v in state_dict.items()}
    d = cfg.hidden_size
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src):
        out[dst] = sd[src].clone()

    # The FFN's two linears: (the port's name, transformers' and facebook's under `mlp.`).
    ffn = ((("w12", "weights_in", "w12"), ("w3", "weights_out", "w3")) if cfg.ffn == "swiglu"
           else (("fc1", "fc1", "fc1"), ("fc2", "fc2", "fc2")))

    if any(k.startswith("embeddings.") for k in sd):
        put("patch_embed.weight", "embeddings.patch_embeddings.projection.weight")
        put("patch_embed.bias", "embeddings.patch_embeddings.projection.bias")
        put("cls_token", "embeddings.cls_token")
        put("pos_embed", "embeddings.position_embeddings")
        put("norm.weight", "layernorm.weight")
        put("norm.bias", "layernorm.bias")
        if cfg.num_register_tokens:
            put("register_tokens", "embeddings.register_tokens")
        for i in range(cfg.num_layers):
            src, dst = f"encoder.layer.{i}.", f"blocks.{i}."
            for name, key in (("q", "query"), ("k", "key"), ("v", "value")):
                for p in ("weight", "bias"):
                    put(f"{dst}attn.{name}.{p}", f"{src}attention.attention.{key}.{p}")
            for p in ("weight", "bias"):
                put(f"{dst}attn.proj.{p}", f"{src}attention.output.dense.{p}")
                for part in ("norm1", "norm2"):
                    put(f"{dst}{part}.{p}", f"{src}{part}.{p}")
                for mine, theirs, _ in ffn:
                    put(f"{dst}{mine}.{p}", f"{src}mlp.{theirs}.{p}")
            put(f"{dst}ls1", f"{src}layer_scale1.lambda1")
            put(f"{dst}ls2", f"{src}layer_scale2.lambda1")
    else:
        put("patch_embed.weight", "patch_embed.proj.weight")
        put("patch_embed.bias", "patch_embed.proj.bias")
        put("cls_token", "cls_token")
        put("pos_embed", "pos_embed")
        put("norm.weight", "norm.weight")
        put("norm.bias", "norm.bias")
        if cfg.num_register_tokens:
            put("register_tokens", "register_tokens")
        for i in range(cfg.num_layers):
            src, dst = f"blocks.{i}.", f"blocks.{i}."
            qkv_w, qkv_b = sd[f"{src}attn.qkv.weight"], sd[f"{src}attn.qkv.bias"]
            for j, name in enumerate(("q", "k", "v")):
                out[f"{dst}attn.{name}.weight"] = qkv_w[j * d : (j + 1) * d].clone()
                out[f"{dst}attn.{name}.bias"] = qkv_b[j * d : (j + 1) * d].clone()
            for p in ("weight", "bias"):
                put(f"{dst}attn.proj.{p}", f"{src}attn.proj.{p}")
                for part in ("norm1", "norm2"):
                    put(f"{dst}{part}.{p}", f"{src}{part}.{p}")
                for mine, _, theirs in ffn:
                    put(f"{dst}{mine}.{p}", f"{src}mlp.{theirs}.{p}")
            put(f"{dst}ls1", f"{src}ls1.gamma")
            put(f"{dst}ls2", f"{src}ls2.gamma")
    return out
