"""Sparse ResUNet family (the FCGF and GCL backbones) on the gather-based sparse convolution.

Counterpart of `vfmreg_tpu/models/sparse_resunet.py`, which covers the
reference's MinkowskiEngine models:
  * FCGF `ResUNetBN2C`: channels 32/64/128/256, TR channels 64/64/64/128,
    conv1 kernel 7;
  * GCL `ResUNetFatBN`: TR channels 128/128/128/256, conv1 kernel 5;
both with the forward order conv -> norm -> block -> relu and a 32-d
L2-normalised output.

A 4-level U-Net over strides 1/2/4/8 with BasicBlockBN residual blocks,
stride-2 down convolutions, transposed stride-2 up convolutions emitting
onto the skip level's coordinates, skip concatenation, a 1 x 1 convolution
and a final 1 x 1 with bias. Plain PyTorch (gathers and matmuls,
`ops/sparse_conv.py`); the reference has no Pallas kernel here.

`SparseResUNet` keeps the MinkowskiEngine checkpoint's layout (FCGF's
`2019-07-31_19-37-00.pth` ['state_dict'], GCL's `kitti_chkpt.pth`):
`<conv>.kernel` [K, C_in, C_out] (2-D [C_in, C_out] for the 1 x 1
convolutions), `<norm>.bn.{weight,bias,running_mean,running_var}`,
`final.bias` [1, C_out], so such a state dict loads as it is
(`load_me_state_dict`). The coarser levels run at their exact sizes: an
output row depends only on the rows it reads, BatchNorm uses its running
statistics, and the order of a level's coordinates changes no output row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from vfmreg_tpu_torch.models.layers import batch_norm, loaded, randn
from vfmreg_tpu_torch.ops.sparse_conv import (
    build_coord_lookup, downsample_coords, kernel_map, kernel_offsets, sparse_conv_apply,
    sparse_conv_apply_map,
)


@dataclasses.dataclass(frozen=True)
class ResUNetConfig:
    in_channels: int = 1
    out_channels: int = 32
    channels: Tuple[int, ...] = (32, 64, 128, 256)
    tr_channels: Tuple[int, ...] = (64, 64, 64, 128)
    conv1_kernel_size: int = 7


FCGF_CONFIG = ResUNetConfig()
GCL_CONFIG = ResUNetConfig(tr_channels=(128, 128, 128, 256), conv1_kernel_size=5)

# The reference model zoo's names (FCGF's ResUNet family, GCL's
# load-model-by-class-name).
MODEL_REGISTRY = {
    "ResUNetBN2C": FCGF_CONFIG,
    "ResUNetBN2": ResUNetConfig(tr_channels=(32, 64, 64, 128)),
    "ResUNetBN2B": ResUNetConfig(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 64)),
    "ResUNetBN2D": ResUNetConfig(tr_channels=(64, 64, 128, 128)),
    "ResUNetBN2E": ResUNetConfig(tr_channels=(128, 128, 128, 128)),
    "ResUNetFatBN": GCL_CONFIG,
}


def load_model(name: str) -> ResUNetConfig:
    """The configuration of a model-zoo name."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


class _Conv(nn.Module):
    """A MinkowskiConvolution's weights: `kernel` [K, C_in, C_out], stored
    [C_in, C_out] when K = 1 (the checkpoint's layout)."""

    def __init__(self, k: int, c_in: int, c_out: int, bias: bool = False):
        super().__init__()
        n = k**3
        self.kernel = nn.Parameter(torch.zeros((n, c_in, c_out) if n > 1 else (c_in, c_out)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(1, c_out))

    def w(self) -> torch.Tensor:
        return self.kernel if self.kernel.ndim == 3 else self.kernel[None]


class _Norm(nn.Module):
    """A MinkowskiBatchNorm: the statistics under `.bn`."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = nn.BatchNorm1d(c)


class _Block(nn.Module):
    """BasicBlockBN: conv-bn-relu-conv-bn, the residual, relu."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.norm1 = _Conv(3, c, c), _Norm(c)
        self.conv2, self.norm2 = _Conv(3, c, c), _Norm(c)

    def run(self, feats, rows, mask) -> torch.Tensor:
        h = torch.relu(batch_norm(sparse_conv_apply_map(feats, rows, mask, self.conv1.w()), self.norm1.bn))
        h = batch_norm(sparse_conv_apply_map(h, rows, mask, self.conv2.w()), self.norm2.bn)
        return torch.relu(h + feats)


class SparseResUNet(nn.Module):
    """The ResUNet of `cfg` with the MinkowskiEngine checkpoint's keys."""

    def __init__(self, cfg: ResUNetConfig):
        super().__init__()
        self.cfg = cfg
        C = (None,) + tuple(cfg.channels)
        T = (None,) + tuple(cfg.tr_channels)
        self.conv1, self.norm1, self.block1 = _Conv(cfg.conv1_kernel_size, cfg.in_channels, C[1]), _Norm(C[1]), _Block(C[1])
        for i in (2, 3, 4):
            setattr(self, f"conv{i}", _Conv(3, C[i - 1], C[i]))
            setattr(self, f"norm{i}", _Norm(C[i]))
            setattr(self, f"block{i}", _Block(C[i]))
        for i, c_in in ((4, C[4]), (3, C[3] + T[4]), (2, C[2] + T[3])):
            setattr(self, f"conv{i}_tr", _Conv(3, c_in, T[i]))
            setattr(self, f"norm{i}_tr", _Norm(T[i]))
            setattr(self, f"block{i}_tr", _Block(T[i]))
        self.conv1_tr = _Conv(1, C[1] + T[2], T[1])
        self.final = _Conv(1, T[1], cfg.out_channels, bias=True)

    def forward(self, coords: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """coords [N, 3] int32 quantized coordinates (stride 1), feats
        [N, C_in], mask [N] -> [N, out_channels] features, zero rows where
        `mask` is False."""
        cfg = self.cfg
        # Level coordinate sets and lookups (strides 1, 2, 4, 8); the coarser
        # levels cut to their occupied rows (one read each).
        levels = [(coords, mask, build_coord_lookup(coords, mask))]
        stride = 1
        for _ in range(3):
            c, m = downsample_coords(levels[-1][0], levels[-1][1], stride)
            n = max(int(m.sum()), 1)
            c, m = c[:n], m[:n]
            stride *= 2
            levels.append((c, m, build_coord_lookup(c, m)))

        maps: Dict[tuple, torch.Tensor] = {}

        def rows(lvl_in, lvl_out, sign, stride_units, k=3):
            """The kernel map of a k^3 convolution, shared by every
            convolution with the same levels and offsets."""
            key = (lvl_in, lvl_out, sign, stride_units, k)
            if key not in maps:
                _, m_in, lk_in = levels[lvl_in]
                c_out, m_out, _ = levels[lvl_out]
                maps[key] = kernel_map(lk_in, m_in, c_out, m_out, sign * kernel_offsets(k, stride_units))
            return maps[key]

        def after_norm(h, i, lvl, stride_units, block):
            """norm -> block -> relu; (skip, next input)."""
            h = batch_norm(h, getattr(self, f"norm{i}").bn)
            h = block.run(h, rows(lvl, lvl, 1, stride_units), levels[lvl][1])
            return h, torch.relu(h)

        # conv1: one lookup per offset (its 343-offset map would be large).
        c0, m0, lk0 = levels[0]
        h = sparse_conv_apply(feats.to(torch.float32), c0, lk0, m0, c0, m0, self.conv1.w(),
                              kernel_offsets(cfg.conv1_kernel_size, 1))
        s1, out = after_norm(h, "1", 0, 1, self.block1)
        skips = [s1]
        for i, (lvl, s) in zip((2, 3, 4), ((1, 1), (2, 2), (3, 4))):
            h = sparse_conv_apply_map(out, rows(lvl - 1, lvl, 1, s), levels[lvl][1], getattr(self, f"conv{i}").w())
            skip, out = after_norm(h, str(i), lvl, 2 * s, getattr(self, f"block{i}"))
            skips.append(skip)

        # Decoder: transposed connectivity x = y - o, in units of the OUTPUT
        # stride. FCGF concatenates the pre-relu skips; GCL's are the block
        # outputs: both are `skips` here.
        for i, (lvl, s) in zip((4, 3, 2), ((3, 4), (2, 2), (1, 1))):
            h = sparse_conv_apply_map(out, rows(lvl, lvl - 1, -1, s), levels[lvl - 1][1],
                                      getattr(self, f"conv{i}_tr").w())
            _, out = after_norm(h, f"{i}_tr", lvl - 1, s, getattr(self, f"block{i}_tr"))
            out = torch.cat([out, skips[i - 2]], dim=-1)

        out = torch.relu(sparse_conv_apply_map(out, rows(0, 0, 1, 1, k=1), m0, self.conv1_tr.w()))
        out = sparse_conv_apply_map(out, rows(0, 0, 1, 1, k=1), m0, self.final.w()) + self.final.bias
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)
        return torch.where(m0[:, None], out, 0.0)


def resunet_forward(net: SparseResUNet, coords, feats, mask) -> torch.Tensor:
    with torch.no_grad():
        return net(coords, feats, mask)


def _me_layout(net: SparseResUNet, state_dict) -> Dict[str, torch.Tensor]:
    """A MinkowskiEngine state dict in `net`'s layout: 1 x 1 kernels stored
    either [C_in, C_out] or [1, C_in, C_out], `num_batches_tracked` (which
    no forward reads) filled in where the checkpoint lacks it."""
    import numpy as np

    own = net.state_dict()
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, torch.zeros((), dtype=torch.int64))
        elif k in sd and sd[k].shape != v.shape and sd[k].numel() == v.numel():
            sd[k] = sd[k].reshape(v.shape)
    return sd


def load_me_state_dict(state_dict, cfg: ResUNetConfig, device=None) -> SparseResUNet:
    """The network from a MinkowskiEngine checkpoint's state dict (tensor-
    or numpy-valued), on `device` (default: the card)."""
    net = SparseResUNet(cfg)
    return loaded(net, _me_layout(net, state_dict), device)


def init_resunet_params(generator: torch.Generator, cfg: ResUNetConfig, device=None) -> SparseResUNet:
    """The network with the reference's random init (`init_resunet_params`):
    N(0, 2 / (K C_in)) kernels in the reference's order, identity
    BatchNorms, a zero final bias; drawn on the CPU from `generator`, then
    moved to `device` (default: the card)."""
    net = SparseResUNet(cfg)
    order = []
    for i in ("1", "2", "3", "4", "4_tr", "3_tr", "2_tr"):
        order += [f"conv{i}", f"block{i}.conv1", f"block{i}.conv2"]
    convs = dict(net.named_modules())
    with torch.no_grad():
        for name in order + ["conv1_tr", "final"]:
            w = convs[name].kernel
            n, c_in = (w.shape[0], w.shape[1]) if w.ndim == 3 else (1, w.shape[0])
            w.copy_(randn(w.shape, generator, math.sqrt(2.0 / (n * c_in))))
    return loaded(net, net.state_dict(), device)
