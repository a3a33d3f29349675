"""Layers shared by the baseline descriptor networks and PointDSC.

The networks keep the reference checkpoints' module layout (`nn.Conv1d`,
`nn.Linear`, `nn.BatchNorm*` inside `nn.Sequential`s at the checkpoint's
indices), so a reference state dict loads with `load_state_dict` as it is.
Their forwards do not call those modules: every 1 x 1 convolution and
linear layer is a matmul on channels-last tensors, and every BatchNorm the
eval-mode affine map written out as the reference computes it,
(x - mean) * rsqrt(var + eps) * gamma + beta.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

BN_EPS = 1e-5


def dense(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """x [..., in] through a Linear or a 1 x 1 Conv1d / Conv2d: [..., out]."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)
    y = torch.matmul(x, w.t())
    return y if layer.bias is None else y + layer.bias


def batch_norm(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of x [..., C]."""
    y = (x - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS)
    if bn.weight is not None:
        y = y * bn.weight + bn.bias
    return y


def l2_rows(h: torch.Tensor) -> torch.Tensor:
    """h / max(|h|, 1e-12) over the last axis."""
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)


def randn(shape, generator: torch.Generator, std: float) -> torch.Tensor:
    """N(0, std^2) drawn on the CPU from `generator`."""
    return torch.randn(shape, generator=generator, dtype=torch.float32) * std


@torch.no_grad()
def init_dense_(layer: nn.Module, generator: torch.Generator, std: Optional[float] = None) -> None:
    """The reference's dense init: N(0, 2 / n_in) weights (or N(0, std^2)),
    zero bias."""
    w = layer.weight
    n_in = w[0].numel()
    layer.weight.copy_(randn(w.shape, generator, math.sqrt(2.0 / n_in) if std is None else std))
    if layer.bias is not None:
        layer.bias.zero_()


def loaded(module: nn.Module, state_dict, device=None) -> nn.Module:
    """`module` with a reference state dict (tensor- or numpy-valued, every
    key of the module present) loaded, in eval mode, on `device` (default:
    the card)."""
    import numpy as np

    from vfmreg_tpu_torch.utils.device import resolve_device

    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    module.load_state_dict({k: sd[k].to(own[k].dtype) for k in own})
    return module.eval().to(resolve_device(device))
