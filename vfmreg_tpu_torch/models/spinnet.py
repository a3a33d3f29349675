"""SpinNet: the cylindrical-volume descriptor, KITTI configuration.

Counterpart of `vfmreg_tpu/models/spinnet.py`: Descriptor_Net(des_r=2.0,
rad_n=9, azi_n=60, ele_n=30, voxel_r=0.3, voxel_sample=30, 'KITTI'), with
no z-axis canonicalization for KITTI. Per patch of points around a
keypoint (its last point):

1. the spherical partition: an S2 grid of ele_n x azi_n directions at rad_n
   radial shells (`s2_grid`, `get_voxel_coordinate`);
2. `sphere_query_rel`: a ball query (r = 0.3, 30 samples) around each voxel
   centre, the padding slots zeroed (`common.py:438-476`);
3. `var_to_invar`: each azimuth bin rotated by -i 2 pi / azi_n about z;
4. `spinnet_trunk`: a 1 x 1 point lift (3 -> 16) with BatchNorm and ReLU,
   max over the samples, then Cylindrical_Net: four Conv3d (k 3, no
   padding along the radius) and seven dilated Conv2d (dilations 1, 2, 2,
   4, 4, 8, 16), circular azimuth and zero elevation padding, non-affine
   BatchNorms, global max pool -> 32-d.

The convolutions are `torch.nn.functional.conv3d` / `conv2d` where the
reference calls `lax.conv_general_dilated` (no Pallas kernel is involved);
with `utils.precision.full_precision` cuDNN runs them in f32, not TF32.
The module keeps the checkpoint's keys (`xyz_raising.*`,
`bn_xyz_raising.*`, `bn_mapping.*`, `conv_net.ops.{i}.*`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfmreg_tpu_torch.models.layers import BN_EPS, init_dense_, loaded, randn
from vfmreg_tpu_torch.ops.pointnet2 import ball_query

RAD_N, AZI_N, ELE_N = 9, 60, 30
VOXEL_R, VOXEL_SAMPLE = 0.3, 30
_CONV3D_CHANNELS = (32, 32, 64, 64)
# (out, kernel, dilation, batch norm, relu); the last conv's out is `dim`.
_CONV2D_SPECS = (
    (128, 3, 1, True, True),
    (128, 3, 2, True, True),
    (64, 3, 2, True, True),
    (64, 3, 4, True, True),
    (32, 2, 4, True, False),
    (32, 2, 8, True, False),
    (32, 2, 16, False, False),
)


def s2_grid(n_alpha: int, n_beta: int) -> np.ndarray:
    """(beta, alpha) ring grid (`common.py:279-292`)."""
    beta = np.linspace(0, np.pi, n_beta, endpoint=False) + np.pi / n_beta / 2
    alpha = np.linspace(0, 2 * np.pi, n_alpha, endpoint=False) + np.pi / n_alpha
    B, A = np.meshgrid(beta, alpha, indexing="ij")
    return np.stack((B.flatten(), A.flatten()), axis=1)


def get_voxel_coordinate(radius: float, rad_n: int, azi_n: int, ele_n: int) -> np.ndarray:
    """[rad_n * ele_n * azi_n, 3] f64 voxel centres (`common.py:415-421`)."""
    grid = s2_grid(n_alpha=azi_n, n_beta=ele_n)
    beta, alpha = grid[:, 0], grid[:, 1]
    xyz = np.stack([np.sin(beta) * np.cos(alpha), np.sin(beta) * np.sin(alpha), np.cos(beta)], axis=-1) * radius
    xyz = np.repeat(xyz[None], rad_n, axis=0)
    scale = (np.arange(rad_n) / rad_n + 1 / (2 * rad_n)).reshape(rad_n, 1, 1)
    return (scale * xyz).reshape(-1, 3)


def _rotz(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def var_to_invar(pts: torch.Tensor, rad_n: int, azi_n: int, ele_n: int) -> torch.Tensor:
    """[B, N, k, 3] -> azimuth-aligned coordinates (`common.py:522-548`)."""
    b, n, k, _ = pts.shape
    R = torch.as_tensor(np.stack([_rotz(-i * 2 * np.pi / azi_n) for i in range(azi_n)]),
                        dtype=pts.dtype, device=pts.device)
    x = pts.reshape(b, rad_n, ele_n, azi_n, k, 3)
    out = torch.einsum("breakc,adc->breakd", x, R)
    return out.reshape(b, n, k, 3)


def sphere_query_rel(patch_pts: torch.Tensor, grid_pts: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """patch_pts [B, P, 3], grid_pts [N, 3] -> [B, N, k, 3]: the in-voxel
    samples relative to their voxel centre, padding slots (those repeating
    slot 0) zeroed (`model.py:53-60`)."""
    b = patch_pts.shape[0]
    centers = grid_pts[None].expand(b, -1, -1)
    idx = ball_query(radius, nsample, patch_pts, centers)  # [B, N, k]
    n, k = idx.shape[1:]
    grouped = torch.gather(patch_pts, 1, idx.reshape(b, n * k, 1).expand(-1, -1, 3)).reshape(b, n, k, 3)
    pad = idx == idx[:, :, 0:1]
    pad[:, :, 0] = False
    rel = grouped - grid_pts[None, :, None, :]
    return torch.where(pad[..., None], 0.0, rel)


def _pad_ele_azi(x: torch.Tensor, eff_k: int) -> torch.Tensor:
    """Circular pad on azimuth (last axis), zero pad on elevation (the one
    before it) (`common.py:295-344`)."""
    if eff_k % 2 == 0:
        p = eff_k // 2
        x = torch.cat([x, x[..., :p]], dim=-1)
        zeros = x.new_zeros(x.shape[:-2] + (p, x.shape[-1]))
        return torch.cat([x, zeros], dim=-2)
    p = (eff_k - 1) // 2
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    zeros = x.new_zeros(x.shape[:-2] + (p, x.shape[-1]))
    return torch.cat([zeros, x, zeros], dim=-2)


def _bn_channels(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """Eval BatchNorm over axis 1 of x [B, C, ...]."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - bn.running_mean.reshape(shape)) * torch.rsqrt(bn.running_var.reshape(shape) + BN_EPS)
    if bn.weight is not None:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    return y


class _CylindricalNet(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        ops = []
        c = 16
        for out in _CONV3D_CHANNELS:
            ops += [nn.Conv3d(c, out, 3), nn.BatchNorm3d(out, affine=False), nn.ReLU()]
            c = out
        for i, (out, k, d, bn, relu) in enumerate(_CONV2D_SPECS):
            out = dim if i == len(_CONV2D_SPECS) - 1 else out
            ops.append(nn.Conv2d(c, out, k, dilation=d))
            ops += [nn.BatchNorm2d(out, affine=False)] if bn else []
            ops += [nn.ReLU()] if relu else []
            c = out
        self.ops = nn.ModuleList(ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 16, rad, ele, azi] -> [B, dim, ele, azi]."""
        for op in self.ops:
            if isinstance(op, nn.Conv3d):
                x = F.conv3d(_pad_ele_azi(x, 3), op.weight, op.bias)
            elif isinstance(op, nn.Conv2d):
                if x.ndim == 5:
                    x = x[:, :, 0]  # the radius collapsed to 1
                k, d = op.kernel_size[0], op.dilation[0]
                x = F.conv2d(_pad_ele_azi(x, k + (k - 1) * (d - 1)), op.weight, op.bias, dilation=d)
            elif isinstance(op, nn.ReLU):
                x = torch.relu(x)
            else:
                x = _bn_channels(x, op)
        return x


class SpinNet(nn.Module):
    """Descriptor_Net's learned part with the checkpoint's keys."""

    def __init__(self, dim: int = 32):
        super().__init__()
        self.xyz_raising = nn.Conv2d(3, 16, 1)
        self.bn_xyz_raising = nn.BatchNorm2d(16)
        self.bn_mapping = nn.BatchNorm2d(16)  # in the checkpoint; unused by the KITTI forward
        self.conv_net = _CylindricalNet(dim)


def spinnet_trunk(net: SpinNet, rel: torch.Tensor, rad_n: int = RAD_N, azi_n: int = AZI_N,
                  ele_n: int = ELE_N) -> torch.Tensor:
    """rel [B, N, k, 3] azimuth-aligned in-voxel samples -> [B, dim]
    (`model.py:60-72` + `ThreeDCCN.py:57-97`)."""
    with torch.no_grad():
        w = net.xyz_raising.weight[:, :, 0, 0]  # [16, 3]
        h = torch.matmul(rel, w.t()) + net.xyz_raising.bias
        bn = net.bn_xyz_raising
        h = (h - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS) * bn.weight + bn.bias
        h = torch.amax(torch.relu(h), dim=2)  # [B, N, 16]
        b = h.shape[0]
        x = h.reshape(b, rad_n, ele_n, azi_n, -1).permute(0, 4, 1, 2, 3).contiguous()
        x = net.conv_net(x)
        return torch.amax(x, dim=(2, 3))


def spinnet_forward(
    net: SpinNet,
    patches: torch.Tensor,  # [B, P, 3], the keypoint last
    grid_pts: torch.Tensor,  # [rad * ele * azi, 3] f32
    rad_n: int = RAD_N,
    azi_n: int = AZI_N,
    ele_n: int = ELE_N,
    voxel_r: float = VOXEL_R,
    voxel_sample: int = VOXEL_SAMPLE,
) -> torch.Tensor:
    """[B, P, 3] patches -> [B, dim] descriptors (`Descriptor_Net.forward`)."""
    delta = patches - patches[:, -1:, :]  # KITTI: no z-axis canonicalization
    rel = sphere_query_rel(delta, grid_pts, voxel_r, voxel_sample)
    rel = var_to_invar(rel, rad_n, azi_n, ele_n)
    return spinnet_trunk(net, rel, rad_n, azi_n, ele_n)


def init_spinnet_params(generator: torch.Generator, dim: int = 32, device=None) -> SpinNet:
    """SpinNet with the reference's random init (`init_spinnet_params`,
    `:107`): the lift N(0, 0.3^2), each conv N(0, 2 / fan_in), zero biases,
    identity BatchNorms; drawn on the CPU from `generator`, then moved to
    `device` (default: the card)."""
    net = SpinNet(dim)
    with torch.no_grad():
        net.xyz_raising.weight.copy_(randn(net.xyz_raising.weight.shape, generator, 0.3))
        net.xyz_raising.bias.zero_()
    for m in net.conv_net.ops:
        if isinstance(m, (nn.Conv3d, nn.Conv2d)):
            init_dense_(m, generator, math.sqrt(2.0 / m.weight[0].numel()))
    return loaded(net, net.state_dict(), device)


def load_spinnet_state_dict(state_dict, dim: int = 32, device=None) -> SpinNet:
    """SpinNet from the reference checkpoint (`KITTI_best.pkl`, a
    DataParallel `module.` prefix dropped; tensor- or numpy-valued), on
    `device` (default: the card)."""
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}
    return loaded(SpinNet(dim), sd, device)
