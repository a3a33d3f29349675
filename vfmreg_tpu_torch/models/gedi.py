"""GeDi: the PointNet++ descriptor on canonicalized local patches.

Counterpart of `vfmreg_tpu/models/gedi.py`: the qnet quaternion T-net
(`_qnet`, `:86`; `_quat_to_matrix`, `:99`), the three PointNet++ SSG
set-abstraction modules (`_sa_module`, `:111`) on `ops/pointnet2.py`, the
FC head and L2 norm (`gedi_forward`, `:133`), the reference checkpoint's
layout (`load_gedi_state_dict`, `:206`), and the LRF patches
(`gedi_lrf_patches`, `:151`): z the smallest covariance direction of
(p - p_i) with its sign toward the mass, x the alpha * beta-weighted
in-plane sum, patch = lrf^T (p_i - p) / r, sampled from the valid
neighbour slots only. Plain PyTorch; the reference has no Pallas kernel
here.

The sampling draws, per patch, one uniform key per neighbour slot (the
valid slots sorted by key come first) and one replica per output slot past
the valid count. The reference draws them from `jax.random` keys; the port
draws the keys and the replica fractions on the CPU from a seeded
`torch.Generator` (a deliberate divergence: the same draw on the card and
on the CPU), or takes both injected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vfmreg_tpu_torch.geometry.linalg3 import cross3, eigh3
from vfmreg_tpu_torch.models.layers import batch_norm, dense, init_dense_, l2_rows, loaded
from vfmreg_tpu_torch.ops.pointnet2 import ball_query, furthest_point_sampling

R_LRF = 0.5
SAMPLES_PER_PATCH_OUT = 512


def _cbr1(n_in, n_out, relu=True):
    layers = [nn.Conv1d(n_in, n_out, 1, bias=False), nn.BatchNorm1d(n_out)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class _QNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _cbr1(3, 256)
        self.conv2 = _cbr1(256, 512)
        self.conv3 = _cbr1(512, 1024, relu=False)
        self.fc1 = nn.Sequential(nn.Linear(1024, 512, bias=False), nn.BatchNorm1d(512), nn.ReLU())
        self.fc2 = nn.Sequential(nn.Linear(512, 256, bias=False), nn.BatchNorm1d(256), nn.ReLU())
        self.fc3 = nn.Linear(256, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] -> unit quaternions (w, x, y, z) [B, 4]."""
        h = torch.relu(batch_norm(dense(x, self.conv1[0]), self.conv1[1]))
        h = torch.relu(batch_norm(dense(h, self.conv2[0]), self.conv2[1]))
        h = batch_norm(dense(h, self.conv3[0]), self.conv3[1])
        h = torch.amax(h, dim=1)
        h = torch.relu(batch_norm(dense(h, self.fc1[0]), self.fc1[1]))
        h = torch.relu(batch_norm(dense(h, self.fc2[0]), self.fc2[1]))
        q = dense(h, self.fc3) + torch.tensor([1.0, 0.0, 0.0, 0.0], device=h.device)
        return l2_rows(q)


class _SA(nn.Module):
    """PointnetSAModule (SSG): `mlps.0` is [Conv2d(bias=False), BN2d, ReLU]
    per layer, so the convs sit at 3i and the BNs at 3i + 1."""

    def __init__(self, spec, npoint=None, radius=None, nsample=None):
        super().__init__()
        layers = []
        for i in range(1, len(spec)):
            layers += [nn.Conv2d(spec[i - 1], spec[i], 1, bias=False), nn.BatchNorm2d(spec[i]), nn.ReLU()]
        self.mlps = nn.ModuleList([nn.Sequential(*layers)])
        self.npoint, self.radius, self.nsample = npoint, radius, nsample

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        """xyz [B, N, 3], features [B, N, C] or None -> (new_xyz, [B, S, C'])."""
        if self.npoint is None:  # group all
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
            gx = xyz[:, None]
            gf = None if features is None else features[:, None]
        else:
            fps = furthest_point_sampling(xyz, self.npoint, skip_near_origin=True)
            new_xyz = torch.gather(xyz, 1, fps[..., None].expand(-1, -1, 3))
            idx = ball_query(self.radius, self.nsample, xyz, new_xyz)  # [B, S, k]
            b, s, k = idx.shape
            flat = idx.reshape(b, s * k, 1)
            gx = torch.gather(xyz, 1, flat.expand(-1, -1, 3)).reshape(b, s, k, 3) - new_xyz[:, :, None]
            gf = None if features is None else torch.gather(
                features, 1, flat.expand(-1, -1, features.shape[-1])).reshape(b, s, k, -1)
        h = gx if gf is None else torch.cat([gx, gf], dim=-1)
        seq = self.mlps[0]
        for i in range(0, len(seq), 3):
            h = torch.relu(batch_norm(dense(h, seq[i]), seq[i + 1]))
        return new_xyz, torch.amax(h, dim=2)


class GeDiNet(nn.Module):
    """PointNet2Feature with the reference checkpoint's keys (`qnet.*`,
    `samodule{1,2,3}.mlps.0.*`, `fc_layer.{0,1,3,4,7}.*`)."""

    def __init__(self, dim: int = 32):
        super().__init__()
        self.qnet = _QNet()
        self.samodule1 = _SA([3, 128, 128, 128], npoint=128, radius=0.2, nsample=32)
        self.samodule2 = _SA([128 + 3, 256, 256, 256], npoint=64, radius=0.4, nsample=16)
        self.samodule3 = _SA([256 + 3, 512, 512, 1024])
        self.fc_layer = nn.Sequential(
            nn.Linear(1024, 512, bias=False), nn.BatchNorm1d(512), nn.ReLU(),
            nn.Linear(512, 256, bias=False), nn.BatchNorm1d(256), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(256, dim),
        )

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] canonicalized patches -> [B, dim] unit descriptors."""
        rm = quat_to_matrix(self.qnet(patches))
        pc = torch.einsum("bij,bnj->bni", rm, patches)
        xyz, feat = self.samodule1(pc, None)
        xyz, feat = self.samodule2(xyz, feat)
        _, feat = self.samodule3(xyz, feat)
        h = feat[:, 0]
        fc = self.fc_layer
        h = torch.relu(batch_norm(dense(h, fc[0]), fc[1]))
        h = torch.relu(batch_norm(dense(h, fc[3]), fc[4]))
        return l2_rows(dense(h, fc[7]))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) unit quaternions [..., 4] -> rotations [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def gedi_forward(net: GeDiNet, patches: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return net(patches)


def init_gedi_params(generator: torch.Generator, dim: int = 32, device=None) -> GeDiNet:
    """GeDiNet with the reference's random init (`init_gedi_params`, `:46`):
    N(0, 2 / n_in) weights, zero biases, identity BatchNorms; drawn on the
    CPU from `generator`, then moved to `device` (default: the card)."""
    net = GeDiNet(dim)
    for m in net.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            init_dense_(m, generator)
    return loaded(net, net.state_dict(), device)


def load_gedi_state_dict(state_dict, dim: int = 32, device=None) -> GeDiNet:
    """GeDiNet from the reference checkpoint (`chkpt.tar`'s
    `pnet_model_state_dict`; tensor- or numpy-valued), on `device`
    (default: the card)."""
    return loaded(GeDiNet(dim), state_dict, device)


def draw_patch_keys(n: int, k: int, generator: torch.Generator, device=None,
                    samples_per_patch_out: int = SAMPLES_PER_PATCH_OUT) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys [n, k], replica fractions [n, samples_per_patch_out]), uniform
    f32 drawn on the CPU and moved to `device`."""
    keys = torch.rand((n, k), generator=generator, dtype=torch.float32)
    frac = torch.rand((n, samples_per_patch_out), generator=generator, dtype=torch.float32)
    return keys.to(device), frac.to(device)


def replicas(frac: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """Replica slot indices in [0, count) from uniform fractions [n, S]."""
    cnt = torch.clamp(nbr_mask.sum(dim=1, keepdim=True), min=1)
    return torch.minimum(torch.floor(frac * cnt.to(torch.float32)).to(torch.int64), cnt - 1)


def gedi_lrf_patches(
    centers: torch.Tensor,  # [B, 3]
    nbr_pts: torch.Tensor,  # [B, K, 3]
    nbr_mask: torch.Tensor,  # [B, K]
    keys: torch.Tensor,  # [B, K] uniform sort keys of the slots
    replica: torch.Tensor,  # [B, S] int64 in [0, count)
    r_lrf: float = R_LRF,
) -> torch.Tensor:
    """GeDi's LRF canonicalization (`LRF._forward` + `forward`,
    `gedi.py:84-141`): [B, S, 3] patches, S = replica.shape[1]."""
    m = nbr_mask.to(torch.float32)
    x = (centers[:, None, :] - nbr_pts) * m[..., None]  # p - p_i, zero-masked
    k = nbr_pts.shape[1]
    cov = torch.einsum("bki,bkj->bij", x, x) / k  # divided by K, as the reference
    _, vecs = eigh3(cov)
    v_small = vecs[..., 0]
    proj = torch.einsum("bki,bi->bk", x, v_small)
    sign = torch.where(proj.sum(dim=1) >= 0, 1.0, -1.0)
    zp = sign[:, None] * v_small
    xi = -x
    norm = torch.einsum("bki,bi->bk", xi, zp)
    vi = xi - norm[..., None] * zp[:, None, :]
    alpha = (r_lrf - torch.linalg.vector_norm(xi, dim=-1)) ** 2
    beta = norm * norm
    vi_c = ((alpha * beta * m)[..., None] * vi).sum(dim=1)
    xp = vi_c / torch.clamp(torch.linalg.vector_norm(vi_c, dim=-1, keepdim=True), min=1e-12)
    yp = cross3(xp, zp)
    lrf = torch.stack([xp, yp, zp], dim=2)

    order = torch.argsort(torch.where(nbr_mask, keys, 1.0 + keys), dim=1, stable=True)
    cnt = torch.clamp(nbr_mask.sum(dim=1, keepdim=True), min=1)
    s = replica.shape[1]
    pos = torch.arange(s, device=centers.device)[None, :]
    first = torch.gather(order, 1, torch.clamp(pos, max=k - 1).expand(order.shape[0], -1))
    rep = torch.gather(order, 1, replica)
    sel = torch.where(pos < cnt, first, rep)
    local = torch.einsum("bki,bij->bkj", (nbr_pts - centers[:, None, :]) / r_lrf, lrf)
    out = torch.gather(local, 1, sel[..., None].expand(-1, -1, 3))
    return torch.where(nbr_mask.any(dim=1)[:, None, None], out, 0.0)
