"""DIP (Distinctive Invariant Patches): the PointNet descriptor and its LRF patches.

Counterpart of `vfmreg_tpu/models/dip.py`: the PointNetFeature network
(STN3d T-net, three 1 x 1 convolutions, max pool, three FC layers, 32-d L2-
normalized output; `dip_forward`, `:84`), the reference checkpoint's layout
(`load_dip_state_dict`, `:99`), and the local reference frame patches
(`compute_lrf_patches`, `:136`): per point, the covariance of its in-radius
neighbours about it, the smallest eigenvector as z with its sign toward the
neighbours, the alpha * beta-weighted in-plane x axis, and the neighbours in
that frame over the kernel radius, zero-padded and randomly subsampled to
`PATCH_SIZE`. Plain PyTorch; the reference has no Pallas kernel here.

The eigenvectors come from `geometry/linalg3.eigh3` (cuSOLVER refuses
batches of this size). Their sign does not matter: z takes the sign that
points toward the neighbours, from the vector either solver returns. Its direction
matters only where the two smallest eigenvalues tie (a degenerate
neighbourhood), as it does in the reference.

The subsample draws a permutation per point. The reference draws it from
`jax.random` keys; the port draws it on the CPU from a seeded
`torch.Generator` (a deliberate divergence: the same draw on the card and
on the CPU), or takes it injected (`perm`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from vfmreg_tpu_torch.models.layers import batch_norm, dense, init_dense_, l2_rows, loaded
from vfmreg_tpu_torch.geometry.linalg3 import cross3, eigh3

PATCH_SIZE = 256  # descriptors.py:47
LRF_KERNEL = 0.6 * math.sqrt(3)  # descriptors.py:66


def _cbr(n_in: int, n_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(n_in, n_out, 1), nn.BatchNorm1d(n_out), nn.ReLU())


class _Tower(nn.Module):
    """conv1-3 -> max pool -> fc1-3 (`network.py:6-96`); the main tower's
    fc2 has a Dropout before its BatchNorm, which moves it to index 2."""

    def __init__(self, out_dim: int, dropout_in_fc2: bool):
        super().__init__()
        self.conv1 = _cbr(3, 256)
        self.conv2 = _cbr(256, 512)
        self.conv3 = nn.Sequential(nn.Conv1d(512, 1024, 1), nn.BatchNorm1d(1024))
        self.fc1 = nn.Sequential(nn.Linear(1024, 512), nn.BatchNorm1d(512), nn.ReLU())
        fc2 = [nn.Linear(512, 256)] + ([nn.Dropout(p=0.3)] if dropout_in_fc2 else [])
        self.fc2 = nn.Sequential(*fc2, nn.BatchNorm1d(256), nn.ReLU())
        self.fc3 = nn.Sequential(nn.Linear(256, out_dim))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, 3] -> [B, out_dim]."""
        h = torch.relu(batch_norm(dense(x, self.conv1[0]), self.conv1[1]))
        h = torch.relu(batch_norm(dense(h, self.conv2[0]), self.conv2[1]))
        h = batch_norm(dense(h, self.conv3[0]), self.conv3[1])
        h = torch.amax(h, dim=1)
        h = torch.relu(batch_norm(dense(h, self.fc1[0]), self.fc1[1]))
        h = torch.relu(batch_norm(dense(h, self.fc2[0]), self.fc2[-2]))
        return dense(h, self.fc3[0])


class DIPNet(nn.Module):
    """PointNetFeature with the reference checkpoint's keys: `stn3d.*` and
    the main tower's `conv1.0.weight`, ..., `fc3.0.bias` at the top level."""

    def __init__(self, dim: int = 32):
        super().__init__()
        self.stn3d = _Tower(9, dropout_in_fc2=False)
        tower = _Tower(dim, dropout_in_fc2=True)
        for name in ("conv1", "conv2", "conv3", "fc1", "fc2", "fc3"):
            setattr(self, name, getattr(tower, name))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] patches -> [B, dim] unit descriptors (`dip_forward`)."""
        iden = torch.eye(3, dtype=patches.dtype, device=patches.device).reshape(9)
        trans = (self.stn3d.run(patches) + iden).reshape(-1, 3, 3)
        x = torch.einsum("bij,bnj->bni", trans, patches)
        return l2_rows(_Tower.run(self, x))


def dip_forward(net: DIPNet, patches: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return net(patches)


def init_dip_params(generator: torch.Generator, dim: int = 32, device=None) -> DIPNet:
    """DIPNet with the reference's random init (`init_dip_params`, `:45`):
    N(0, 2 / n_in) weights, zero biases, identity BatchNorms; drawn on the
    CPU from `generator`, then moved to `device` (default: the card)."""
    net = DIPNet(dim)
    for m in net.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            init_dense_(m, generator)
    return loaded(net, net.state_dict(), device)


def load_dip_state_dict(state_dict, dim: int = 32, device=None) -> DIPNet:
    """DIPNet from the reference checkpoint (`dip/final_chkpt.pth`; tensor-
    or numpy-valued), on `device` (default: the card)."""
    return loaded(DIPNet(dim), state_dict, device)


def draw_patch_perm(n: int, k: int, generator: torch.Generator, device=None,
                    patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """[n, patch_size] int64 on `device`: for each point, the first
    `patch_size` slots of a uniform permutation of its `k` neighbour slots.
    The keys are drawn on the CPU and sorted (stable) where they land, so
    the card and the CPU draw the same permutations."""
    u = torch.rand((n, k), generator=generator, dtype=torch.float32).to(device)
    return torch.argsort(u, dim=1, stable=True)[:, :patch_size]


def compute_lrf_patches(
    points: torch.Tensor,  # [P, 3] the cloud
    nbr_idx: torch.Tensor,  # [N, K] neighbour rows of `points`
    nbr_mask: torch.Tensor,  # [N, K]
    perm: torch.Tensor,  # [N, patch_size] slots of the subsample (draw_patch_perm)
    centers: Optional[torch.Tensor] = None,  # [N, 3]; default: `points`
    lrf_kernel: float = LRF_KERNEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRF + patch per centre (`lrf.py:21-82`): (patches [N, patch_size, 3],
    frames [N, 3, 3] with columns x, y, z)."""
    centers = points if centers is None else centers
    diff = points[nbr_idx] - centers[:, None, :]  # [N, K, 3]
    w = nbr_mask.to(torch.float32)
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    cov = torch.einsum("nki,nk,nkj->nij", diff, w, diff) / cnt[:, None, None]
    _, vecs = eigh3(cov)
    np_hat = vecs[..., 0]
    proj = torch.einsum("nki,ni->nk", diff, np_hat)
    zp_sign = torch.where((-proj * w).sum(dim=1) > 0, 1.0, -1.0)
    zp = np_hat * zp_sign[:, None]
    h = torch.einsum("nki,ni->nk", diff, zp)
    v = diff - h[..., None] * zp[:, None, :]
    dist = torch.linalg.vector_norm(diff, dim=-1)
    alpha = (lrf_kernel - dist) ** 2
    beta = h**2
    xp = (v * (alpha * beta * w)[..., None]).sum(dim=1)
    xp = xp / torch.clamp(torch.linalg.vector_norm(xp, dim=-1, keepdim=True), min=1e-12)
    yp = cross3(xp, zp)
    lrg = torch.stack([xp, yp, zp], dim=2)  # columns
    local = torch.einsum("nki,nij->nkj", diff, lrg) / lrf_kernel
    local = torch.where(nbr_mask[..., None], local, 0.0)
    patches = torch.gather(local, 1, perm.to(local.device)[..., None].expand(-1, -1, 3))
    return patches, lrg
