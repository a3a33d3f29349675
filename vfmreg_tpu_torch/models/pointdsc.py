"""PointDSC: deep spatial-consistency outlier rejection of correspondences.

Counterpart of `vfmreg_tpu/models/pointdsc.py`, at the scene loop's
configuration (`registration_node.py:232-241`): in_dim 6, 12 layers of 128
channels, 10 power iterations, seed ratio 0.1, sigma_d 1.2, k 40, NMS
radius 0.6, inlier threshold 0.10 (also in the post refinement).

* `pointdsc_encode` (`:104`): the NonLocal encoder and the confidence MLP;
  padding columns stay out of every softmax, so padding rows are inert;
* `pointdsc_forward` (`:134`): spatial compatibility, confidence, parallel
  NMS seeds, per seed the k-NN consistency matrix in feature space and its
  leading eigenvector by power iteration, a weighted Procrustes per seed
  (`registration/procrustes.weighted_kabsch`), the hypothesis with the most
  inliers, and the post refinement that stops once the inlier count stops
  changing;
* `PointDSCModel.register` (`:310`): at most `max_corr` correspondences
  (evenly subsampled), padded to 512-doubling buckets, the seed count the
  reference's n / 10 rounded up to a multiple of 32;
* `get_pointdsc_model` (`:339`): the weights from `VFMREG_POINTDSC_WEIGHTS`,
  `FileNotFoundError` without them, as the reference.

The [N, N] products are plain `torch.matmul`; the reference computes them
outside Pallas too. Sorts are stable, as `jnp.argsort` is. The module keeps
the checkpoint's keys (`encoder.layer0`, `encoder.blocks.PointCN_layer_i`,
`encoder.blocks.NonLocal_layer_i.{projection_q,k,v,fc_message}`,
`classification`, `sigma`, `sigma_spat`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vfmreg_tpu_torch.models.layers import batch_norm, dense, init_dense_, loaded
from vfmreg_tpu_torch.registration.procrustes import weighted_kabsch
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision


class _NonLocal(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc_message = nn.Sequential(
            nn.Conv1d(c, c // 2, 1), nn.BatchNorm1d(c // 2), nn.ReLU(),
            nn.Conv1d(c // 2, c // 2, 1), nn.BatchNorm1d(c // 2), nn.ReLU(),
            nn.Conv1d(c // 2, c, 1),
        )
        self.projection_q = nn.Conv1d(c, c, 1)
        self.projection_k = nn.Conv1d(c, c, 1)
        self.projection_v = nn.Conv1d(c, c, 1)

    def forward(self, feat, attention, col_mask):
        """`NonLocalBlock.forward` (`PointDSC.py:28-50`) on feat [N, C]."""
        c = feat.shape[-1]
        q, k, v = (dense(feat, p) for p in (self.projection_q, self.projection_k, self.projection_v))
        scores = attention * (torch.matmul(q, k.t()) / math.sqrt(c))
        if col_mask is not None:
            scores = torch.where(col_mask[None, :], scores, float("-inf"))
        message = torch.matmul(torch.softmax(scores, dim=-1), v)
        fm = self.fc_message
        m = torch.relu(batch_norm(dense(message, fm[0]), fm[1]))
        m = torch.relu(batch_norm(dense(m, fm[3]), fm[4]))
        return feat + dense(m, fm[6])


class _Encoder(nn.Module):
    def __init__(self, in_dim: int, num_layers: int, c: int):
        super().__init__()
        self.layer0 = nn.Conv1d(in_dim, c, 1)
        self.blocks = nn.ModuleDict()
        for i in range(num_layers):
            self.blocks[f"PointCN_layer_{i}"] = nn.Sequential(nn.Conv1d(c, c, 1), nn.BatchNorm1d(c), nn.ReLU())
            self.blocks[f"NonLocal_layer_{i}"] = _NonLocal(c)


class PointDSCNet(nn.Module):
    def __init__(self, in_dim: int = 6, num_layers: int = 12, num_channels: int = 128):
        super().__init__()
        self.num_layers = num_layers
        self.encoder = _Encoder(in_dim, num_layers, num_channels)
        self.classification = nn.Sequential(
            nn.Conv1d(num_channels, 32, 1), nn.ReLU(), nn.Conv1d(32, 32, 1), nn.ReLU(), nn.Conv1d(32, 1, 1))
        self.sigma = nn.Parameter(torch.ones(1))
        self.sigma_spat = nn.Parameter(torch.ones(1))


def pointdsc_encode(net: PointDSCNet, corr_pos: torch.Tensor, compat: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """NonLocalNet encoder + confidence head (`PointDSC.py:52-80,175-180`):
    corr_pos [N, in_dim], compat [N, N] -> (feat [N, C], confidence [N]).
    `mask` (None: all valid) keeps padding columns out of the softmax."""
    with torch.no_grad():
        feat = dense(corr_pos, net.encoder.layer0)
        for i in range(net.num_layers):
            pcn = net.encoder.blocks[f"PointCN_layer_{i}"]
            feat = torch.relu(batch_norm(dense(feat, pcn[0]), pcn[1]))
            feat = net.encoder.blocks[f"NonLocal_layer_{i}"](feat, compat, mask)
        cl = net.classification
        h = torch.relu(dense(feat, cl[0]))
        h = torch.relu(dense(h, cl[2]))
        return feat, dense(h, cl[4])[:, 0]


def _pair_dist(p: torch.Tensor) -> torch.Tensor:
    """|p_i - p_j| for p [..., N, 3] -> [..., N, N]."""
    d = [p[..., :, None, c] - p[..., None, :, c] for c in range(3)]
    return torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def pointdsc_forward(
    net: PointDSCNet,
    corr_pos: torch.Tensor,  # [N, 6]
    src_keypts: torch.Tensor,  # [N, 3]
    tgt_keypts: torch.Tensor,  # [N, 3]
    mask: torch.Tensor,  # [N]
    sigma_d: float = 1.2,
    nms_radius: float = 0.6,
    inlier_threshold: float = 0.10,
    num_iterations: int = 10,
    k: int = 40,
    ratio_num: int = 0,  # seeds; 0 -> N // 10
    refine_iters: int = 20,
) -> Dict[str, torch.Tensor]:
    """`PointDSC.forward` at test time: {final_trans [4, 4], final_labels
    [N] (the best seed's inliers, before the post refinement),
    confidence [N]}."""
    with torch.no_grad():
        n = corr_pos.shape[0]
        num_seeds = ratio_num if ratio_num > 0 else max(n // 10, 1)
        big = 1e9

        src_dist = _pair_dist(src_keypts)
        compat = src_dist - _pair_dist(tgt_keypts)
        compat = torch.clamp(1.0 - compat**2 / (sigma_d**2), min=0.0)
        compat = torch.where(mask[:, None] & mask[None, :], compat, 0.0)

        feat, confidence = pointdsc_encode(net, corr_pos, compat, mask)
        del compat
        normed = feat / torch.clamp(torch.linalg.vector_norm(feat, dim=-1, keepdim=True), min=1e-12)

        confidence = torch.where(mask, confidence, -big)
        relation = (confidence[:, None] >= confidence[None, :]) | (src_dist >= nms_radius)
        is_local_max = relation.all(dim=-1).to(torch.float32)
        del relation, src_dist
        seed_scores = torch.where(mask, confidence * is_local_max, -big)
        seeds = torch.sort(-seed_scores, stable=True).indices[:num_seeds]

        sigma2 = net.sigma.reshape(()) ** 2
        pdist = 2.0 - 2.0 * torch.matmul(normed[seeds], normed.t())
        pdist = torch.where(mask[None, :], pdist, big)
        knn_idx = torch.sort(pdist, dim=-1, stable=True).indices[:, 1 : k + 1]  # [S, k]

        knn_feat = normed[knn_idx]
        feat_m = torch.matmul(knn_feat, knn_feat.transpose(-1, -2))
        feat_m = torch.clamp(1.0 - (1.0 - feat_m) / sigma2, min=0.0)
        src_knn, tgt_knn = src_keypts[knn_idx], tgt_keypts[knn_idx]
        spat_m = torch.clamp(1.0 - (_pair_dist(src_knn) - _pair_dist(tgt_knn)) ** 2 / (sigma_d**2), min=0.0)
        total = feat_m * spat_m * (1.0 - torch.eye(k, device=feat_m.device))

        weight = torch.ones((num_seeds, k), dtype=torch.float32, device=feat_m.device)
        for _ in range(num_iterations):
            weight = torch.einsum("skj,sj->sk", total, weight)
            weight = weight / (torch.linalg.vector_norm(weight, dim=-1, keepdim=True) + 1e-6)
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-6)

        seed_trans = weighted_kabsch(src_knn, tgt_knn, weight)  # [S, 4, 4]
        moved = torch.einsum("sij,nj->sni", seed_trans[:, :3, :3], src_keypts) + seed_trans[:, None, :3, 3]
        l2 = torch.linalg.vector_norm(moved - tgt_keypts[None], dim=-1)
        inl = (l2 < inlier_threshold) & mask[None, :]
        best = torch.argmax(inl.to(torch.float32).mean(dim=-1))
        final = seed_trans[best]
        labels = inl[best]

        prev = torch.zeros((), dtype=torch.int64, device=final.device)
        for _ in range(refine_iters):
            moved = src_keypts @ final[:3, :3].t() + final[:3, 3]
            l2 = torch.linalg.vector_norm(moved - tgt_keypts, dim=-1)
            inlier = (l2 < inlier_threshold) & mask
            count = inlier.sum()
            w = torch.where(inlier, 1.0 / (1.0 + (l2 / inlier_threshold) ** 2), 0.0)
            t_new = weighted_kabsch(src_keypts, tgt_keypts, w)
            update = (count != prev) & (count >= 3)
            final = torch.where(update, t_new, final)
            prev = count
        return {"final_trans": final, "final_labels": labels, "confidence": confidence}


def init_pointdsc_params(generator: torch.Generator, in_dim: int = 6, num_layers: int = 12,
                         num_channels: int = 128, device=None) -> PointDSCNet:
    """PointDSCNet with the reference's random init (`init_pointdsc_params`,
    `:46`): N(0, 2 / (n_in + n_out)) weights, zero biases, identity
    BatchNorms, sigma 1; drawn on the CPU from `generator`, then moved to
    `device` (default: the card)."""
    net = PointDSCNet(in_dim, num_layers, num_channels)
    for m in net.modules():
        if isinstance(m, nn.Conv1d):
            init_dense_(m, generator, math.sqrt(2.0 / (m.in_channels + m.out_channels)))
    return loaded(net, net.state_dict(), device)


def load_pointdsc_state_dict(state_dict, num_layers: int = 12, device=None) -> PointDSCNet:
    """PointDSCNet from the reference checkpoint (`model_best.pkl`; tensor-
    or numpy-valued), on `device` (default: the card)."""
    in_dim = int(np.asarray(state_dict["encoder.layer0.weight"]).shape[1])
    c = int(np.asarray(state_dict["encoder.layer0.weight"]).shape[0])
    return loaded(PointDSCNet(in_dim, num_layers, c), state_dict, device)


def _bucket(n: int) -> int:
    b = 512
    while b < n:
        b *= 2
    return b


class PointDSCModel:
    """The scene loop's `register(src, tgt)` around a PointDSCNet."""

    def __init__(self, net: Optional[PointDSCNet] = None, seed: int = 0, max_corr: int = 10000, device=None):
        # The scene loop feeds up to 10,000 correspondences
        # (`registration_node.py:211-214`).
        self.device = resolve_device(device)
        full_precision()
        if net is None:
            net = init_pointdsc_params(torch.Generator().manual_seed(seed), device=self.device)
        self.net = net.to(self.device)
        self.max_corr = max_corr

    def register(self, src_keypts: np.ndarray, tgt_keypts: np.ndarray) -> np.ndarray:
        """[n, 3] x 2 -> the f64 pose [4, 4] taking src onto tgt."""
        src_keypts = np.asarray(src_keypts)
        tgt_keypts = np.asarray(tgt_keypts)
        n = src_keypts.shape[0]
        if n > self.max_corr:
            idx = np.linspace(0, n - 1, self.max_corr).astype(int)
            src_keypts, tgt_keypts = src_keypts[idx], tgt_keypts[idx]
            n = self.max_corr
        corr_pos = np.c_[src_keypts, tgt_keypts]
        corr_pos = corr_pos - corr_pos.mean(0)  # registration_node.py:218-219
        nb = min(_bucket(n), self.max_corr)
        pad = nb - n
        mask = np.zeros(nb, dtype=bool)
        mask[:n] = True

        def put(a):
            return torch.from_numpy(np.pad(a, ((0, pad), (0, 0))).astype(np.float32)).to(self.device)

        out = pointdsc_forward(
            self.net, put(corr_pos), put(src_keypts), put(tgt_keypts), torch.from_numpy(mask).to(self.device),
            # The reference's n * 0.1 seeds, rounded up to a multiple of 32.
            ratio_num=-(-max(n // 10, 1) // 32) * 32,
        )
        return out["final_trans"].cpu().numpy().astype(np.float64)


_MODEL: Dict[str, PointDSCModel] = {}


def get_pointdsc_model(device=None) -> PointDSCModel:
    """The model with the weights of $VFMREG_POINTDSC_WEIGHTS (a torch state
    dict file), on `device` (default: the card); FileNotFoundError without."""
    dev = resolve_device(device)
    path = os.environ.get("VFMREG_POINTDSC_WEIGHTS")
    if not (path and os.path.exists(path)):
        raise FileNotFoundError(
            "PointDSC weights not found; set VFMREG_POINTDSC_WEIGHTS to the "
            "torch checkpoint (reference: pointdsc/model_best.pkl)")
    key = f"{os.path.abspath(path)}@{dev}"
    if key not in _MODEL:
        sd = torch.load(path, map_location="cpu")
        _MODEL[key] = PointDSCModel(load_pointdsc_state_dict(sd, device=dev), device=dev)
    return _MODEL[key]
