"""Descriptor matching: cosine 1-NN from scan points to map points.

Counterpart of the scan-to-map parts of `vfmreg_tpu/ops/matching.py`: the
L2-renormalized cosine 1-NN with a minimum-similarity gate
(`get_vfm_correspondences`, `:155`), its flattened-batch form (`:251`) and
the masked median / MAD (`:120-137`). The arg-max goes through kernel B1
(`ops/cosine_kernel.py`) and follows its contract: masked map rows score
-1e30 and the index is clamped to M-1. The reference's CPU path masks with
-inf instead; the two differ only for a query whose every map row is masked,
which falls below the acceptance gate either way.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax

_F32_MAX = torch.finfo(torch.float32).max


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """faiss `fvec_renorm_L2` semantics: zero vectors stay zero."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return torch.where(norm > 0.0, x / torch.clamp(norm, min=1e-20), 0.0)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the last axis's mask==True entries (mean of the two middle
    elements for an even count; 0 when empty). Works on [..., N]."""
    v = torch.sort(torch.where(mask, values, _F32_MAX), dim=-1).values
    cnt = mask.sum(dim=-1, keepdim=True)
    last = values.shape[-1] - 1
    hi = torch.clamp(cnt // 2, 0, last)
    lo = torch.clamp((cnt - 1) // 2, 0, last)
    med = (0.5 * (torch.gather(v, -1, hi) + torch.gather(v, -1, lo)))[..., 0]
    return torch.where(cnt[..., 0] > 0, med, 0.0)


def masked_mad(values: torch.Tensor, mask: torch.Tensor, scale: float = 1.4826):
    """(median, MAD * scale) over the last axis."""
    med = masked_median(values, mask)
    mad = masked_median(torch.abs(values - med[..., None]), mask)
    return med, mad * scale


class VFMCorrespondences(NamedTuple):
    source: torch.Tensor  # [..., N, 3] scan points (query side)
    target: torch.Tensor  # [..., N, 3] matched map points
    mask: torch.Tensor  # [..., N] accepted (cosine >= threshold)
    similarity: torch.Tensor  # [..., N] best cosine similarity
    mean_similarity: torch.Tensor  # [...] over the valid queries
    median_distance: torch.Tensor  # [...] telemetry
    mad_distance: torch.Tensor  # [...]

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    def lane(self, b: int) -> "VFMCorrespondences":
        """The b-th scan of a batched result."""
        return VFMCorrespondences(*(f[b] for f in self))


def _best_match(scan_feats, map_feats, map_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2-normalize both sides and run the cosine arg-max (kernel B1)."""
    qn = l2_normalize(scan_feats.to(torch.float32)).contiguous()
    dbn = l2_normalize(map_feats.to(torch.float32)).contiguous()
    return cosine_argmax(qn, dbn, map_mask.contiguous())


def _assemble(scan_points, scan_mask, best_sim, target, min_cosine_similarity):
    """Acceptance gate and telemetry; leading batch axes allowed."""
    accept = scan_mask & (best_sim >= torch.tensor(min_cosine_similarity, dtype=torch.float32))
    dist = torch.linalg.vector_norm(scan_points - target, dim=-1)
    med, mad = masked_mad(dist, accept)
    n_q = torch.clamp(scan_mask.sum(dim=-1), min=1)
    mean_sim = torch.where(scan_mask, best_sim, 0.0).sum(dim=-1) / n_q
    return VFMCorrespondences(scan_points, target, accept, best_sim, mean_sim, med, mad)


def get_vfm_correspondences(
    map_points, map_feats, map_mask, scan_points, scan_feats, scan_mask,
    min_cosine_similarity: float = 0.8,
) -> VFMCorrespondences:
    """Cosine 1-NN in descriptor space, scan [N] -> map [M]."""
    best_sim, best_idx = _best_match(scan_feats, map_feats, map_mask)
    target = map_points[best_idx.to(torch.int64)]
    return _assemble(scan_points, scan_mask, best_sim, target, min_cosine_similarity)


def get_vfm_correspondences_batched(
    map_points, map_feats, map_mask,
    scan_points,  # [B, N, 3]
    scan_feats,  # [B, N, D]
    scan_mask,  # [B, N]
    min_cosine_similarity: float = 0.8,
) -> VFMCorrespondences:
    """`get_vfm_correspondences` over B scans sharing one map: the batch is
    flattened into the query axis, so the map descriptors stream from device
    memory once for all B scans. Fields carry a leading [B] axis."""
    b, n, d = scan_feats.shape
    best_sim, best_idx = _best_match(scan_feats.reshape(b * n, d), map_feats, map_mask)
    best_sim = best_sim.reshape(b, n)
    target = map_points[best_idx.to(torch.int64)].reshape(b, n, 3)
    return _assemble(scan_points, scan_mask, best_sim, target, min_cosine_similarity)
