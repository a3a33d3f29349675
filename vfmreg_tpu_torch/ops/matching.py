"""Descriptor matching: cosine 1-NN from scan points to map points.

Counterpart of the scan-to-map parts of `vfmreg_tpu/ops/matching.py`: the
L2-renormalized cosine 1-NN with a minimum-similarity gate
(`get_vfm_correspondences`, `:155`), its flattened-batch form (`:251`) and
the masked median / MAD (`:120-137`), the map-sharded search
(`get_vfm_correspondences_map_sharded`, `:215`), and the chunked Euclidean 1-NN
(`_chunked_argmin_l2`, `:79`) that the snap filter runs. The arg-max goes
through kernel B1 (`ops/cosine_kernel.py`) and follows its contract: masked
map rows score -1e30 and the index is clamped to M-1. The reference's CPU
path masks with -inf instead; the two differ only for a query whose every
map row is masked, which falls below the acceptance gate either way.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax
from vfmreg_tpu_torch.parallel import collectives
from vfmreg_tpu_torch.utils.profiling import span

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


def _sq3(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over a last axis of 3, elementwise, in ascending order: a
    reduction over a small axis may round otherwise on the card as the
    leading axes change."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def _sq(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over the last axis: `_sq3` for points, a sum for descriptors."""
    return _sq3(v) if v.shape[-1] == 3 else (v * v).sum(dim=-1)


def _chunked_argmin_l2(
    queries: torch.Tensor, database: torch.Tensor, db_mask: torch.Tensor, chunk: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmin_j |q_i - d_j|^2 through the -2ab expansion, streamed over the
    database in chunks: (best_d2 [..., N], best_idx [..., N] int64) for
    queries [..., N, D], database [..., M, D] and db_mask [..., M] (leading
    axes broadcast). Masked rows score +inf; the first minimum within a
    chunk and a strict '<' across chunks give the lowest index on ties, as
    the reference's scan does. The expansion cancels at world-scale
    coordinates, so callers centre both clouds first and never gate on
    `best_d2`. Squared norms are written out (`_sq3`), so a row's norm
    does not depend on the batch and padding around it."""
    q2 = _sq(queries)
    best_val = torch.full(q2.shape, float("inf"), dtype=torch.float32, device=queries.device)
    best_idx = torch.zeros(q2.shape, dtype=torch.int64, device=queries.device)
    for off in range(0, database.shape[-2], chunk):
        db = database[..., off : off + chunk, :]
        val = _sq(db)[..., None, :] - 2.0 * (queries @ db.transpose(-1, -2))
        val = torch.where(db_mask[..., None, off : off + chunk], val, float("inf"))
        v, j = torch.min(val, dim=-1)
        better = v < best_val
        best_val = torch.where(better, v, best_val)
        best_idx = torch.where(better, j + off, best_idx)
    return torch.clamp(best_val + q2, min=0.0), best_idx


# Query rows normalized per call of the norm: the driver's query sets are
# padded to multiples of it, so a query row is normalized in a block of the
# same shape whether its scan is matched alone or in a batch (the norm's
# reduction on the card may sum in another order as the row count changes).
_NORM_ROWS = 512


def _best_match(scan_feats, map_feats, map_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2-normalize both sides and run the cosine arg-max (kernel B1)."""
    q = scan_feats.to(torch.float32)
    qn = torch.cat([l2_normalize(q[i : i + _NORM_ROWS]) for i in range(0, max(q.shape[0], 1), _NORM_ROWS)])
    qn = qn.contiguous()
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
    with span("match"):
        b, n, d = scan_feats.shape
        best_sim, best_idx = _best_match(scan_feats.reshape(b * n, d), map_feats, map_mask)
        best_sim = best_sim.reshape(b, n)
        target = map_points[best_idx.to(torch.int64)].reshape(b, n, 3)
        return _assemble(scan_points, scan_mask, best_sim, target, min_cosine_similarity)


def get_vfm_correspondences_map_sharded(
    map_points, map_feats, map_mask,  # [M / world, ...]: this rank's rows of the map
    scan_points,  # [..., N, 3], the same on every rank
    scan_feats,  # [..., N, D]
    scan_mask,  # [..., N]
    group,
    min_cosine_similarity: float = 0.8,
) -> VFMCorrespondences:
    """`get_vfm_correspondences(_batched)` with the map's rows sharded over
    the ranks of `group` (a `torch.distributed` group): kernel B1 over this
    rank's rows, then one gather of every rank's best similarities and
    matched points, and the first maximum over the ranks. With contiguous
    row shards in rank order, the first maximum within a shard and across
    the ranks is the lowest global row, as in the single-device search.
    Every rank of the group calls it and gets the same result."""
    lead = scan_feats.shape[:-1]
    sim_s, idx_s = _best_match(scan_feats.reshape(-1, scan_feats.shape[-1]), map_feats, map_mask)
    tgt_s = map_points[idx_s.to(torch.int64)]
    sims = collectives.all_gather(sim_s[None], group)  # [world, Q]
    tgts = collectives.all_gather(tgt_s[None], group)  # [world, Q, 3]
    best_sim = torch.amax(sims, dim=0)
    iota = torch.arange(sims.shape[0], device=sims.device)[:, None]
    rank = torch.amin(torch.where(sims == best_sim, iota, sims.shape[0]), dim=0)  # the lowest rank
    target = torch.gather(tgts, 0, rank[None, :, None].expand(1, -1, 3))[0]
    return _assemble(scan_points, scan_mask, best_sim.reshape(lead), target.reshape(*lead, 3),
                     min_cosine_similarity)


class MutualNN(NamedTuple):
    idx0: torch.Tensor  # [N0] index into cloud 0 (identity order)
    idx1: torch.Tensor  # [N0] int64 matched index into cloud 1
    mask: torch.Tensor  # [N0] surviving correspondences
    dist: torch.Tensor  # [N0] descriptor-space L2 distance


# Query rows per block of `mutual_nn_correspondences`' searches: the
# [rows, chunk] distance block stays within a few hundred MB.
_MNN_ROWS = 65536


def _argmin_rows(queries, database, db_mask, chunk):
    outs = [_chunked_argmin_l2(queries[i : i + _MNN_ROWS], database, db_mask, chunk)
            for i in range(0, queries.shape[0], _MNN_ROWS)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def mutual_nn_correspondences(
    feats0: torch.Tensor,  # [N0, D]
    mask0: torch.Tensor,  # [N0]
    feats1: torch.Tensor,  # [N1, D]
    mask1: torch.Tensor,  # [N1]
    mutual_filter: bool = True,
    n_points: int = 5000,
    chunk: int = 4096,
) -> MutualNN:
    """`find_correspondences` (`registration_node.py:482-538`): descriptor-
    space L2 1-NN from cloud 0 to cloud 1, first index on ties.
    mutual_filter=True keeps i where NN_1->0(NN_0->1(i)) == i; False keeps
    the n = min(n_points, n_valid - 1) smallest distances (a stable rank,
    the lower index first on ties, as `jnp.argsort`)."""
    f0 = feats0.to(torch.float32)
    f1 = feats1.to(torch.float32)
    d2_01, nn01 = _argmin_rows(f0, f1, mask1, chunk)
    n0 = f0.shape[0]
    idx0 = torch.arange(n0, device=f0.device)
    dist = torch.sqrt(torch.clamp(d2_01, min=0.0))
    if mutual_filter:
        _, nn10 = _argmin_rows(f1, f0, mask0, chunk)
        keep = mask0 & (nn10[nn01] == idx0)
    else:
        order = torch.sort(torch.where(mask0, dist, _F32_MAX), stable=True).indices
        rank = torch.empty_like(idx0)
        rank[order] = idx0
        n_valid = int(mask0.sum())
        keep = mask0 & (rank < min(n_points, max(n_valid - 1, 0)))
    return MutualNN(idx0=idx0, idx1=nn01, mask=keep, dist=dist)
