"""RANSAC on correspondences, scored from sufficient statistics, and the snap filter.

Counterpart of `vfmreg_tpu/registration/ransac.py`: `ransac_registration`
(`:44`) and `snap_correspondences` (`:147`, with the map-sharded target side
of `vfmreg_tpu/parallel/mesh.py:703-733`).

RANSAC replaces Open3D's correspondence RANSAC as the reference driver calls
it (ransac_n = 3, every correspondence an inlier, 50,000 iterations, no early
exit): the winner is the 3-sample Kabsch model with the least mean squared
residual over ALL valid correspondences. For a rigid model that residual
expands into one O(N) pass of statistics and O(1) per hypothesis:

  sum_n m_n |R s_n + t - g_n|^2
    = S_ss + S_tt + M |t|^2 + 2 t.(R a) - 2 <A, R>_F - 2 t.g

with a = sum m s, g = sum m g_n, S_ss = sum m |s|^2, S_tt = sum m |g|^2 and
A = sum m g_n s_n^T, in centred coordinates. The f32 score carries ~1e-4 m^2
of noise, so near-tied winners come out in noise order, as in the
reference.

The reference draws its picks with threefry from `PRNGKey(scan)` and scores
them in blocks of 1024 with a strict '<' between blocks: that is the first
arg-min over all hypotheses, which is what the batched pass below takes over
all hypotheses of all scans at once. Here the picks come from a
`torch.Generator` (other numbers than threefry's from the same seed), or are
given by the caller (`picks`), which lets the tests inject the reference's.
The reference pads its last block with the pick (0, 0, 0) and scores those
hypotheses too; the same padding is kept.

One deliberate difference: the statistics select masked rows with `where`,
so non-finite values behind the mask cannot poison the sums (the reference
multiplies by the mask, and a NaN row behind it turns every score into NaN
and its result into the identity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from vfmreg_tpu_torch.ops.matching import _chunked_argmin_l2, _sq3
from vfmreg_tpu_torch.parallel import collectives
from vfmreg_tpu_torch.registration.procrustes import dot3, kabsch_horn, matvec3

_BLOCK = 1024  # the reference's hypothesis block, which fixes its padding
RANSAC_N = 3  # points per hypothesis
SNAP_TOLERANCE = 1e-3  # metres a snapped correspondence may move (`registration_node.py:301`)
_SNAP_CHUNK = 4096  # map rows per step of the snap's nearest-neighbour search


class RansacResult(NamedTuple):
    pose: torch.Tensor  # [..., 4, 4] best model
    rmse: torch.Tensor  # [...] its score (inf without valid correspondences)
    n_corr: torch.Tensor  # [...] number of valid correspondences


def _draw_picks(
    valid_count: torch.Tensor, generators: Sequence[torch.Generator], num_hypotheses: int
) -> torch.Tensor:
    """[B, K, 3] int64 picks, uniform over each scan's valid correspondences
    (`valid_count` [B] >= 1), one generator per scan."""
    u = torch.stack([
        torch.rand((num_hypotheses, RANSAC_N), generator=g, device=valid_count.device)
        for g in generators
    ])
    count = valid_count.to(torch.float32)[:, None, None]
    picks = torch.floor(u * count).to(torch.int64)
    return torch.minimum(picks, valid_count[:, None, None] - 1)


def ransac_batched(
    src: torch.Tensor,  # [B, N, 3]
    tgt: torch.Tensor,  # [B, N, 3]
    mask: torch.Tensor,  # [B, N]
    generators: Optional[Sequence[torch.Generator]] = None,
    num_hypotheses: int = 50000,
    picks: Optional[torch.Tensor] = None,  # [B, K, 3] into the compacted valid rows
) -> RansacResult:
    """RANSAC over B scans at once; see the module docstring."""
    b, n = mask.shape
    dev = src.device
    src = src.to(torch.float32)
    tgt = tgt.to(torch.float32)

    # Valid correspondences compacted to the front (stable) for sampling.
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    src_s = torch.gather(src, 1, order[..., None].expand(-1, -1, 3))
    tgt_s = torch.gather(tgt, 1, order[..., None].expand(-1, -1, 3))
    true_count = mask.sum(dim=1)
    valid_count = torch.clamp(true_count, min=1)
    counts = true_count.tolist()

    # Per scan, over its own valid rows only: the centre (the pose is
    # conjugated back at the end) and the sufficient statistics (one pass
    # over the correspondences). A sum over a padded or batched row would
    # round otherwise on the card as B or N change, and a near-tied winner
    # with it; this way a scan scores as it does alone.
    c = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    a_vec, g_vec = torch.zeros_like(c), torch.zeros_like(c)  # sum m s, sum m g (centred)
    s_ss = torch.zeros(b, dtype=torch.float32, device=dev)
    s_tt = torch.zeros_like(s_ss)
    A_cov = torch.zeros((b, 3, 3), dtype=torch.float32, device=dev)  # sum_n g_n s_n^T
    for j, n_j in enumerate(counts):
        sj, tj = src_s[j, :n_j], tgt_s[j, :n_j]
        c[j] = sj.sum(dim=0) / max(n_j, 1)
        sm, tm = sj - c[j], tj - c[j]
        a_vec[j], g_vec[j] = sm.sum(dim=0), tm.sum(dim=0)
        s_ss[j], s_tt[j] = torch.sum(sm * sm), torch.sum(tm * tm)
        A_cov[j] = tm.T @ sm
    src_c = src_s - c[:, None, :]
    tgt_c = tgt_s - c[:, None, :]

    if picks is None:
        if generators is None or len(generators) != b:
            raise ValueError("ransac_batched needs one generator per scan, or picks")
        picks = _draw_picks(valid_count, generators, num_hypotheses)
    picks = picks.to(device=dev, dtype=torch.int64)
    pad = (-picks.shape[1]) % _BLOCK
    if pad:
        picks = torch.cat([picks, picks.new_zeros((b, pad, RANSAC_N))], dim=1)
    k = picks.shape[1]

    denom = valid_count.to(torch.float32)  # [B]
    flat = picks.reshape(b, k * RANSAC_N)
    tri_src = torch.gather(src_c, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, k, RANSAC_N, 3)
    tri_tgt = torch.gather(tgt_c, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, k, RANSAC_N, 3)
    T = kabsch_horn(tri_src, tri_tgt)  # [B, K, 4, 4]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    # <A, R>_F over the nine entries in row-major order, elementwise.
    A = A_cov[:, None]
    RA = R[..., 0, 0] * A[..., 0, 0]
    for e in range(1, 9):
        RA = RA + R[..., e // 3, e % 3] * A[..., e // 3, e % 3]
    mse = (
        s_ss[:, None] + s_tt[:, None]
        + denom[:, None] * dot3(t, t)
        + 2.0 * dot3(t, matvec3(R, a_vec[:, None]))
        - 2.0 * RA
        - 2.0 * dot3(t, g_vec[:, None])
    ) / denom[:, None]
    finite = torch.all(torch.isfinite(T.reshape(b, k, 16)), dim=-1)
    mse = torch.where(finite & ~torch.isnan(mse), mse, float("inf"))
    mse = torch.clamp(mse, min=0.0)  # the expansion can go epsilon-negative
    j = torch.argmin(mse, dim=1)  # the first minimum over all hypotheses
    best_mse = torch.gather(mse, 1, j[:, None])[:, 0]
    best_T = torch.gather(T, 1, j[:, None, None, None].expand(-1, 1, 4, 4))[:, 0]

    # Un-centre: T_world = Trans(c) @ T_c @ Trans(-c).
    best_T[:, :3, 3] = best_T[:, :3, 3] + c - matvec3(best_T[:, :3, :3], c)
    # Zero valid correspondences read as failure, not as a perfect fit.
    any_valid = true_count > 0
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4)
    best_T = torch.where(any_valid[:, None, None], best_T, eye)
    best_mse = torch.where(any_valid, best_mse, float("inf"))
    return RansacResult(pose=best_T, rmse=torch.sqrt(best_mse), n_corr=true_count)


def ransac_registration(
    src: torch.Tensor,  # [N, 3]
    tgt: torch.Tensor,  # [N, 3]
    mask: torch.Tensor,  # [N]
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 50000,
    picks: Optional[torch.Tensor] = None,  # [K, 3]
) -> RansacResult:
    """Single-scan RANSAC: (pose [4, 4], rmse, n_corr)."""
    res = ransac_batched(
        src[None], tgt[None], mask[None],
        None if generator is None else [generator], num_hypotheses,
        None if picks is None else torch.as_tensor(picks)[None],
    )
    return RansacResult(*(f[0] for f in res))


def snap_correspondences(
    src: torch.Tensor,  # [..., N, 3]
    tgt: torch.Tensor,
    mask: torch.Tensor,  # [..., N]
    scan_points: torch.Tensor,  # [..., S, 3]
    scan_mask: torch.Tensor,  # [..., S]
    map_points: torch.Tensor,  # [M, 3], shared
    map_mask: torch.Tensor,  # [M]
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replace each correspondence by its nearest point in the voxelized scan
    and map clouds, and drop it when either moved by SNAP_TOLERANCE or more
    (the reference driver's KD-tree filter). Leading batch axes allowed.

    The -2ab expansion cancels at world-scale coordinates, so the search runs
    on clouds centred on the correspondence mean (one shift per scan keeps
    every distance), and the gate uses the distance to the gathered point
    computed directly. Returns (snapped_src, snapped_tgt, new_mask).

    Each set's shift is the mean of its own valid rows, summed set by set:
    a sum over a padded or batched row rounds otherwise on the card, and the
    shift's bits decide near-ties of the search, so a scan snaps the same
    alone or in a batch.

    With `group` (a `torch.distributed` group), `map_points` / `map_mask`
    are this rank's rows of the map: the target side searches them, then
    every rank's squared distances and snapped points are gathered and the
    first minimum over the ranks wins (the lowest rank on ties), as the
    reference's map-sharded snap (`parallel/mesh.py:703-733`). The scan side
    is the same on every rank."""
    lead = mask.shape[:-1]
    flat_src, flat_mask = src.reshape(-1, *src.shape[-2:]), mask.reshape(-1, mask.shape[-1])
    c = torch.zeros((flat_src.shape[0], 3), dtype=src.dtype, device=src.device)
    for j in range(flat_src.shape[0]):
        valid = flat_src[j][flat_mask[j]]
        c[j] = valid.sum(dim=0) / max(valid.shape[0], 1)
    cc = c.reshape(*lead, 1, 3)
    _, idx_s = _chunked_argmin_l2(src - cc, scan_points - cc, scan_mask, _SNAP_CHUNK)
    d2_t, idx_t = _chunked_argmin_l2(tgt - cc, map_points - cc, map_mask, _SNAP_CHUNK)
    snapped_src = torch.gather(scan_points, -2, idx_s[..., None].expand(idx_s.shape + (3,)))
    snapped_tgt = map_points[idx_t]
    if group is not None:
        d2g = collectives.all_gather(d2_t[None], group)  # [world, ..., C]
        tgg = collectives.all_gather(snapped_tgt[None], group)
        iota = torch.arange(d2g.shape[0], device=d2g.device).reshape((-1,) + (1,) * d2_t.ndim)
        rank = torch.amin(torch.where(d2g == torch.amin(d2g, dim=0), iota, d2g.shape[0]), dim=0)
        snapped_tgt = torch.gather(tgg, 0, rank[None, ..., None].expand((1,) + snapped_tgt.shape))[0]
    d_s = torch.sqrt(_sq3(src - snapped_src))
    d_t = torch.sqrt(_sq3(tgt - snapped_tgt))
    ok = mask & (d_s < SNAP_TOLERANCE) & (d_t < SNAP_TOLERANCE)
    return snapped_src, snapped_tgt, ok
