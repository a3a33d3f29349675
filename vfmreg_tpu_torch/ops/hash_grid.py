"""Device-resident voxel hash grid: build, 27-voxel candidate gather, champion cache.

Counterpart of `vfmreg_tpu/ops/hash_grid.py`: the grid build (with the
odometry map's voxel eviction), the incremental map update
(`extend_hash_grid`), the 27-voxel gathers, the champion caches, and the XD
path's cosine-weighted candidates, which the reference also computes
outside any Pallas kernel. The layout is the reference's, array for array,
so that a grid built by either package can be fed to the other
(`convert.grid_from_numpy`):

* points stable-sorted by 32-bit voxel hash, same-voxel points contiguous in
  insertion order (the first `max_points_per_voxel` are kept);
* a packed open-addressing table [H/2, 24] int32: row r holds the (hash as
  int32, bucket index, count) triples of slots 2r .. 2r+7, so one row covers
  a whole 7-probe window;
* one 128-lane slab row per bucket, [x0..x31 | y0..y31 | z0..z31 | row0..31],
  dead lanes holding the INVALID_COORD sentinel whose square overflows f32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from vfmreg_tpu_torch.ops.nn_kernel import nn_argmin
from vfmreg_tpu_torch.ops.voxel import INVALID_HASH, bucket_size, int32_view, voxel_coords, voxel_hash
from vfmreg_tpu_torch.utils.profiling import span

# Linear-probe budget of the table: one packed row of 8 slots covers 7 probe
# positions from an odd base slot.
_PROBES = 7
# Lanes per slab row and coordinate; requires max_points_per_voxel <= 32 per row.
_SLAB = 32
# Dead-candidate coordinate: its square overflows f32 to +inf.
INVALID_COORD = 2e19

_NEIGHBOR_OFFSETS = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """Sorted-bucket voxel grid; all tensors padded to static capacities."""

    table: torch.Tensor  # [H/2, 24] int32: packed (hash, bucket, count) x 8 slots
    points: torch.Tensor  # [M, 3] f32, sorted by voxel hash
    bucket_slab: torch.Tensor  # [M*S+2, 128] f32 slab rows (S = ceil(cap/32))
    feats: Optional[torch.Tensor]  # [M, D] f32 or None
    valid: torch.Tensor  # [M] bool
    voxel_size: float
    max_points_per_voxel: int


def build_hash_grid(
    points: torch.Tensor,
    voxel_size: float,
    mask: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
    max_points_per_voxel: int = 20,
    evict_origin: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
) -> HashGrid:
    """Build the grid from a padded point cloud (reference `build_hash_grid`,
    `VoxelHashMap::AddPoints`): voxel = trunc(p / voxel_size), the first
    `max_points_per_voxel` points of each voxel kept in insertion order.
    With `evict_origin` ([3] f32) and `max_distance`, every voxel whose first
    point lies farther than `max_distance` from the origin goes whole
    (`RemovePointsFarFromLocation`): its count is 0 in the table and its rows
    are invalid. Runs where `points` lives."""
    with span("grid_build"):
        n = points.shape[0]
        dev = points.device
        if mask is None:
            mask = torch.ones(n, dtype=torch.bool, device=dev)

        h = torch.where(mask, voxel_hash(voxel_coords(points, voxel_size)), INVALID_HASH)
        order = torch.sort(h, stable=True).indices
        h_s = h[order]
        pts_s = points[order]
        mask_s = mask[order]
        feats_s = feats[order] if feats is not None else None

        first = torch.ones(1, dtype=torch.bool, device=dev)
        is_start = torch.cat([first, h_s[1:] != h_s[:-1]]) & mask_s

        # CSR from scans: each point's bucket start is the last run start at or
        # before it (running max), its end the next run start after it (running
        # min from the right).
        row = torch.arange(n, dtype=torch.int64, device=dev)
        start_pp = torch.cummax(torch.where(is_start, row, -1), dim=0).values
        nxt = torch.flip(
            torch.cummin(torch.flip(torch.where(is_start, row, n), [0]), dim=0).values, [0]
        )
        end_pp = torch.cat([nxt[1:], torch.full((1,), n, dtype=torch.int64, device=dev)])
        count_pp = torch.clamp(end_pp - start_pp, max=max_points_per_voxel)

        evict_pt = torch.zeros(n, dtype=torch.bool, device=dev)
        if evict_origin is not None:
            # Each point's bucket's first point; d2 summed as numpy sums three
            # terms, ((x^2 + y^2) + z^2), so that the host map evicts the same
            # voxels at the boundary.
            d = pts_s[start_pp.clamp(0, n - 1)] - evict_origin.to(dev, torch.float32)
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            max_d2 = torch.tensor(max_distance, dtype=torch.float32, device=dev) ** 2
            evict_pt = (d2 > max_d2) & mask_s
            count_pp = torch.where(evict_pt, 0, count_pp)

        rank = row - start_pp
        valid = mask_s & (rank < max_points_per_voxel) & ~evict_pt

        # ----- bucket-aligned slab store --------------------------------------
        # Two all-sentinel rows at the end: row n*S is the empty slab that absent
        # voxels redirect to; row n*S+1 takes the writes of rows that are not
        # stored. Several points land on that write-off row, and on CUDA
        # `index_put_` with duplicate indices writes in no fixed order; that is
        # harmless only because nothing ever reads the row.
        S = -(-max_points_per_voxel // _SLAB)
        bucket_id = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
        n_rows = n * S + 2
        slab_ok = valid & (bucket_id >= 0)
        flat0 = torch.where(
            slab_ok,
            (bucket_id * S + rank // _SLAB) * 128 + rank % _SLAB,
            (n_rows - 1) * 128,
        )
        slab = torch.full((n_rows * 128,), INVALID_COORD, dtype=torch.float32, device=dev)
        slab[flat0] = pts_s[:, 0]
        slab[flat0 + 32] = pts_s[:, 1]
        slab[flat0 + 64] = pts_s[:, 2]
        # Row ids as f32: exact below 2^24 rows.
        slab[flat0 + 96] = row.to(torch.float32)
        bucket_slab = slab.reshape(n_rows, 128)

        # ----- open-addressing table over the bucket set -----------------------
        # Linear probing without insert rounds: sort the buckets by base slot;
        # the parking-function identity then places bucket k at
        # k + cummax(base - k). Buckets pushed past the probe window or the table
        # end are dropped (unreachable), as in the reference.
        H = 1
        while H < 4 * n:
            H *= 2
        base = h_s & (H - 1)
        key2 = torch.where(is_start, base, H)  # non-starts sort last
        order2 = torch.sort(key2, stable=True).indices
        bs = key2[order2]
        placed = row + torch.cummax(bs - row, dim=0).values
        ok = (bs < H) & (placed - bs < _PROBES) & (placed < H)
        slot = torch.where(ok, placed, H)  # slot H: write-off row, cut below

        vals = torch.stack(
            [int32_view(h_s[order2]), bucket_id[order2].to(torch.int32), count_pp[order2].to(torch.int32)],
            dim=1,
        )
        table3 = torch.zeros((H + 1, 3), dtype=torch.int32, device=dev)
        table3[:, 0] = -1  # int32 view of INVALID_HASH
        table3[slot] = vals

        # Pack the probe window: row r = slots 2r .. 2r+7. Tail windows read zero
        # rows, which cannot false-hit (a hash whose window reaches past H has
        # nonzero low bits).
        pad = torch.zeros((6, 3), dtype=torch.int32, device=dev)
        view = torch.cat([table3[:H], pad]).reshape(H // 2 + 3, 6)
        table = torch.cat([view[k : H // 2 + k] for k in range(4)], dim=1).contiguous()

        return HashGrid(
            table=table,
            points=pts_s,
            bucket_slab=bucket_slab,
            feats=feats_s,
            valid=valid,
            voxel_size=float(voxel_size),
            max_points_per_voxel=max_points_per_voxel,
        )


def extend_hash_grid(
    old_points: torch.Tensor,
    old_valid: torch.Tensor,
    old_feats: Optional[torch.Tensor],
    new_points: torch.Tensor,
    new_mask: torch.Tensor,
    new_feats: Optional[torch.Tensor],
    voxel_size: float,
    origin: torch.Tensor,
    max_distance: float,
    cap: int,
    max_points_per_voxel: int = 20,
    evict: bool = True,
) -> HashGrid:
    """The incremental map update (reference `extend_hash_grid`): the stored
    rows (old [M_old, 3], their validity and descriptors) and a new
    world-frame frame (new [M_new, 3], mask, descriptors) concatenated,
    compacted by a stable sort (valid rows first, old before new) and cut to
    `cap` rows, then rebuilt with the voxels beyond `max_distance` of
    `origin` evicted. Insertion order survives the compaction, so the
    per-voxel cap and the first-point eviction keep the reference's points.
    Only the new frame comes from the host; the rest stays on the device."""
    pts = torch.cat([old_points, new_points.to(torch.float32)])
    mask = torch.cat([old_valid, new_mask])
    order = torch.sort((~mask).to(torch.int32), stable=True).indices[:cap]
    feats = None
    if old_feats is not None:
        feats = torch.cat([old_feats, new_feats.to(torch.float32)])[order]
    return build_hash_grid(pts[order], voxel_size, mask=mask[order], feats=feats,
                           max_points_per_voxel=max_points_per_voxel,
                           evict_origin=origin if evict else None, max_distance=max_distance)


def build_padded_grid(
    points: torch.Tensor, feats: Optional[torch.Tensor], voxel_size: float, max_points_per_voxel: int
) -> HashGrid:
    """The grid of M points [M, 3] (and their descriptors [M, D], or None),
    zero-padded to `bucket_size(M)` rows, as the reference's
    `VoxelHashMap.device_grid()` builds a map's grid (the padding fixes the
    order of every padded reduction). Runs where `points` lives."""
    m0 = points.shape[0]
    dev = points.device
    cap = bucket_size(max(m0, 1))
    pts = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    pts[:m0] = points
    mask = torch.arange(cap, device=dev) < m0
    if feats is not None:
        f = torch.zeros((cap, feats.shape[1]), dtype=torch.float32, device=dev)
        f[:m0] = feats
        feats = f
    return build_hash_grid(pts, voxel_size, mask=mask, feats=feats, max_points_per_voxel=max_points_per_voxel)


def _lookup_buckets(grid: HashGrid, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hash -> (bucket index, bucket count); count 0 when the voxel is absent.
    One gather of the packed row covers the whole probe window; the triples
    are scanned in ascending slot order."""
    H = 2 * grid.table.shape[0]
    shape = h.shape
    hf = h.reshape(-1)
    base = hf & (H - 1)
    h32 = int32_view(hf)
    row = grid.table[base >> 1]  # [Q, 24]
    start = torch.zeros(hf.shape, dtype=torch.int32, device=h.device)
    count = torch.zeros(hf.shape, dtype=torch.int32, device=h.device)
    found = torch.zeros(hf.shape, dtype=torch.bool, device=h.device)
    for j in range(8):
        hit = (row[:, 3 * j] == h32) & ~found
        start = torch.where(hit, row[:, 3 * j + 1], start)
        count = torch.where(hit, row[:, 3 * j + 2], count)
        found = found | hit
    valid = found & (hf != INVALID_HASH)
    return start.reshape(shape), torch.where(valid, count, 0).reshape(shape)


class Candidates(NamedTuple):
    """The 27-voxel candidate set: one slab row per neighbour voxel,
    `slabs` [N, 27, S, 128]. Validity is the sentinel; no mask is kept."""

    slabs: torch.Tensor

    def coords(self):
        """(xs, ys, zs) as [N, 27, S*32]."""
        n, v, S, _ = self.slabs.shape
        return tuple(self.slabs[..., 32 * c : 32 * (c + 1)].reshape(n, v, S * 32) for c in range(3))

    def rowids(self) -> torch.Tensor:
        n, v, S, _ = self.slabs.shape
        return self.slabs[..., 96:128].reshape(n, v, S * 32)

    def planes(self, group: int):
        """(cxt, cyt, czt), each [27 * g, N] with g = min(group, S * 32): the
        first g candidate lanes of every neighbour voxel, transposed so that
        queries run along the last axis (the layout kernel B3,
        `ops/champion_kernel.py`, reads). Lanes past the per-voxel cap hold
        only sentinels, so trimming them keeps the champions. One transpose
        per slab gather, shared by all of the epoch's rebuilds."""
        n, v, S, _ = self.slabs.shape
        g = min(group, S * 32)
        return tuple(
            a[:, :, :g].permute(1, 2, 0).reshape(v * g, n).contiguous() for a in self.coords()
        )


def gather_candidate_slabs(
    grid: HashGrid, queries: torch.Tensor, query_mask: Optional[torch.Tensor] = None
) -> Candidates:
    """27 hash lookups and 27 slab-row gathers around each query."""
    n = queries.shape[0]
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=queries.device)
    offsets = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=queries.device)
    base = voxel_coords(queries, grid.voxel_size)
    h27 = voxel_hash(base[:, None, :] + offsets[None, :, :])
    h27 = torch.where(query_mask[:, None], h27, INVALID_HASH)
    slab, count = _lookup_buckets(grid, h27)  # [N, 27]
    S = -(-grid.max_points_per_voxel // _SLAB)
    n_buckets = (grid.bucket_slab.shape[0] - 2) // S
    slab = torch.where(count > 0, slab.to(torch.int64), n_buckets)
    rows27 = slab[..., None] * S + torch.arange(S, device=queries.device)
    rows27 = torch.clamp(rows27, max=grid.bucket_slab.shape[0] - 2)
    return Candidates(slabs=grid.bucket_slab[rows27])


class NNCache(NamedTuple):
    """Per-voxel champion cache, transposed: [K=32, N] (27 champions and 5
    sentinel rows). Dead lanes hold INVALID_COORD; `rows` maps champions back
    to `grid.points`."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    rows: torch.Tensor


def _argmin_first(metric: torch.Tensor, dim: int):
    """(min, index of the first min) along `dim`: ties go to the lowest index,
    and +inf sentinel lanes never win while a finite candidate exists."""
    best = torch.amin(metric, dim=dim, keepdim=True)
    k = metric.shape[dim]
    shape = [1] * metric.ndim
    shape[dim] = k
    iota = torch.arange(k, device=metric.device).reshape(shape)
    ksel = torch.amin(torch.where(metric == best, iota, 2**30), dim=dim, keepdim=True)
    return best.squeeze(dim), ksel


def _select(ksel: torch.Tensor, arr: torch.Tensor, dim: int) -> torch.Tensor:
    """The champion's value (the reference selects it by one-hot sum; a gather
    gives the same value). A NaN query's index is 2^30, which selects
    nothing there; it is clamped here, and the caller's alive mask drops it."""
    return torch.gather(arr, dim, ksel.clamp(max=arr.shape[dim] - 1)).squeeze(dim)


def build_nn_cache(
    cands: Candidates,
    queries: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
) -> NNCache:
    """Reduce the gathered candidates to one champion per neighbour voxel:
    the in-voxel nearest point to the query's current position."""
    n = cands.slabs.shape[0]
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=queries.device)
    xs, ys, zs = cands.coords()
    dx = xs - queries[:, None, 0:1]
    dy = ys - queries[:, None, 1:2]
    dz = zs - queries[:, None, 2:3]
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf

    best_d2, ksel = _argmin_first(d2, dim=-1)  # [N, 27], [N, 27, 1]
    alive = torch.isfinite(best_d2) & query_mask[:, None]
    pad = torch.full((32 - 27, n), INVALID_COORD, dtype=torch.float32, device=queries.device)

    def plane(arr):
        champ = torch.where(alive, _select(ksel, arr, -1), INVALID_COORD)
        return torch.cat([champ.T, pad], dim=0).contiguous()

    # Dead lanes carry the sentinel in their row-id lanes too; convert with
    # the reference's saturating f32 -> int32 (valid ids are below 2^24). A
    # NaN query's one-hot sum there is 0.
    rowf = torch.where(ksel[..., 0] >= 2**30, 0.0, _select(ksel, cands.rowids(), -1))
    rows = torch.where(rowf >= 2.0**31, 2**31 - 1, rowf.clamp(max=2.0**30).to(torch.int32))
    ipad = torch.zeros((32 - 27, n), dtype=torch.int32, device=queries.device)
    return NNCache(
        cx=plane(xs),
        cy=plane(ys),
        cz=plane(zs),
        rows=torch.cat([rows.T, ipad], dim=0).contiguous(),
    )


def nn_from_cache(
    cache: NNCache,
    queries: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest cached champion per query: (neighbour[N,3], dist[N], found[N]),
    dist = +inf where nothing was found. The distance and arg-min run through
    kernel B4 (`ops/nn_kernel.nn_argmin`), its plain version for CPU tensors."""
    n = queries.shape[0]
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=queries.device)
    best_d2, best_k = nn_argmin(cache.cx, cache.cy, cache.cz, queries.contiguous())
    # A NaN query's index is 2^30, which selects nothing in the reference's
    # one-hot sum; clamp it before the gather; `found` zeroes its row.
    ksel = best_k.clamp(max=cache.cx.shape[0] - 1).to(torch.int64)[None, :]
    best_pt = torch.stack([_select(ksel, c, 0) for c in (cache.cx, cache.cy, cache.cz)], dim=1)
    found = torch.isfinite(best_d2) & query_mask
    best_pt = torch.where(found[:, None], best_pt, 0.0)
    dist = torch.sqrt(torch.where(found, best_d2, float("inf")))
    return best_pt, dist, found


def nn_from_slabs(
    cands: Candidates,
    queries: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest gathered candidate per query: (neighbour [N, 3], dist [N],
    found [N]), dist = +inf where nothing was found. With `weights` [N, K]
    the candidate of least d2 * weight wins (the XD resolve); dist is its
    Euclidean distance either way."""
    n = queries.shape[0]
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=queries.device)
    xs, ys, zs = (c.reshape(n, -1) for c in cands.coords())
    dx = xs - queries[:, 0:1]
    dy = ys - queries[:, 1:2]
    dz = zs - queries[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    best, ksel = _argmin_first(d2 if weights is None else d2 * weights, dim=-1)
    found = torch.isfinite(best) & query_mask
    best_pt = torch.stack([_select(ksel, c, -1) for c in (xs, ys, zs)], dim=1)
    best_pt = torch.where(found[:, None], best_pt, 0.0)
    d2_best = best if weights is None else _select(ksel, d2, -1)
    return best_pt, torch.sqrt(torch.where(found, d2_best, float("inf"))), found


def nearest_neighbors(
    grid: HashGrid, queries: torch.Tensor, query_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest map point in the 27-voxel neighbourhood of each query
    (`GetClosestNeighbor`, `VoxelHashMap.cpp:79-134`), at any distance: the
    caller applies its correspondence gate."""
    return nn_from_slabs(gather_candidate_slabs(grid, queries, query_mask), queries, query_mask)


def candidate_weights(
    cands: Candidates, grid_feats: torch.Tensor, qfeats: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """[N, 27 * S * 32] XD distance weights of the gathered candidates,
    `clamp(0.5 * (1 - cos), 0.01, 1.0)` with cos = <n, q> / (|n| |q| + 1e-5)
    where both the query and the candidate have a nonzero descriptor sum,
    else 1.0 (the XD `GetClosestNeighbor`, `VoxelHashMap.cpp:360-384`). A
    weight depends only on the candidate's identity, so the ICP loop takes
    it once per slab gather. The descriptor gather goes one neighbour voxel
    at a time, as the reference's `lax.map`: its peak is [N, S * 32, D],
    not 27 times that."""
    n, v, S, _ = cands.slabs.shape
    M = grid_feats.shape[0]
    # Dead lanes carry the sentinel as their row id: clamp before the cast.
    rows = cands.rowids().clamp(0, M - 1).to(torch.int64)  # [N, 27, S * 32]
    qfeats = qfeats.to(torch.float32)
    q_has = qfeats.sum(dim=-1) != 0.0  # a sum, not a norm (`VoxelHashMap.cpp:367`)
    qn = torch.linalg.vector_norm(qfeats, dim=-1)
    out = torch.empty((n, v, S * 32), dtype=torch.float32, device=qfeats.device)
    for j in range(v):
        f = grid_feats[rows[:, j]]  # [N, S * 32, D]
        dot = torch.einsum("nkd,nd->nk", f, qfeats)
        cos = dot / (torch.linalg.vector_norm(f, dim=-1) * qn[:, None] + eps)
        w = torch.clamp(0.5 * (1.0 - cos), 0.01, 1.0)
        out[:, j] = torch.where(q_has[:, None] & (f.sum(dim=-1) != 0.0), w, 1.0)
    return out.reshape(n, v * S * 32)


class WeightedNNCache(NamedTuple):
    """Champion cache of the XD weighted metric: per neighbour voxel the
    candidate of least d2 * weight, with its weight (`cw`, 1.0 in the pad
    rows), so that the resolve between rebuilds stays in that metric.
    [32, N] each; acceptance stays Euclidean (`VoxelHashMap.cpp:425-433`)."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    cw: torch.Tensor


def build_weighted_nn_cache(
    cands: Candidates,
    weights: torch.Tensor,
    queries: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
) -> WeightedNNCache:
    """Per-voxel champions under the weighted metric (weights from
    `candidate_weights`)."""
    n = cands.slabs.shape[0]
    dev = queries.device
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=dev)
    xs, ys, zs = cands.coords()  # [N, 27, S*32]
    dx = xs - queries[:, None, 0:1]
    dy = ys - queries[:, None, 1:2]
    dz = zs - queries[:, None, 2:3]
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    w = weights.reshape(d2.shape)
    best, ksel = _argmin_first(d2 * w, dim=-1)  # inf * [0.01, 1] stays inf
    alive = torch.isfinite(best) & query_mask[:, None]

    def plane(arr, dead, pad):
        champ = torch.where(alive, _select(ksel, arr, -1), dead)
        return torch.cat([champ.T, torch.full((32 - 27, n), pad, dtype=torch.float32, device=dev)]).contiguous()

    return WeightedNNCache(
        cx=plane(xs, INVALID_COORD, INVALID_COORD),
        cy=plane(ys, INVALID_COORD, INVALID_COORD),
        cz=plane(zs, INVALID_COORD, INVALID_COORD),
        cw=plane(w, 1.0, 1.0),
    )


def nn_from_weighted_cache(
    cache: WeightedNNCache, queries: torch.Tensor, query_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted metric's champion per query, with its plain Euclidean
    distance for the acceptance gate: (neighbour [N, 3], dist [N], found [N])."""
    n = queries.shape[0]
    if query_mask is None:
        query_mask = torch.ones(n, dtype=torch.bool, device=queries.device)
    d2 = ((cache.cx - queries[:, 0]) ** 2 + (cache.cy - queries[:, 1]) ** 2
          + (cache.cz - queries[:, 2]) ** 2)
    best, ksel = _argmin_first(d2 * cache.cw, dim=0)
    best_pt = torch.stack([_select(ksel, c, 0) for c in (cache.cx, cache.cy, cache.cz)], dim=1)
    d2_eucl = _select(ksel, d2, 0)
    found = torch.isfinite(best) & query_mask
    best_pt = torch.where(found[:, None], best_pt, 0.0)
    return best_pt, torch.sqrt(torch.where(found, d2_eucl, float("inf"))), found


def nearest_neighbors_xd(
    grid: HashGrid, queries: torch.Tensor, qfeats: torch.Tensor, query_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The XD weighted neighbour over the whole 27-voxel candidate set (the
    XD `GetClosestNeighbor`, `VoxelHashMap.cpp:360-404`): the candidate of
    least d2 * weight, with its Euclidean distance."""
    cands = gather_candidate_slabs(grid, queries, query_mask)
    return nn_from_slabs(cands, queries, query_mask, candidate_weights(cands, grid.feats, qfeats))
