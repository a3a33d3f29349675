"""Batched driver stages on one device, and their multi-device forms.

Counterpart of `vfmreg_tpu/parallel/mesh.py`.

**One device** (`:207-393`): `batched_ransac`, `batched_icp_stats` and
`batched_icp_two_phase`. The reference vmaps each stage over the B scans of
a scene. Here RANSAC runs as one batched pass over all scans (and the snap
filter, the reference's `batched_snap`, is `registration.ransac
.snap_correspondences` itself, which takes the batch axis), and each ICP row
steps all its lanes together on the device
(`registration.icp.register_frames_icp_stats`), each lane taking the
sequence of steps the vmapped loop gives it. The reference's lane
compaction and filler lanes in the two-phase row exist for its fixed-shape
loop only: here the unsettled lanes resume as one smaller batch (padded to
a multiple of the ranks only on the scan-sharded path).

**Several devices** (`:31-188`, `:396-860`). The reference runs each sharded
stage as one SPMD program under `shard_map` over a `jax.sharding.Mesh`.
PyTorch's form is one process per card: every rank calls the same function
with its own shard, and the collectives are explicit `torch.distributed`
calls (`parallel.collectives`) on the group that stands in for the mesh
axis: `all_gather` in rank order for the tiled `all_gather`,
`all_reduce(MIN)` for `pmin` and `all_reduce(SUM)` for `psum`. `make_mesh`
gives a `DeviceMesh` over the initialised world (NCCL on the card, gloo on
the CPU); the caller initialises the process group. Every rank of a group
must make the same calls in the same order, or the group hangs: the host
decisions between collectives are taken on data that is the same on every
rank, and the ICP loop's per-round decisions are reduced over the group
(`CacheMerge.agree`).

* `batched_registration_step` / `sharded_registration_step`: the flagship
  registration per scan-map pair, the pairs split over the ranks, one
  `psum` of the correspondence counts.
* `sharded_ransac` / `hypothesis_sharded_batched_ransac`: each rank scores
  ceil(budget / world) hypotheses of every scan, and the winner is chosen
  as the reference's pmin / pmin / psum chooses it: the least RMSE, the
  lowest rank on ties. The port draws its picks from `torch.Generator`s
  (ROADMAP "Deliberate divergences"), so the reference's per-device
  `split(key, n_dev)` streams become a seed per (scan, rank):
  `rank_seed(scan, rank) = scan + rank * 2**32`, which at world size 1 is
  the single-device row's seed (the scan index). `picks=` takes a rank's
  picks instead, as the tests feed it the reference's.
* `map_sharded_icp`, `map_sharded_vfm_register`,
  `dp_map_sharded_vfm_register` and `map_sharded_driver_stages`: the map's
  rows split over the ranks in contiguous blocks (`shard_rows`), one hash
  grid per rank, and the champion caches merged after every rebuild
  (`CacheMerge`, the reference's `_gather_nn_cache`). The per-voxel
  insertion cap applies per shard, so a voxel can keep up to world x cap
  points map-wide (reference `:425-433`); maps whose voxels stay under the
  cap give the one grid's neighbours.
* `sharded_driver_stages`: the scan axis split over the ranks, each running
  its scans on the single-device rows above, the rows gathered back in scan
  order.
"""

from __future__ import annotations

import collections
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from vfmreg_tpu_torch.geometry.se3 import transform_points
from vfmreg_tpu_torch.ops.hash_grid import HashGrid, build_hash_grid
from vfmreg_tpu_torch.ops.matching import (
    VFMCorrespondences,
    get_vfm_correspondences,
    get_vfm_correspondences_batched,
    get_vfm_correspondences_map_sharded,
)
from vfmreg_tpu_torch.parallel import collectives
from vfmreg_tpu_torch.registration.icp import (
    FAR_FIELD_PHASE1_ITERATIONS,
    MAX_NUM_ITERATIONS,
    REFRESH_INTERVAL,
    BatchedICP,
    register_frame_icp,
    register_frames_icp_stats,
)
from vfmreg_tpu_torch.registration.ransac import ransac_batched, snap_correspondences
from vfmreg_tpu_torch.registration.vfm_icp import register_frame_vfm, register_frames_vfm_lanes

MIN, SUM, MAX = dist.ReduceOp.MIN, dist.ReduceOp.SUM, dist.ReduceOp.MAX


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------


def batched_ransac(
    src: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor, seeds: Sequence[int],
    num_hypotheses: int = 50000, picks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RANSAC poses [B, 4, 4] (on the device) for B scans, all hypotheses of
    all scans scored in one pass. Scan j draws its picks from a generator on
    the device seeded with `seeds[j]`, as the reference seeds `PRNGKey(j)`."""
    generators = None
    if picks is None:
        generators = [torch.Generator(device=src.device).manual_seed(int(s)) for s in seeds]
    return ransac_batched(src, tgt, mask, generators, num_hypotheses, picks=picks).pose


def batched_icp_stats(
    grid: HashGrid, points: torch.Tensor, mask: torch.Tensor, guesses, max_dist: float,
    kernel: float, max_iterations: Optional[int] = None,
) -> BatchedICP:
    """`register_frame_icp_stats` for each of B lanes (points [B, N, 3],
    guesses [B, 4, 4]) against one shared grid, all lanes in one loop."""
    if max_iterations is None:
        max_iterations = MAX_NUM_ITERATIONS
    return register_frames_icp_stats(grid, points, mask, guesses, max_dist, kernel, max_iterations)


def batched_icp_two_phase(
    grid: HashGrid, points: torch.Tensor, mask: torch.Tensor, guesses, max_dist: float,
    kernel: float, phase1_iters: Optional[int] = None, stats_fn=None, resume_fn=None,
    pad_multiple: int = 1,
) -> BatchedICP:
    """The far-field row in two phases: every lane runs `phase1_iters` GN
    iterations; a lane that settled there is final, and every other lane
    resumes from its phase-1 pose (re-gathering and re-centring there) with
    the rest of the MAX_NUM_ITERATIONS budget, all of them in one batched
    loop. Iterations, rebuilds and the loop counts are the sums over both
    phases.

    `stats_fn(points, mask, guesses)` and `resume_fn(points, mask, guesses)`
    (each -> `BatchedICP`) replace the two single-device loops: the
    scan-sharded driver passes its stages here, with `pad_multiple` = the
    world size, and the resumed lanes are padded to a multiple of it with
    settled lanes (which re-confirm and are dropped), as the reference
    pads its compacted batch (`:374-385`)."""
    if phase1_iters is None:
        phase1_iters = FAR_FIELD_PHASE1_ITERATIONS
    if stats_fn is None:
        stats_fn = partial(batched_icp_stats, grid, max_dist=max_dist, kernel=kernel,
                           max_iterations=phase1_iters)
    if resume_fn is None:
        resume_fn = partial(register_frames_icp_stats, grid, max_correspondence_distance=max_dist,
                            kernel=kernel, max_iterations=MAX_NUM_ITERATIONS - phase1_iters)
    first = stats_fn(points, mask, guesses)
    resume = np.flatnonzero(~first.settled)
    if resume.size == 0:
        return first
    width = -(-resume.size // pad_multiple) * pad_multiple
    filler = np.flatnonzero(first.settled)
    padded = np.concatenate([resume, np.resize(filler if filler.size else resume, width - resume.size)])
    rows = torch.from_numpy(padded)
    dev_rows = rows.to(points.device)
    second = resume_fn(points[dev_rows], mask[dev_rows], first.poses[rows])
    k = resume.size
    poses = first.poses.clone()
    poses[torch.from_numpy(resume)] = second.poses[:k]
    its, settled, rebuilds = first.iterations.copy(), first.settled.copy(), first.rebuilds.copy()
    its[resume] += second.iterations[:k]
    settled[resume] = second.settled[:k]
    rebuilds[resume] += second.rebuilds[:k]
    loop = collections.Counter(first.loop)
    loop.update(second.loop)
    return BatchedICP(poses, its, settled, rebuilds, loop)


# ---------------------------------------------------------------------------
# Several devices
# ---------------------------------------------------------------------------


def make_mesh(axis_names: Tuple[str, ...] = ("data",), shape: Optional[Tuple[int, ...]] = None):
    """A `DeviceMesh` over the initialised world (reference `:31`): 1-D over
    every rank by default; "cuda" under NCCL, "cpu" under gloo."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def _axis(mesh, axis: str):
    """(group, this rank's index on `axis`, the axis' size)."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _comm_device(group) -> torch.device:
    """Where the group's collectives take their tensors."""
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" \
        else torch.device("cpu")


def shard_rows(x, mesh, axis: str):
    """This rank's contiguous block of x's leading axis on `axis` (the
    reference's `P(axis)` row split; the length must divide by the axis'
    size: pad with masked rows)."""
    _, rank, world = _axis(mesh, axis)
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    k = n // world
    return x[rank * k : (rank + 1) * k]


def rank_seed(scan_seed: int, rank: int) -> int:
    """The generator seed of `scan_seed`'s hypotheses on `rank` (the
    counterpart of the reference's `split(PRNGKey(scan), n_dev)[rank]`):
    rank 0 keeps the scan's own seed, so world size 1 draws what the
    single-device row draws."""
    return int(scan_seed) + int(rank) * 2**32


def _single_pair_register(map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask, voxel_size, sigma):
    """One scan-to-map VFM registration (match -> VFM-ICP -> geometric refine)."""
    grid = build_hash_grid(map_pts, voxel_size, mask=map_mask, feats=map_feats)
    corr = get_vfm_correspondences(grid.points, grid.feats, grid.valid, scan_pts, scan_feats, scan_mask)
    sigma = np.float32(sigma)
    res = register_frame_vfm(grid, scan_pts, scan_mask, corr, torch.eye(4), float(np.float32(3.0) * sigma),
                             float(sigma / np.float32(3.0)), max_iterations=1000)
    return res.pose, corr.count


def batched_registration_step(map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask):
    """The flagship registration of each of B scan-map pairs ([B, M, 3],
    [B, M, D], [B, M], [B, N, 3], [B, N, D], [B, N]; reference `:61`, 1 m
    voxels, sigma 2): (poses [B, 4, 4] host f32, correspondence counts [B])."""
    out = [_single_pair_register(*pair, 1.0, 2.0)
           for pair in zip(map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask)]
    return torch.stack([p for p, _ in out]), torch.stack([c for _, c in out])


def sharded_registration_step(mesh, axis: str = "data"):
    """The pair batch split over `axis` (reference `:71`): each rank calls
    the returned function with its own pairs and gets (its poses, its
    counts, the group's total count: one `psum`)."""
    group = mesh.get_group(axis)

    def step(map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask):
        poses, counts = batched_registration_step(map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask)
        total = collectives.all_reduce(counts.sum().to(torch.int64).reshape(1), SUM, group)
        return poses, counts, total[0]

    return step


def _winner(poses: torch.Tensor, rmse: torch.Tensor, group, rank: int, world: int):
    """Each scan's best pose over the group ([B, 4, 4], [B] on every rank):
    the least RMSE (`pmin`), the lowest rank holding it (`pmin` of the rank
    where equal, else `world`), and that rank's pose broadcast by a `psum`
    masked to it. Returns (poses, rmse)."""
    best = collectives.all_reduce(rmse.clone(), MIN, group)
    winner = torch.where(rmse == best, rank, world).to(torch.int64)
    collectives.all_reduce(winner, MIN, group)
    pose = torch.where((winner == rank)[:, None, None], poses, torch.zeros_like(poses))
    return collectives.all_reduce(pose, SUM, group), best


def _budget_split_ransac(mesh, num_hypotheses: int, axis: str):
    """`f(src [B, N, 3], tgt, mask [B, N], seeds [B], picks=None) -> (poses
    [B, 4, 4], rmse [B])`, the same on every rank of `axis`: this rank
    scores ceil(budget / world) hypotheses of scan j, drawn from a
    generator seeded `rank_seed(seeds[j], rank)` or given as its `picks`
    [B, K, 3], and three collectives choose each scan's winner (`_winner`)."""
    group, rank, world = _axis(mesh, axis)
    per_rank = -(-num_hypotheses // world)

    def run(src, tgt, mask, seeds, picks=None):
        generators = None
        if picks is None:
            generators = [torch.Generator(device=src.device).manual_seed(rank_seed(s, rank)) for s in seeds]
        res = ransac_batched(src, tgt, mask, generators, per_rank, picks=picks)
        return _winner(res.pose, res.rmse, group, rank, world)

    return run


def hypothesis_sharded_batched_ransac(mesh, num_hypotheses: int = 50000, axis: str = "data"):
    """RANSAC of a scan batch with every scan's hypothesis budget split over
    `axis` (reference `:137`): `f(src [B, N, 3], tgt, mask [B, N], seeds [B],
    picks=None) -> poses [B, 4, 4]` (`_budget_split_ransac`)."""
    run = _budget_split_ransac(mesh, num_hypotheses, axis)
    return lambda src, tgt, mask, seeds, picks=None: run(src, tgt, mask, seeds, picks)[0]


def sharded_ransac(mesh, num_hypotheses: int = 50000, axis: str = "data"):
    """The same for one scan (reference `:96`): `f(src [N, 3], tgt, mask
    [N], seed, picks=None [K, 3]) -> (pose [4, 4], rmse)`."""
    run = _budget_split_ransac(mesh, num_hypotheses, axis)

    def one(src, tgt, mask, seed, picks=None):
        poses, rmse = run(src[None], tgt[None], mask[None], [seed],
                          None if picks is None else torch.as_tensor(picks)[None])
        return poses[0], rmse[0]

    return one


class CacheMerge:
    """The `merge_cache` hook of the map-sharded ICP loops (reference
    `_gather_nn_cache`, `:396`; `registration.icp.geometric_icp_loop_lanes`).

    Called with a loop's champion planes [3, B, 32, N] after each B3 round,
    it returns every rank's planes concatenated along the champion axis,
    [3, B, 32 x world, N], rank 0's first. `agree(phase)` reduces the
    lanes' phases [B] over the group with MAX (every rank then gathers,
    rebuilds and stops the same lanes in the same rounds), so the ranks'
    collective calls stay paired even if their reads ever differed."""

    def __init__(self, group):
        self.group = group
        self.device = _comm_device(group)

    def __call__(self, champs: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather(champs, self.group, dim=2)

    def agree(self, phase: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(phase, dtype=np.int32)).to(self.device)
        return collectives.all_reduce(t, MAX, self.group).cpu().numpy()


def map_sharded_icp(
    mesh, voxel_size: float, axis: str = "model", max_points_per_voxel: int = 20,
    max_iterations: int = 1000, refresh_interval: Optional[int] = None,
):
    """Scan-to-map ICP with the map's rows split over `axis` (reference
    `:408`): `f(map_pts [M / world, 3], map_mask, scan_pts [N, 3], scan_mask
    [N], guess [4, 4], max_dist, kernel) -> pose [4, 4]` (host f32), called
    by every rank with its own row block (`shard_rows`) and the same scan.
    Each rank builds a grid over its rows and runs the whole GN loop, the
    champion caches merged after every rebuild (`CacheMerge`): the union
    holds the global nearest neighbour, so a step right after a rebuild is
    exact, and with refresh_interval=1 every step is."""
    group = mesh.get_group(axis)
    if refresh_interval is None:
        refresh_interval = REFRESH_INTERVAL

    def run(map_pts, map_mask, scan_pts, scan_mask, guess, max_dist, kernel):
        grid = build_hash_grid(map_pts, voxel_size, mask=map_mask, max_points_per_voxel=max_points_per_voxel)
        return register_frame_icp(grid, scan_pts, scan_mask, guess, max_dist, kernel,
                                  max_iterations=max_iterations, refresh_interval=refresh_interval,
                                  merge_cache=CacheMerge(group))

    return run


def _vfm_correspondences_sharded(mp, mf, mm, sp, sf, sm, guess, group, min_cosine_similarity):
    guess = torch.as_tensor(guess, dtype=torch.float32)
    return guess, get_vfm_correspondences_map_sharded(mp, mf, mm, transform_points(sp, guess), sf, sm, group,
                                                      min_cosine_similarity)


def _vfm_register_sharded(grid, mp, mf, mm, sp, sf, sm, guess, max_dist, kernel, group,
                          min_cosine_similarity, max_iterations):
    guess, corr = _vfm_correspondences_sharded(mp, mf, mm, sp, sf, sm, guess, group, min_cosine_similarity)
    res = register_frame_vfm(grid, sp, sm, corr, guess, max_dist, kernel, max_iterations=max_iterations,
                             merge_cache=CacheMerge(group))
    return res.pose, corr.count


def map_sharded_vfm_register(
    mesh, voxel_size: float, axis: str = "model", min_cosine_similarity: float = 0.8,
    max_iterations: int = 1000,
):
    """The flagship method against a map whose rows are split over `axis`
    (reference `:480`): `f(map_pts, map_feats, map_mask (this rank's rows),
    scan_pts [N, 3], scan_feats, scan_mask, guess, max_dist, kernel) ->
    (pose [4, 4], correspondence count)`. Matching is
    `get_vfm_correspondences_map_sharded`; phase 2 of VFM-ICP merges the
    champion caches (`CacheMerge`); phase 1 reads no map."""
    group = mesh.get_group(axis)

    def run(mp, mf, mm, sp, sf, sm, guess, max_dist, kernel):
        grid = build_hash_grid(mp, voxel_size, mask=mm)
        return _vfm_register_sharded(grid, mp, mf, mm, sp, sf, sm, guess, max_dist, kernel, group,
                                     min_cosine_similarity, max_iterations)

    return run


def dp_map_sharded_vfm_register(
    mesh, voxel_size: float, data_axis: str = "data", model_axis: str = "model",
    min_cosine_similarity: float = 0.8, max_iterations: int = 1000,
):
    """dp x tp on a 2-D (data, model) mesh (reference `:537`): each rank
    holds its data block of the scans and its model block of the map's rows
    (`shard_rows` on each axis), builds one grid over its rows, matches its
    scans one after another and registers them as lanes of one VFM-ICP loop
    (`register_frames_vfm_lanes`, the reference's vmap) with one
    `CacheMerge`, every collective on the `model` group only:
    `f(map_pts, map_feats, map_mask, scan_pts [B / n_data, N, 3], scan_feats,
    scan_mask, guesses [B / n_data, 4, 4], max_dist, kernel) -> (poses,
    counts)` of this rank's scans."""
    group = mesh.get_group(model_axis)

    def run(mp, mf, mm, sps, sfs, sms, guesses, max_dist, kernel):
        grid = build_hash_grid(mp, voxel_size, mask=mm)
        out = [_vfm_correspondences_sharded(mp, mf, mm, sp, sf, sm, g, group, min_cosine_similarity)
               for sp, sf, sm, g in zip(sps, sfs, sms, guesses)]
        corr = VFMCorrespondences(*(torch.stack(f) for f in zip(*(c for _, c in out))))
        res = register_frames_vfm_lanes(grid, sps, sms, corr, torch.stack([g for g, _ in out]), max_dist,
                                        kernel, max_iterations=max_iterations, merge_cache=CacheMerge(group))
        return res.poses, corr.count

    return run


def map_sharded_driver_stages(
    mesh, voxel_size: float, num_hypotheses: int = 50000, axis: str = "model",
    max_points_per_voxel: int = 20, min_cosine_similarity: float = 0.8,
):
    """The driver's stages with the map's rows split over `axis` and the scan
    batch the same on every rank (reference `:601`). A dict:

    * build(map_pts, map_feats, map_mask) -> this rank's HashGrid over its
      rows (`shard_rows` of the padded map);
    * match(grid, q [B, N, 3], qf [B, N, D], qm [B, N]) -> VFMCorrespondences
      (`get_vfm_correspondences_map_sharded`);
    * snap(src, tgt, mask [B, C, ...], scan_pts, scan_mask [B, S, ...], grid)
      -> (snapped_src, snapped_tgt, ok): the target side per shard, merged
      by one gather of distances and points (`snap_correspondences(group=)`);
    * ransac(src, tgt, mask, seeds, picks=None) -> poses [B, 4, 4]: the
      budget split over `axis` (`hypothesis_sharded_batched_ransac`);
    * icp(grid, points, mask, guesses, max_dist, kernel, max_iterations=None)
      -> BatchedICP with merged champion caches; icp_planes is the same
      (the port's only rebuild is the "planes" one)."""
    group = mesh.get_group(axis)

    def build(mp, mf, mm):
        return build_hash_grid(mp, voxel_size, mask=mm, feats=mf, max_points_per_voxel=max_points_per_voxel)

    def match(grid, q, qf, qm):
        return get_vfm_correspondences_map_sharded(grid.points, grid.feats, grid.valid, q, qf, qm, group,
                                                   min_cosine_similarity)

    def snap(src, tgt, mask, scan_pts, scan_mask, grid):
        return snap_correspondences(src, tgt, mask, scan_pts, scan_mask, grid.points, grid.valid, group=group)

    def icp(grid, points, mask, guesses, max_dist, kernel, max_iterations=None):
        if max_iterations is None:
            max_iterations = MAX_NUM_ITERATIONS
        return register_frames_icp_stats(grid, points, mask, guesses, max_dist, kernel, max_iterations,
                                         merge_cache=CacheMerge(group))

    return {"build": build, "match": match, "snap": snap,
            "ransac": hypothesis_sharded_batched_ransac(mesh, num_hypotheses, axis),
            "icp": icp, "icp_planes": icp}


def sharded_driver_stages(mesh, num_hypotheses: int = 50000, axis: str = "data"):
    """The driver's stages with the scan axis split over `axis` and the map
    the same on every rank (reference `:773`). Each stage takes the whole
    scan batch (its length a multiple of the world size: the driver pads it
    by repeating row 0), runs this rank's contiguous block of scans on the
    single-device row, and gathers the rows back in scan order, so every
    rank returns the whole batch. A dict with the single-device signatures:

    * match(map_pts, map_feats, map_mask, q, qf, qm) -> VFMCorrespondences;
    * snap(src, tgt, mask, scan_pts, scan_mask, map_pts, map_mask);
    * ransac(src, tgt, mask, seeds, picks=None) -> poses (each scan's whole
      budget, seeded with its own seed);
    * icp / icp_planes(grid, points, mask, guesses, max_dist, kernel,
      max_iterations=None) -> BatchedICP (its `loop`: this rank's counts);
      icp_planes_p1 and icp_planes_resume with the far-field row's phase-1
      budget and the rest (`batched_icp_two_phase`)."""
    group = mesh.get_group(axis)
    comm = _comm_device(group)

    def mine(a):
        return shard_rows(a, mesh, axis)

    def gather(t):
        """Every rank's rows of t (a tensor anywhere, or a numpy array) in
        scan order, where t was."""
        host = isinstance(t, np.ndarray)
        x = torch.from_numpy(t) if host else t
        out = collectives.all_gather(x.to(comm), group).to(x.device)
        return out.numpy() if host else out

    def match(mp, mf, mm, q, qf, qm):
        corr = get_vfm_correspondences_batched(mp, mf, mm, mine(q), mine(qf), mine(qm))
        return VFMCorrespondences(*(gather(f) for f in corr))

    def snap(src, tgt, mask, scan_pts, scan_mask, map_pts, map_mask):
        out = snap_correspondences(mine(src), mine(tgt), mine(mask), mine(scan_pts), mine(scan_mask),
                                   map_pts, map_mask)
        return tuple(gather(t) for t in out)

    def ransac(src, tgt, mask, seeds, picks=None):
        return gather(batched_ransac(mine(src), mine(tgt), mine(mask), mine(np.asarray(list(seeds))),
                                     num_hypotheses, None if picks is None else mine(picks)))

    def icp(grid, points, mask, guesses, max_dist, kernel, max_iterations=None):
        r = batched_icp_stats(grid, mine(points), mine(mask), mine(torch.as_tensor(guesses)), max_dist, kernel,
                              max_iterations)
        ints = gather(np.stack([r.iterations, r.settled.astype(np.int64), r.rebuilds], axis=1))
        return BatchedICP(gather(r.poses), ints[:, 0], ints[:, 1] != 0, ints[:, 2], r.loop)

    return {"match": match, "snap": snap, "ransac": ransac, "icp": icp, "icp_planes": icp,
            "icp_planes_p1": partial(icp, max_iterations=FAR_FIELD_PHASE1_ITERATIONS),
            "icp_planes_resume": partial(icp, max_iterations=MAX_NUM_ITERATIONS - FAR_FIELD_PHASE1_ITERATIONS)}
