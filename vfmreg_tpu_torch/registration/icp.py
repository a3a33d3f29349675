"""Point-to-point Gauss-Newton ICP against the voxel hash grid, all lanes of a row in lockstep.

Counterpart of the scan-to-map parts of `vfmreg_tpu/registration/icp.py`:
`build_linear_system` (`:83`), `gn_step` (`:141`, with the unrolled
`_cholesky_solve6` of `:111`) over lanes as `gn_solve_lanes`,
`geometric_icp_loop` (`:159`) with the reference's
"planes" champion rebuild on every path (kernel B3), and the entry point
`register_frame_icp_stats` (`:478`, through `_register_frame_icp_state`,
`:396`), `register_frame_icp` (`:443`, its `.pose`) and the XD path's
`register_frame_icp_xd` (`:505`).

The reference runs the B lanes of a row under `vmap`: one device loop,
masked carries, a converged lane idling bit-exactly while the others finish.
`geometric_icp_loop_lanes` does the same on the card. The lanes' state
(`ops/gn_kernel.GNLanes`: iteration, inner step, flags, motion bound, pose)
lives on the device; one call of kernel B2 (`gn_step_lanes`) is one GN step
of every live lane, solve and pose update included; one launch of kernel B3
(`champions_from_planes_lanes`) rebuilds the champions of every lane that
needs it, and `mark_rebuilt` marks those lanes in their state. The host decides only where the lanes go between steps: after
`GN_STEPS_PER_READ` step calls it reads one small [B, 8] vector of lane
state, re-gathers the slabs of the lanes whose motion bound ran out (one
gather over their concatenated queries, the grid is shared), and flags the
lanes whose champions need a rebuild. A lane takes the reference's sequence
of steps whatever the others do, so each lane's result is that of its own
run, and `geometric_icp_loop` is the B = 1 call.

The XD path (`qfeats`: the query descriptors) takes the same loop with the
reference's cosine-weighted champions (`ops.hash_grid.candidate_weights`,
`build_weighted_nn_cache`, `nn_from_weighted_cache`), which the reference
computes outside its Pallas kernels: plain PyTorch on the lanes' device,
with the same rounds, reads and lane state, and no launch of B2 or B3.

VFM-ICP's phase 1 (`registration/vfm_icp.py`) steps its lanes on the
device with `build_linear_system` and `gn_solve_lanes`.
"""

from __future__ import annotations

import collections
import contextlib
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from vfmreg_tpu_torch.geometry.se3 import hat_so3, transform_points, transform_points_lanes
from vfmreg_tpu_torch.ops.champion_kernel import champions_from_planes_lanes, new_champion_buffer
from vfmreg_tpu_torch.ops.gn_kernel import (
    CONF,
    DONE,
    FINISHED,
    GATHER,
    GATHERED,
    IT,
    PHASE,
    REBUILD,
    REBUILDS,
    REBUILT,
    _cholesky_solve6_lanes,
    gn_finish_lanes_plain,
    gn_step_lanes,
    lanes_live,
    mark_rebuilt,
    moment_terms,
    new_gn_lanes,
)
from vfmreg_tpu_torch.ops.hash_grid import (
    HashGrid,
    WeightedNNCache,
    build_weighted_nn_cache,
    candidate_weights,
    gather_candidate_slabs,
    nn_from_weighted_cache,
)
from vfmreg_tpu_torch.utils.profiling import span

MAX_NUM_ITERATIONS = 1000  # Registration.cpp:92
ESTIMATION_THRESHOLD = 1e-4  # Registration.cpp:93
# GN budget of the first phase of the drivers' two-phase far-field (vanilla
# ICP) rows: a lane that has not settled by then resumes from its phase-1
# pose with the rest of MAX_NUM_ITERATIONS (`parallel/mesh.py`).
FAR_FIELD_PHASE1_ITERATIONS = 256
# Champion caches are rebuilt from the epoch's gathered slabs at least every
# REFRESH_INTERVAL GN iterations (see the reference for the rationale).
REFRESH_INTERVAL = 16
# GN step calls between two reads of the lane state: the reference's
# `unroll` on the TPU (`vfmreg_tpu/registration/icp.py:249`). A lane that
# needs a rebuild or a gather waits for the read; more steps per read mean
# fewer reads and more idle step calls (PERF.md compares 1, 4 and 16).
GN_STEPS_PER_READ = 4

# The open `recording_loops` blocks' logs.
_LOOP_LOGS: List[List[dict]] = []


@contextlib.contextmanager
def recording_loops():
    """A list that collects, for every call of `geometric_icp_loop_lanes`
    made inside the block, its lanes' GN iterations and rebuilds and the
    loop's counts: a driver of a whole pipeline (`chip_smoke.py`) holds
    every ICP loop it ran against the kernels' launch counts."""
    log: List[dict] = []
    _LOOP_LOGS.append(log)
    try:
        yield log
    finally:
        _LOOP_LOGS[:] = [other for other in _LOOP_LOGS if other is not log]


def build_linear_system(source, target, weight_mask, kernel, center):
    """Masked robust normal equations centred at `center`:
    (JTJ [6,6], JTr [6], n_corr) with J_i = [I | -hat(s_i - c)] and the
    Geman-McClure weight k^2 / (k + |r|^2)^2."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=source.device)
    s_c = source - center
    residual = source - target
    r2 = torch.sum(residual * residual, dim=-1)
    w = (kernel * kernel) / torch.square(kernel + r2)
    w = torch.where(weight_mask, w, 0.0)
    n = source.shape[0]
    J = torch.zeros((n, 3, 6), dtype=source.dtype, device=source.device)
    J[:, :, :3] = torch.eye(3, dtype=source.dtype, device=source.device)
    J[:, :, 3:] = -hat_so3(s_c)
    JTJ = torch.einsum("nij,n,nik->jk", J, w, J)
    JTr = torch.einsum("nij,n,ni->j", J, w, residual)
    return JTJ, JTr, weight_mask.sum()


def gn_solve_lanes(JTJ: torch.Tensor, JTr: torch.Tensor, n_corr: torch.Tensor) -> torch.Tensor:
    """The reference's `gn_step` (`:141`) on B lanes at once, on the systems'
    device: JTJ [B, 6, 6], JTr [B, 6], n_corr [B] -> dx [B, 6] solving
    (JTJ + 1e-8 I) dx = -JTr by the unrolled Cholesky
    (`ops.gn_kernel._cholesky_solve6_lanes`, the reference's order of
    operations: a library Cholesky rounds differently, and the iteration
    counts hinge on |dx| < 1e-4), zero where the lane's system is empty or
    the solve is not finite. Elementwise over the lanes: no read."""
    eye = torch.eye(6, dtype=JTJ.dtype, device=JTJ.device)
    A = JTJ + 1e-8 * eye
    x = _cholesky_solve6_lanes([[A[:, i, j] for j in range(6)] for i in range(6)],
                               [-JTr[:, i] for i in range(6)])
    ok = (n_corr > 0) & torch.isfinite(x).all(dim=1)
    return torch.where(ok[:, None], x, 0.0)


def champion_group(grid: HashGrid) -> int:
    """Kernel B3's candidate lanes per voxel: the per-voxel cap rounded up
    to a multiple of 8, which trims the slab's sentinel lanes (20 -> 24 of
    32). A slab row holds 32 lanes per coordinate for every 32 of the cap,
    so this never exceeds the slab."""
    return -(-grid.max_points_per_voxel // 8) * 8


def _gather_planes(grid: HashGrid, source: torch.Tensor, mask: torch.Tensor, lanes: np.ndarray,
                   group: int, planes: torch.Tensor) -> None:
    """One slab gather around the current queries of `lanes` (ascending),
    transposed into those lanes' rows of `planes` [3, B, 27 * group, N]:
    each lane gets its `Candidates.planes(group)`."""
    b, n = source.shape[:2]
    L = len(lanes)
    idx = None if L == b else torch.from_numpy(lanes).to(source.device)
    q, m = (source, mask) if idx is None else (source[idx], mask[idx])
    cands = gather_candidate_slabs(grid, q.reshape(-1, 3), m.reshape(-1))
    for c, a in enumerate(cands.coords()):  # [L * N, 27, S * 32]
        a = a[:, :, :group].reshape(L, n, 27, group).permute(0, 2, 3, 1).reshape(L, 27 * group, n)
        if idx is None:
            planes[c].copy_(a)
        else:
            planes[c].index_copy_(0, idx, a)


def _gn_step_lanes_weighted(champs: torch.Tensor, source: torch.Tensor, mask: torch.Tensor,
                            center: torch.Tensor, kernel: float, max_dist: float, threshold: float,
                            refresh_interval: int, st) -> None:
    """One GN step of every live lane on the XD path, in place, in plain
    PyTorch: each lane's weighted champion (champs [4, B, 32, N]: x, y, z and
    weight), the Euclidean gate `dist < max_dist`, the moments, then B2's
    finishing stage (`gn_finish_lanes_plain`) and the move of the live
    lanes' sources. Frozen lanes are left as they were."""
    live = lanes_live(st, threshold, refresh_interval)
    k = torch.tensor(kernel, dtype=torch.float32, device=source.device)
    m = []
    for j in range(source.shape[0]):
        nbr, dist, found = nn_from_weighted_cache(WeightedNNCache(*champs[:, j]), source[j], mask[j])
        d = source[j] - nbr
        r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        m.append(moment_terms(source[j], nbr, r2, found & (dist < max_dist), k, center[j]).sum(dim=1))
    gn_finish_lanes_plain(torch.stack(m), st, center, live, threshold, refresh_interval)
    source.copy_(torch.where(live[:, None, None], transform_points_lanes(source, st.est), source))


class ICPLanes(NamedTuple):
    source: torch.Tensor  # [B, N, 3] device, current world-frame sources
    T_icp: torch.Tensor  # [B, 4, 4] host f32, accumulated corrections
    it: np.ndarray  # [B] GN iterations so far (including `it0`)
    done: np.ndarray  # [B] stopped on an empty correspondence set
    confirmed: np.ndarray  # [B] converged on a freshly rebuilt champion cache
    rebuilds: np.ndarray  # [B] champion-cache rebuilds
    # The host loop's own counts: step_calls (kernel B2 calls), reads (of
    # the device), rebuild_rounds (kernel B3 launches), lane_rebuilds (lanes
    # flagged for a rebuild), gather_rounds, lane_gathers.
    loop: collections.Counter


def geometric_icp_loop_lanes(
    grid: HashGrid,
    source0: torch.Tensor,
    mask: torch.Tensor,
    T_icp0: torch.Tensor,
    center: torch.Tensor,
    max_dist: float,
    kernel: float,
    max_iterations: int,
    estimation_threshold: float,
    it0: Union[int, Sequence[int]],
    refresh_interval: int = REFRESH_INTERVAL,
    qfeats: Optional[torch.Tensor] = None,
    merge_cache=None,
) -> ICPLanes:
    """The reference's three nested loops with their three rules, for B
    lanes at once (source0 [B, N, 3], mask [B, N], T_icp0 [B, 4, 4],
    center [B, 3]; `it0` per lane or shared):

    * one 27-voxel slab gather per motion epoch; the epoch ends once the
      accumulated motion bound (|dt| + |omega| * r_max) reaches half a voxel;
    * the champion cache is rebuilt from the epoch's slabs at least every
      `refresh_interval` GN iterations;
    * |dx| < threshold ends the loop only on the first iteration after a
      rebuild (fresh-confirmed); a sub-threshold step on a stale cache
      triggers a rebuild and a fresh check instead.

    Each lane keeps them by its own state, as the vmapped loop's masked
    carries do: each GN step leaves the lane's phase (step on, rebuild,
    gather, finished), which the host reads every `GN_STEPS_PER_READ` step
    calls. Each slab gather is transposed once into the lane's planes
    buffer, and each rebuild gives `build_nn_cache`'s champions bit for bit
    (the reference's rebuild_mode="planes"; its "slabs" mode is not ported,
    and `build_nn_cache` stays as the reference B3 is held against).

    With `qfeats` [B, N, D] (D the grid's descriptor dim) the champions are
    the XD path's weighted ones: per gather the lane's slabs and their
    weights, per rebuild `build_weighted_nn_cache`, per step
    `_gn_step_lanes_weighted`, lane by lane in plain PyTorch.

    `merge_cache` is the hook of map-sharded registration
    (`parallel.mesh.CacheMerge`, the reference's at `icp.py:287-292`): each
    rank's grid holds one shard of the map rows, every B3 round's champions
    [3, B, 32, N] are gathered over the ranks into [3, B, 32 x world, N]
    (rank 0's first, so B2's lowest-k tie rule gives the lowest rank), and
    the GN steps read the merged cache. The union holds the global nearest
    neighbour, so a step right after a rebuild is exact. Each round's lane
    phases go through `merge_cache.agree` (MAX over the ranks) before the
    host acts on them, so every rank gathers, rebuilds and stops the same
    lanes in the same rounds and the ranks' collectives stay paired. The XD
    path refuses it, as the reference does."""
    with span("icp.loop"):
        if qfeats is not None and merge_cache is not None:
            raise ValueError("merge_cache is not supported on the XD weighted path")
        dev = source0.device
        b, n = source0.shape[:2]
        f32 = torch.float32
        source = source0.to(f32).contiguous().clone()  # moved in place
        mask = mask.contiguous()
        center = center.to(dev, f32).contiguous()
        d = source - center[:, None]
        # Elementwise, so that a lane's lever arm does not depend on its row's width.
        d2c = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        r_max = torch.sqrt(torch.amax(torch.where(mask, d2c, 0.0), dim=1))
        slack = float(np.float32(0.5) * np.float32(grid.voxel_size))
        st = new_gn_lanes(torch.as_tensor(T_icp0), it0, max_iterations, r_max, slack, n)
        weighted = qfeats is not None
        champs = new_champion_buffer(b, n, dev)
        if weighted:
            cands, weights = [None] * b, [None] * b  # each lane's epoch: slabs and their weights
            champs = torch.cat([champs, torch.ones((1, b, 32, n), dtype=f32, device=dev)])
        else:
            group = champion_group(grid)
            planes = torch.empty((3, b, 27 * group, n), dtype=f32, device=dev)
        flags = torch.zeros(b, dtype=torch.int32, device=dev)
        flags_host = torch.zeros(b, dtype=torch.int32, pin_memory=dev.type == "cuda")

        phase = np.where(np.broadcast_to(it0, (b,)) < max_iterations, GATHER, FINISHED)
        loop = collections.Counter(step_calls=0, reads=0, rebuild_rounds=0, lane_rebuilds=0,
                                   gather_rounds=0, lane_gathers=0)
        # Every round advances every unfinished lane by at least one step.
        max_rounds = int(max_iterations - np.min(it0))
        ints = None
        step_champs = champs  # what the GN steps read: the merged cache under `merge_cache`
        while not (phase == FINISHED).all():
            if loop["reads"] >= max_rounds:
                raise RuntimeError(f"ICP lanes made no progress in {max_rounds} rounds: phases {phase.tolist()}")
            gather = np.flatnonzero(phase == GATHER)
            rebuild = np.flatnonzero((phase == GATHER) | (phase == REBUILD))
            if gather.size:
                if weighted:
                    for j in gather:
                        cands[j] = gather_candidate_slabs(grid, source[j], mask[j])
                        weights[j] = candidate_weights(cands[j], grid.feats, qfeats[j])
                else:
                    _gather_planes(grid, source, mask, gather, group, planes)
                loop["gather_rounds"] += 1
                loop["lane_gathers"] += gather.size
            if rebuild.size:
                # The previous round's read has synchronised: the pinned buffer is free.
                fh = flags_host.numpy()
                fh[:] = 0
                fh[rebuild] = REBUILT
                fh[gather] = GATHERED
                flags.copy_(flags_host, non_blocking=True)
                if weighted:
                    for j in rebuild:
                        champs[:, j] = torch.stack(build_weighted_nn_cache(cands[j], weights[j], source[j],
                                                                           mask[j]))
                else:
                    champions_from_planes_lanes(planes[0], planes[1], planes[2], source, mask, flags, group,
                                                champs)
                    if merge_cache is not None:
                        step_champs = merge_cache(champs)
                mark_rebuilt(st, flags)
                loop["rebuild_rounds"] += 1
                loop["lane_rebuilds"] += rebuild.size
            for _ in range(GN_STEPS_PER_READ):
                if weighted:
                    _gn_step_lanes_weighted(champs, source, mask, center, kernel, max_dist,
                                            estimation_threshold, refresh_interval, st)
                else:
                    gn_step_lanes(step_champs[0], step_champs[1], step_champs[2], source, center, kernel,
                                  max_dist, estimation_threshold, refresh_interval, st)
            loop["step_calls"] += GN_STEPS_PER_READ
            ints = st.ints.cpu().numpy()
            loop["reads"] += 1
            phase = ints[:, PHASE]
            if merge_cache is not None:
                phase = merge_cache.agree(phase)
        if ints is None:  # every lane started finished
            ints = st.ints.cpu().numpy()
            loop["reads"] += 1
        T_icp = st.T.cpu()
        loop["reads"] += 1
        for log in _LOOP_LOGS:
            log.append({"iterations": (ints[:, IT] - np.broadcast_to(it0, (b,))).tolist(),
                        "rebuilds": ints[:, REBUILDS].tolist(), "loop": dict(loop), "weighted": weighted})
        return ICPLanes(source, T_icp, ints[:, IT].astype(np.int64), ints[:, DONE] != 0,
                        ints[:, CONF] != 0, ints[:, REBUILDS].astype(np.int64), loop)


class ICPState(NamedTuple):
    source: torch.Tensor  # [N, 3] device, current world-frame source
    T_icp: torch.Tensor  # [4, 4] host f32, accumulated correction
    it: int  # GN iterations so far (including `it0`)
    done: bool  # stopped on an empty correspondence set
    confirmed: bool  # converged on a freshly rebuilt champion cache
    rebuilds: int  # champion-cache rebuilds
    loop: Optional[collections.Counter] = None  # `ICPLanes.loop`


def geometric_icp_loop(
    grid: HashGrid,
    source0: torch.Tensor,
    mask: torch.Tensor,
    T_icp0: torch.Tensor,
    center: torch.Tensor,
    max_dist: float,
    kernel: float,
    max_iterations: int,
    estimation_threshold: float,
    it0: int,
    refresh_interval: int = REFRESH_INTERVAL,
    merge_cache=None,
) -> ICPState:
    """`geometric_icp_loop_lanes` for one lane: source0 [N, 3], mask [N],
    T_icp0 a host f32 [4, 4], center an f32 [3]."""
    r = geometric_icp_loop_lanes(
        grid, source0[None], mask[None], torch.as_tensor(T_icp0)[None],
        torch.as_tensor(center)[None], max_dist, kernel, max_iterations, estimation_threshold,
        it0, refresh_interval, merge_cache=merge_cache,
    )
    return ICPState(r.source[0], r.T_icp[0], int(r.it[0]), bool(r.done[0]), bool(r.confirmed[0]),
                    int(r.rebuilds[0]), r.loop)


class ICPStats(NamedTuple):
    pose: torch.Tensor  # [4, 4] host f32: T_icp @ initial_guess
    iterations: int  # GN iterations
    settled: bool  # stopped on its own (confirmed or no correspondences), not on the budget
    rebuilds: int  # champion-cache rebuilds
    loop: Optional[collections.Counter] = None  # `ICPLanes.loop`


class BatchedICP(NamedTuple):
    poses: torch.Tensor  # [B, 4, 4] host f32
    iterations: np.ndarray  # [B] GN iterations per lane
    settled: np.ndarray  # [B] stopped on its own, not on the budget
    rebuilds: np.ndarray  # [B] champion-cache rebuilds per lane
    loop: Optional[collections.Counter] = None  # `ICPLanes.loop`, summed over the calls


def register_frames_icp_stats(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    initial_guesses,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
    qfeats: Optional[torch.Tensor] = None,
    refresh_interval: int = REFRESH_INTERVAL,
    merge_cache=None,
) -> BatchedICP:
    """KISS-ICP `RegisterFrame` for 3D points (`Registration.cpp:145-195`)
    for B lanes at once (points [B, N, 3], mask [B, N], initial_guesses
    [B, 4, 4]), with each lane's iteration count, whether it settled and its
    champion rebuilds. Each lane's GN solve is centred on the mean of its
    guess-transformed source; the centres and lever arms stay on the device.
    A run resumed from a returned pose continues the same trajectory up to
    that re-centring.

    The transform and the centre of a lane are computed on its own valid
    points, lane by lane: a batched product, or a sum over a padded row,
    rounds otherwise on the card as the row's width changes, and a lane
    must give what its own one-lane run gives (the driver's serial and
    batched rows are held equal). Padding rows stay zero; no step reads them.
    With `qfeats` [B, N, D] the lanes take the XD path's weighted champions,
    and with `merge_cache` a map-sharded grid's merged champions
    (`geometric_icp_loop_lanes`)."""
    points = points.to(torch.float32)
    b = points.shape[0]
    guesses = torch.as_tensor(initial_guesses).to("cpu", torch.float32)
    on_dev = guesses.to(points.device)
    source0 = torch.zeros_like(points)
    center = torch.zeros((b, 3), dtype=torch.float32, device=points.device)
    for j in range(b):
        moved = transform_points(points[j][mask[j]], on_dev[j])
        source0[j][mask[j]] = moved
        center[j] = moved.sum(dim=0) / max(moved.shape[0], 1)
    eye = torch.eye(4, dtype=torch.float32).expand(b, 4, 4)
    r = geometric_icp_loop_lanes(
        grid, source0, mask, eye, center, max_correspondence_distance, kernel, max_iterations,
        ESTIMATION_THRESHOLD, it0=0, refresh_interval=refresh_interval, qfeats=qfeats,
        merge_cache=merge_cache,
    )
    poses = torch.stack([r.T_icp[j] @ guesses[j] for j in range(b)])
    return BatchedICP(poses, r.it, r.done | r.confirmed, r.rebuilds, r.loop)


def register_frame_icp(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    initial_guess,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
    refresh_interval: int = REFRESH_INTERVAL,
    merge_cache=None,
) -> torch.Tensor:
    """KISS-ICP `RegisterFrame` for one scan's 3D points (reference
    `register_frame_icp`, `vfmreg_tpu/registration/icp.py:443`): the pose
    [4, 4] (host f32) of `register_frame_icp_stats`."""
    return register_frame_icp_stats(grid, points, mask, initial_guess, max_correspondence_distance,
                                    kernel, max_iterations, refresh_interval, merge_cache).pose


def register_frame_icp_stats(
    grid: HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    initial_guess,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
    refresh_interval: int = REFRESH_INTERVAL,
    merge_cache=None,
) -> ICPStats:
    """`register_frames_icp_stats` for one lane: points [N, 3], mask [N],
    initial_guess [4, 4]."""
    guess = torch.as_tensor(initial_guess).to("cpu", torch.float32)
    r = register_frames_icp_stats(grid, points[None], mask[None], guess[None],
                                  max_correspondence_distance, kernel, max_iterations,
                                  refresh_interval=refresh_interval, merge_cache=merge_cache)
    return ICPStats(r.poses[0], int(r.iterations[0]), bool(r.settled[0]), int(r.rebuilds[0]), r.loop)


def register_frame_icp_xd(
    grid: HashGrid,
    points: torch.Tensor,
    feats: torch.Tensor,
    mask: torch.Tensor,
    initial_guess,
    max_correspondence_distance: float,
    kernel: float,
    max_iterations: int = MAX_NUM_ITERATIONS,
) -> torch.Tensor:
    """KISS-ICP `RegisterFrame` for XD points (`Registration.cpp:384-422`):
    the 3-D loop with the reference's live cosine-weighted champion metric
    (`VoxelHashMap.cpp:370-384`; points [N, 3], feats [N, D] with D the
    grid's descriptor dim, mask [N]); acceptance and residuals stay
    Euclidean. The pose [4, 4] (host f32)."""
    guess = torch.as_tensor(initial_guess).to("cpu", torch.float32)
    r = register_frames_icp_stats(grid, points[None], mask[None], guess[None], max_correspondence_distance,
                                  kernel, max_iterations, qfeats=feats.to(torch.float32)[None].contiguous())
    return r.poses[0]
