"""SE(3) pose-graph optimisation: the GTSAM iSAM2 replacement.

Counterpart of `vfmreg_tpu/registration/pose_graph.py`: prior, odometry
and loop-closure factors over [N, 4, 4] poses, residuals
e_ij = log(Z_ij^-1 T_i^-1 T_j) (priors log(Z^-1 T_i)) weighted by per-factor
6-vector information, and a fixed number of Gauss-Newton steps on the dense
[6N, 6N] normal equations with a damped solve (`_optimize`). It runs on the
given device in f32, as the reference.

The Jacobians are exact: forward-mode derivatives of each factor's residual
with respect to the left-multiplied tangents of T_i and T_j at zero (the
reference's `jax.jacfwd`), all 12 directions of all factors in one pass.
The blocks are summed into H and b with `index_put_(accumulate=True)`,
which sums in a fixed order on the card too.

`PoseGraphOptimizer` is the batch API (add_pose / add_prior /
add_odometry / add_loop_closure / optimize). `IncrementalPoseGraph` is the
reference's `PoseGraphOptimizationGtsam` behaviour: chained odometry
initial estimates, optimise on the first loop or after `min_factors`
factors, `pose_at(-1)`, and each update warm-started and limited to the
vertices downstream of the earliest one a new factor touches (the others
frozen as gauge by a large diagonal), skipped when nothing is new.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from vfmreg_tpu_torch.geometry.se3 import exp_se3, inverse_se3, log_se3
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision

# The reference's noise defaults (GLIM's parameters): odometry ~ (0.01 m,
# ~0.3 deg), loop closures looser, the prior very tight.
PRIOR_SIGMAS = np.full(6, 1e-6)
ODOM_SIGMAS = np.array([0.01, 0.01, 0.01, 0.005, 0.005, 0.005])
LOOP_SIGMAS = np.array([0.1, 0.1, 0.1, 0.05, 0.05, 0.05])


class Factor(NamedTuple):
    i: int
    j: int  # -1 for priors
    measurement: np.ndarray  # [4, 4]
    sigmas: np.ndarray  # [6]


def _factor_residual(Ti, Tj, Z, is_prior):
    """[F, 6] residuals: log(Z^-1 Ti^-1 Tj), or log(Z^-1 Ti) for priors."""
    Zi = inverse_se3(Z)
    between = log_se3(Zi @ inverse_se3(Ti) @ Tj)
    prior = log_se3(Zi @ Ti)
    return torch.where(is_prior[:, None], prior, between)


def _jacobians(Ti, Tj, Z, is_prior):
    """(r [F, 6], J [F, 6, 12]): the residuals and their derivatives with
    respect to eps in exp(eps[:6]) Ti and exp(eps[6:]) Tj at eps = 0."""
    f = Ti.shape[0]

    def rep(x):
        return x.repeat((12,) + (1,) * (x.ndim - 1))

    eye = torch.eye(12, dtype=Ti.dtype, device=Ti.device)
    with fwAD.dual_level():
        eps = fwAD.make_dual(torch.zeros((12 * f, 12), dtype=Ti.dtype, device=Ti.device),
                             eye.repeat_interleave(f, dim=0))
        res = _factor_residual(exp_se3(eps[:, :6]) @ rep(Ti), exp_se3(eps[:, 6:]) @ rep(Tj), rep(Z),
                               rep(is_prior))
        r, tangent = fwAD.unpack_dual(res)
    return r[:f], tangent.reshape(12, f, 6).permute(1, 2, 0)


def _optimize(poses, fi, fj, meas, weights, active=None, num_iters: int = 20, damping: float = 1e-6):
    """`num_iters` GN steps from poses [N, 4, 4] over the factors (fi, fj
    [F] int64, fj = -1 for priors; meas [F, 4, 4]; weights [F, 6] =
    1 / sigma^2). `active`: optional [N] bool, the vertices that move; the
    others are frozen by a 1e12 diagonal."""
    n = poses.shape[0]
    dev = poses.device
    is_prior = fj < 0
    fj0 = torch.clamp(fj, min=0)
    if active is None:
        pen = torch.full((6 * n,), damping, dtype=poses.dtype, device=dev)
    else:
        pen = torch.where(torch.repeat_interleave(active, 6), damping, 1e12).to(poses.dtype)
    eye = torch.eye(4, dtype=poses.dtype, device=dev)
    k6 = torch.arange(6, device=dev)
    for _ in range(num_iters):
        Ti = poses[fi]
        Tj = torch.where(is_prior[:, None, None], eye, poses[fj0])
        r, J = _jacobians(Ti, Tj, meas, is_prior)
        Ji, Jj = J[:, :, :6], J[:, :, 6:]
        Jj = torch.where(is_prior[:, None, None], 0.0, Jj)  # a prior has no second block
        Hii = torch.einsum("fri,fr,frj->fij", Ji, weights, Ji)
        Hjj = torch.einsum("fri,fr,frj->fij", Jj, weights, Jj)
        Hij = torch.einsum("fri,fr,frj->fij", Ji, weights, Jj)
        bi = torch.einsum("fri,fr,fr->fi", Ji, weights, r)
        bj = torch.einsum("fri,fr,fr->fi", Jj, weights, r)

        ii = (6 * fi)[:, None] + k6  # [F, 6] rows of each factor's blocks
        jj = (6 * fj0)[:, None] + k6
        H = torch.zeros((6 * n, 6 * n), dtype=poses.dtype, device=dev)
        for a, b_, blk in ((ii, ii, Hii), (jj, jj, Hjj), (ii, jj, Hij), (jj, ii, Hij.transpose(1, 2))):
            H.index_put_((a[:, :, None].expand(-1, 6, 6), b_[:, None, :].expand(-1, 6, 6)), blk, accumulate=True)
        b = torch.zeros(6 * n, dtype=poses.dtype, device=dev)
        b.index_put_((ii,), bi, accumulate=True)
        b.index_put_((jj,), bj, accumulate=True)
        dx = torch.linalg.solve(H + torch.diag(pen), -b).reshape(n, 6)
        poses = exp_se3(dx) @ poses
    return poses


def _factor_tensors(factors: List[Factor], index, dev):
    fi = torch.tensor([index[f.i] for f in factors], dtype=torch.int64, device=dev)
    fj = torch.tensor([index[f.j] if f.j >= 0 else -1 for f in factors], dtype=torch.int64, device=dev)
    meas = torch.from_numpy(np.stack([f.measurement for f in factors]).astype(np.float32)).to(dev)
    weights = torch.from_numpy(np.stack([1.0 / np.square(f.sigmas) for f in factors]).astype(np.float32)).to(dev)
    return fi, fj, meas, weights


class PoseGraphOptimizer:
    """The batch API of `PoseGraphOptimizationGtsam`: add_pose / add_prior /
    add_odometry / add_loop_closure / optimize / get_poses, on `device`
    (default: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.initial: List[np.ndarray] = []
        self.factors: List[Factor] = []

    def add_pose(self, pose: np.ndarray) -> int:
        self.initial.append(np.asarray(pose, dtype=np.float64))
        return len(self.initial) - 1

    def add_prior(self, i: int, pose: np.ndarray, sigmas=PRIOR_SIGMAS):
        self.factors.append(Factor(i, -1, np.asarray(pose), np.asarray(sigmas)))

    def add_odometry(self, i: int, j: int, relative: np.ndarray, sigmas=ODOM_SIGMAS):
        self.factors.append(Factor(i, j, np.asarray(relative), np.asarray(sigmas)))

    def add_loop_closure(self, i: int, j: int, relative: np.ndarray, sigmas=LOOP_SIGMAS):
        self.factors.append(Factor(i, j, np.asarray(relative), np.asarray(sigmas)))

    def optimize(self, num_iters: int = 20) -> List[np.ndarray]:
        full_precision()
        poses = torch.from_numpy(np.stack(self.initial).astype(np.float32)).to(self.device)
        index = {k: k for k in range(len(self.initial))}
        out = _optimize(poses, *_factor_tensors(self.factors, index, self.device), num_iters=num_iters)
        self.initial = [p.astype(np.float64) for p in out.cpu().numpy()]
        return self.initial

    def get_poses(self) -> List[np.ndarray]:
        return list(self.initial)


class IncrementalPoseGraph:
    """The reference's `PoseGraphOptimizationGtsam` (`vfm_reg/
    pose_graph_optimization.py:10-115`) on the batch solver, warm-started
    and limited to the active window, on `device` (default: the card)."""

    def __init__(self, min_factors: int = 1, device=None):
        self.device = resolve_device(device)
        self.min_factors = min_factors
        self.vertex_ids: List[int] = []
        self.edges: List[tuple] = []
        self._initial: dict = {}  # vertex id -> [4, 4] initial estimate
        self._current: dict = {}  # vertex id -> [4, 4] optimized estimate
        self._factors: List[Factor] = []
        self._n_new_factors = 0
        self._new_min_vertex: Optional[int] = None  # earliest vertex touched since the last solve
        self.new_loops_count = 0

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return len(self.vertex_ids)

    @property
    def poses(self) -> List[np.ndarray]:
        return [self.pose_at(i) for i in self.vertex_ids]

    def pose_at(self, vertex_id: int) -> np.ndarray:
        """The optimised pose, or the initial estimate of a vertex no solve
        has seen; -1 is the last vertex."""
        if vertex_id == -1:
            vertex_id = self.vertex_ids[-1]
        if vertex_id in self._current:
            return self._current[vertex_id]
        return self._initial[vertex_id]

    def _touch(self, *vertex_ids):
        lo = min(vertex_ids)
        if self._new_min_vertex is None or lo < self._new_min_vertex:
            self._new_min_vertex = lo

    def add_prior_factor_pose(self, vertex_id: int, pose: np.ndarray, sigmas=PRIOR_SIGMAS):
        pose = np.asarray(pose, dtype=np.float64)
        self._factors.append(Factor(vertex_id, -1, pose, np.asarray(sigmas)))
        self._initial[vertex_id] = pose
        self.vertex_ids.append(vertex_id)
        self._n_new_factors += 1
        self._touch(vertex_id)

    def add_odom_edge(self, vertex_id: int, measurement: np.ndarray, sigma=ODOM_SIGMAS):
        """An edge from the last vertex; the new vertex's initial estimate is
        the last pose @ measurement."""
        prev = self.vertex_ids[-1]
        measurement = np.asarray(measurement, dtype=np.float64)
        sig = np.full(6, sigma) if np.isscalar(sigma) else np.asarray(sigma)
        self._factors.append(Factor(prev, vertex_id, measurement, sig))
        self._initial[vertex_id] = self.pose_at(prev) @ measurement
        self.vertex_ids.append(vertex_id)
        self.edges.append((prev, vertex_id))
        self._n_new_factors += 1
        self._touch(prev, vertex_id)

    def add_loop_edge(self, vertex_id1: int, vertex_id2: int, measurement: np.ndarray, sigma=LOOP_SIGMAS):
        measurement = np.asarray(measurement, dtype=np.float64)
        sig = np.full(6, sigma) if np.isscalar(sigma) else np.asarray(sigma)
        self._factors.append(Factor(vertex_id1, vertex_id2, measurement, sig))
        self.edges.append((vertex_id1, vertex_id2))
        self._n_new_factors += 1
        self.new_loops_count += 1
        self._touch(vertex_id1, vertex_id2)

    def optimize_if_needed(self) -> bool:
        """The reference's policy: optimise when exactly one loop is new
        (it never resets that count), else when `min_factors` factors are."""
        if self.new_loops_count == 1:
            self.optimize()
            return True
        if self._n_new_factors >= self.min_factors:
            self.optimize()
            self.new_loops_count = 0
            return True
        return False

    def optimize(self, num_iters: int = 20) -> None:
        # Nothing new since the last solve: the solution is current.
        if self._current and self._n_new_factors == 0 and self._new_min_vertex is None:
            return
        full_precision()
        order = {v: k for k, v in enumerate(self.vertex_ids)}
        poses0 = np.stack([self.pose_at(v) for v in self.vertex_ids])
        # The active window: every vertex from the earliest a new factor
        # touched on; the first solve is a full batch.
        if self._new_min_vertex is None or not self._current:
            active = np.ones(len(self.vertex_ids), dtype=bool)
        else:
            active = np.arange(len(self.vertex_ids)) >= order[self._new_min_vertex]
        active_arg = None if active.all() else torch.from_numpy(active).to(self.device)
        out = _optimize(torch.from_numpy(poses0.astype(np.float32)).to(self.device),
                        *_factor_tensors(self._factors, order, self.device), active=active_arg,
                        num_iters=num_iters)
        out = out.cpu().numpy().astype(np.float64)
        for k, v in enumerate(self.vertex_ids):
            self._current[v] = out[k]
        self._n_new_factors = 0
        self._new_min_vertex = None
