"""TEASER: max-clique inlier selection, GNC-TLS rotation and TLS translation.

Counterpart of `vfmreg_tpu/registration/teaser.py`: `teaser_registration_exact`
(`:222-264`) with `_solve_on_clique`, `_gnc_tls_rotation`, `_scalar_tls`
and `_tls_translation` (`:92-215`), the solver the reference driver
configures at `registration_node.py:112-127`: cbar2 = 1, noise_bound = 0.2,
no scale, PMC exact max clique, CHAIN rotation TIMs, GNC-TLS rotation
(factor 1.4, cost threshold 1e-16); and the greedy `teaser_registration`
(`:165-191`) with `_consistency_graph` and `_greedy_clique` (`:42-91`),
which selects the inliers on the device.

In the exact form the consistency graph and the maximum clique are host
work, as in the reference (numpy, `registration.max_clique`). The solve on the clique runs
on the given device with `procrustes.weighted_kabsch`. The reference's GNC
loop stops once the cost changes by at most `cost_threshold` or after
`max_iters` steps; here it takes its `max_iters` steps on the device with a
`live` flag that freezes R, w, mu and the costs once the stop condition
holds, so no step reads the device and a frozen step changes nothing: the
result equals the stopped loop's. Scalars are f32 tensors, as the
reference's jitted solve takes them.

The greedy form peels the graph three times (degree below half the
largest), grows a clique from each of the 8 highest-degree nodes by adding
the candidate with most candidate neighbours, and keeps the largest. Ties go
as in the reference: stable sorts, the first maximum. Each growth takes at
most n steps; it stops once no seed has a candidate left, where every
further step would change nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.registration.max_clique import max_clique
from vfmreg_tpu_torch.registration.procrustes import weighted_kabsch
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision


class TeaserResult(NamedTuple):
    pose: torch.Tensor  # [4, 4] f32, on the solve's device
    inlier_mask: np.ndarray  # [N] bool, clique membership
    rotation_weights: torch.Tensor  # [M] final TLS weights over the TIMs


def _consistency_graph(src, tgt, mask, noise_bound, cbar2) -> torch.Tensor:
    """A[i, j] iff | |src_i - src_j| - |tgt_i - tgt_j| | <= 2 noise_bound
    sqrt(cbar2), both rows valid, i != j. [N, N] bool."""
    d_src = torch.linalg.vector_norm(src[:, None, :] - src[None, :, :], dim=-1)
    d_tgt = torch.linalg.vector_norm(tgt[:, None, :] - tgt[None, :, :], dim=-1)
    ok = torch.abs(d_src - d_tgt) <= 2.0 * noise_bound * torch.sqrt(cbar2)
    ok = ok & mask[:, None] & mask[None, :]
    return ok & ~torch.eye(src.shape[0], dtype=torch.bool, device=src.device)


def _degrees(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """[S, N] int64: row i's neighbours among each alive set [S, N], 0 where
    i is not alive (exact: 0 / 1 products summed in f32 below 2^24)."""
    deg = alive.to(torch.float32) @ adj.to(torch.float32).T
    return deg.to(torch.int64) * alive


def _greedy_clique(adj: torch.Tensor, n_restarts: int = 8) -> torch.Tensor:
    """k-core peel + greedy growth from the top-degree seeds. [N] bool."""
    n = adj.shape[0]
    alive = torch.ones((1, n), dtype=torch.bool, device=adj.device)
    for _ in range(3):
        deg = _degrees(adj, alive)
        thresh = torch.clamp(torch.amax(deg) // 2, min=1)
        alive = alive & (deg >= thresh)
    seeds = torch.argsort(-_degrees(adj, alive)[0], stable=True)[:n_restarts]
    s = seeds.shape[0]
    rows = torch.arange(s, device=adj.device)
    member = torch.zeros((s, n), dtype=torch.bool, device=adj.device)
    member[rows, seeds] = True
    cand = adj[seeds] & alive
    for _ in range(n):
        cand_deg = _degrees(adj, cand)
        nxt = torch.argmax(torch.where(cand, cand_deg + 1, 0), dim=1)
        has = cand[rows, nxt]
        member[rows, nxt] = member[rows, nxt] | has
        cand = torch.where(has[:, None], cand & adj[nxt], False)
    return member[torch.argmax(member.sum(dim=1))]


def _residual2(a: torch.Tensor, b: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(b - a @ R.T), dim=-1)


def _gnc_init(a, b, w_mask, eps2, cbar2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R0, mu0): the unweighted rotation and the initial mu from the largest
    residual (Yang et al. 2020, eq. 14 style)."""
    R0 = weighted_kabsch(a, b, w_mask.to(torch.float32))[:3, :3]
    r2_max = torch.amax(torch.where(w_mask, _residual2(a, b, R0), 0.0))
    mu0 = 1.0 / (2.0 * r2_max / (cbar2 * eps2) - 1.0)
    mu0 = torch.where((mu0 > 0) & torch.isfinite(mu0), mu0, torch.tensor(1e-3, device=mu0.device))
    return R0, mu0


def _gnc_step(a, b, w_mask, R, mu, eps2, cbar2):
    """One GNC-TLS step from (R, mu): (R_new, w_new, cost)."""
    r2 = _residual2(a, b, R)
    ub = (mu + 1.0) / mu * cbar2 * eps2
    lb = mu / (mu + 1.0) * cbar2 * eps2
    w_new = torch.where(
        r2 >= ub,
        0.0,
        torch.where(r2 <= lb, 1.0, torch.sqrt(cbar2 * eps2 * mu * (mu + 1.0) / r2) - mu),
    )
    w_new = torch.clamp(w_new, 0.0, 1.0) * w_mask
    R_new = weighted_kabsch(a, b, w_new)[:3, :3]
    cost = torch.sum(w_new * _residual2(a, b, R_new))
    return R_new, w_new, cost


def _gnc_tls_rotation(a, b, w_mask, noise_bound, cbar2, gnc_factor, max_iters: int, cost_threshold):
    """GNC-TLS rotation over TIM pairs a, b [M, 3]:
    min_R sum min(|b - R a|^2 / eps^2, cbar2). (R [3, 3], w [M])."""
    eps2 = torch.clamp(noise_bound * noise_bound, min=1e-12)
    R, mu = _gnc_init(a, b, w_mask, eps2, cbar2)
    w = w_mask.to(torch.float32)
    prev_cost = torch.tensor(float("inf"), device=a.device)
    cost = torch.tensor(0.0, device=a.device)
    for _ in range(max_iters):
        live = torch.abs(cost - prev_cost) > cost_threshold
        R_new, w_new, cost_new = _gnc_step(a, b, w_mask, R, mu, eps2, cbar2)
        R = torch.where(live, R_new, R)
        w = torch.where(live, w_new, w)
        mu = torch.where(live, mu * gnc_factor, mu)
        prev_cost = torch.where(live, cost, prev_cost)
        cost = torch.where(live, cost_new, cost)
    return R, w


def _scalar_tls(v, w_mask, beta, cbar2):
    """Exact scalar TLS by adaptive voting (TEASER's `solveForTranslation`):
    min_t sum_i min((v_i - t)^2 / beta^2, cbar2). The optimum's consensus set
    is delimited by the 2N boundaries v_i -+ beta sqrt(cbar2); the truncated
    cost is evaluated at the inlier mean of every boundary-interval midpoint
    and the argmin taken (the first on ties)."""
    half = beta * torch.sqrt(cbar2)
    big = 1e30
    vv = torch.where(w_mask, v, big)
    bounds = torch.sort(torch.cat([vv - half, vv + half])).values
    mids = 0.5 * (bounds[1:] + bounds[:-1])

    inl = w_mask[None, :] & (torch.abs(v[None, :] - mids[:, None]) <= half)
    cnt = torch.clamp(torch.sum(inl, dim=1), min=1)
    est = torch.sum(torch.where(inl, v[None, :], 0.0), dim=1) / cnt

    r2 = torch.square(v[None, :] - est[:, None]) / torch.square(beta)
    cost = torch.sum(torch.where(w_mask[None, :], torch.where(inl, r2, cbar2), 0.0), dim=1)
    valid = torch.isfinite(mids) & (torch.abs(mids) < big / 2)
    cost = torch.where(valid, cost, float("inf"))
    return est[torch.argmin(cost)]


def _tls_translation(residuals, w_mask, noise_bound, cbar2):
    """Component-wise scalar TLS of the translation."""
    return torch.stack([_scalar_tls(residuals[:, k], w_mask, noise_bound, cbar2) for k in range(3)])


def _solve_on_clique(src_s, tgt_s, clique, noise_bound, cbar2, gnc_factor, max_iters: int,
                     cost_threshold):
    """GNC-TLS rotation on the CHAIN TIMs of the compacted clique, then TLS
    translation: (pose [4, 4], rotation weights)."""
    corder = torch.sort((~clique).to(torch.int32), stable=True).indices
    csrc, ctgt, cmask = src_s[corder], tgt_s[corder], clique[corder]
    a = csrc[1:] - csrc[:-1]
    b = ctgt[1:] - ctgt[:-1]
    tim_mask = cmask[1:] & cmask[:-1]

    R, w = _gnc_tls_rotation(a, b, tim_mask, noise_bound, cbar2, gnc_factor, max_iters, cost_threshold)
    t = _tls_translation(ctgt - csrc @ R.T, cmask, noise_bound, cbar2)

    pose = torch.eye(4, dtype=torch.float32, device=src_s.device)
    pose[:3, :3] = R
    pose[:3, 3] = t
    return pose, w


def teaser_registration(
    src: torch.Tensor,  # [N, 3]
    tgt: torch.Tensor,  # [N, 3]
    mask: torch.Tensor,  # [N]
    noise_bound=0.2,
    cbar2=1.0,
    gnc_factor=1.4,
    max_iters: int = 100,
    cost_threshold=1e-16,
    max_graph_nodes: int = 512,
) -> TeaserResult:
    """TEASER with the greedy clique, on the tensors' device: the valid
    rows, front-compacted in order, cut to `max_graph_nodes`; the
    consistency graph, `_greedy_clique` and the solve on it."""
    full_precision()
    dev = src.device
    src = src.to(torch.float32)
    tgt = tgt.to(torch.float32)
    mask = mask.to(torch.bool)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    order = torch.sort((~mask).to(torch.int32), stable=True).indices[:max_graph_nodes]
    src_s, tgt_s, mask_s = src[order], tgt[order], mask[order]
    adj = _consistency_graph(src_s, tgt_s, mask_s, f32(noise_bound), f32(cbar2))
    clique = _greedy_clique(adj) & mask_s
    pose, w = _solve_on_clique(src_s, tgt_s, clique, f32(noise_bound), f32(cbar2), f32(gnc_factor), max_iters,
                               f32(cost_threshold))
    inlier_full = np.zeros(mask.shape[0], dtype=bool)
    inlier_full[order.cpu().numpy()] = clique.cpu().numpy()
    return TeaserResult(pose=pose, inlier_mask=inlier_full, rotation_weights=w)


def teaser_registration_exact(
    src,
    tgt,
    mask,
    noise_bound=0.2,
    cbar2=1.0,
    gnc_factor=1.4,
    max_iters: int = 100,
    cost_threshold=1e-16,
    max_graph_nodes: int = 512,
    device=None,
) -> TeaserResult:
    """TEASER with the reference's exact max-clique inlier selection.

    src, tgt [N, 3] and mask [N] (numpy or host tensors): the valid rows,
    front-compacted in order, are cut to `max_graph_nodes`; the consistency
    graph |d_src - d_tgt| <= 2 noise_bound sqrt(cbar2) and its maximum
    clique are computed on the host, and the solve runs on `device`
    (default: the card)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.float32)
    tgt = np.asarray(tgt, dtype=np.float32)
    mask = np.asarray(mask, dtype=bool)
    order = np.argsort(~mask, kind="stable")
    sel = order[:max_graph_nodes]
    src_s, tgt_s, mask_s = src[sel], tgt[sel], mask[sel]

    d_src = np.linalg.norm(src_s[:, None, :] - src_s[None, :, :], axis=-1)
    d_tgt = np.linalg.norm(tgt_s[:, None, :] - tgt_s[None, :, :], axis=-1)
    adj = np.abs(d_src - d_tgt) <= 2.0 * noise_bound * np.sqrt(cbar2)
    adj &= mask_s[:, None] & mask_s[None, :]
    np.fill_diagonal(adj, False)

    clique = max_clique(adj) & mask_s

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    pose, w = _solve_on_clique(
        torch.from_numpy(src_s).to(dev), torch.from_numpy(tgt_s).to(dev), torch.from_numpy(clique).to(dev),
        f32(noise_bound), f32(cbar2), f32(gnc_factor), max_iters, f32(cost_threshold),
    )
    inlier_full = np.zeros_like(mask)
    inlier_full[sel] = clique
    return TeaserResult(pose=pose, inlier_mask=inlier_full, rotation_weights=w)
