"""Batched 3-vector and 3 x 3 helpers for the baseline descriptors.

`dot3`, `cross3` and `covariance3` write their sums out in a fixed order,
so a row's result does not depend on the batch around it or on the device
(a library reduction or batched product may sum in another order on the
card). `eigh3` is the eigen-decomposition of batched symmetric 3 x 3
matrices.

FPFH's normals and the DIP and GeDi local reference frames take the
eigenvectors of one 3 x 3 covariance per point, hundreds of thousands at a
time. `torch.linalg.eigh` hands such a batch to cuSOLVER on the card, which
refuses batches of this size (CUSOLVER_STATUS_INVALID_VALUE at 32,768
matrices on an H100, CUDA 12.8). This is a cyclic Jacobi solver in
component form instead, as `registration/procrustes._jacobi_eigh4` is for
4 x 4: a fixed number of sweeps of the three plane rotations, elementwise
tensor operations only (no trigonometry), so the card and the CPU give the
same bits. Jacobi converges quadratically: four sweeps already bring an f32
3 x 3 matrix to diagonal within rounding; SWEEPS keeps a margin.
"""

from __future__ import annotations

from typing import Tuple

import torch

SWEEPS = 6
_PAIRS = ((0, 1), (0, 2), (1, 2))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def covariance3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weighted covariance about the weighted mean of x [N, K, 3] with
    weights w [N, K] in {0, 1}, divided by max(sum w, 1): [N, 3, 3]. Every
    sum runs over K in order, elementwise, so the card and the CPU give the
    same bits (a normal's sign rule reads a component that is rounding
    noise on a vertical wall)."""
    cnt = torch.clamp(w.sum(dim=1), min=1.0)  # small integers: exact in any order
    s = x[:, 0] * w[:, 0, None]
    for j in range(1, x.shape[1]):
        s = s + x[:, j] * w[:, j, None]
    d = (x - (s / cnt[:, None])[:, None, :]) * w[..., None]
    pairs = {}
    for a in range(3):
        for b in range(a, 3):
            acc = d[:, 0, a] * d[:, 0, b]
            for j in range(1, x.shape[1]):
                acc = acc + d[:, j, a] * d[:, j, b]
            pairs[a, b] = pairs[b, a] = acc / cnt
    return torch.stack([torch.stack([pairs[a, b] for b in range(3)], dim=-1) for a in range(3)], dim=-2)


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def eigh3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3] as
    columns) of the symmetric matrices a [..., 3, 3]."""
    A = [[a[..., i, j] for j in range(3)] for i in range(3)]
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    V = [[one if i == j else zero for j in range(3)] for i in range(3)]
    for _ in range(SWEEPS):
        for p, q in _PAIRS:
            app, aqq, apq = A[p][p], A[q][q], A[p][q]
            # The rotation's tangent, the smaller root of t^2 + 2 tau t - 1
            # (Golub and Van Loan's symmetric Schur step): divisions and a
            # square root only, correctly rounded on the card and the CPU
            # alike, where sin, cos and atan2 differ by an ulp.
            tau = (aqq - app) / (2.0 * apq)
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(apq == 0, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            r = 3 - p - q  # the third index
            arp, arq = A[r][p], A[r][q]
            A[r][p] = A[p][r] = c * arp - s * arq
            A[r][q] = A[q][r] = s * arp + c * arq
            A[p][p] = app - t * apq
            A[q][q] = aqq + t * apq
            A[p][q] = A[q][p] = zero
            for k in range(3):
                vkp, vkq = V[k][p], V[k][q]
                V[k][p] = c * vkp - s * vkq
                V[k][q] = s * vkp + c * vkq
    w = torch.stack([A[0][0], A[1][1], A[2][2]], dim=-1)
    vecs = torch.stack([torch.stack(row, dim=-1) for row in V], dim=-2)
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    vecs = torch.gather(vecs, -1, order[..., None, :].expand(vecs.shape))
    return w, vecs
