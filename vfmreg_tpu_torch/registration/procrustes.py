"""Rigid Procrustes (Kabsch) solvers: the rotation core under RANSAC.

Counterpart of `vfmreg_tpu/registration/procrustes.py` (`:15-168`).
`kabsch` / `weighted_kabsch` take the SVD route; `kabsch_horn` solves the
rotation as the leading eigenvector of Horn's 4x4 quaternion matrix with the
reference's fixed 6-sweep, branch-free cyclic Jacobi, operation for
operation, so a RANSAC run scores the same hypotheses the same way (a
library `eigh` or SVD rounds differently and moves near-tied winners). Every
function takes arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch


def kabsch(src: torch.Tensor, tgt: torch.Tensor, mask=None) -> torch.Tensor:
    """Least-squares rigid transform T with T @ src ~= tgt. src/tgt: [..., N, 3]."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    return weighted_kabsch(src, tgt, mask)


def _assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def weighted_kabsch(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Procrustes, w: [..., N] nonnegative -> [..., 4, 4]; a
    reflection is corrected by the det-sign trick."""
    w = w.to(src.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    wn = w / wsum
    c_src = torch.sum(wn[..., None] * src, dim=-2)
    c_tgt = torch.sum(wn[..., None] * tgt, dim=-2)
    src_c = src - c_src[..., None, :]
    tgt_c = tgt - c_tgt[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", src_c, wn, tgt_c)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)  # V diag(1, 1, det) U^T
    t = c_tgt - torch.einsum("...ij,...j->...i", R, c_src)
    return _assemble(R, t)


_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_eigh4(N: torch.Tensor, sweeps: int = 6):
    """Cyclic Jacobi on [..., 4, 4] symmetric matrices, in component form:
    (eigenvalues [..., 4], eigenvectors [..., 4, 4] as columns). Each
    rotation G(p, q, theta) annihilates A[p][q] and touches only rows and
    columns p and q."""
    A = [[N[..., i, j] for j in range(4)] for i in range(4)]
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    V = [[one if i == j else zero for j in range(4)] for i in range(4)]
    for _ in range(sweeps):
        for p, q in _JACOBI_PAIRS:
            app, aqq, apq = A[p][p], A[q][q], A[p][q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(theta)
            s = torch.sin(theta)
            cc, ss, cs = c * c, s * s, c * s
            for r in range(4):
                if r == p or r == q:
                    continue
                arp, arq = A[r][p], A[r][q]
                new_rp = c * arp - s * arq
                new_rq = s * arp + c * arq
                A[r][p] = A[p][r] = new_rp
                A[r][q] = A[q][r] = new_rq
            A[p][p] = cc * app + ss * aqq - 2.0 * cs * apq
            A[q][q] = ss * app + cc * aqq + 2.0 * cs * apq
            A[p][q] = A[q][p] = zero
            for r in range(4):
                vrp, vrq = V[r][p], V[r][q]
                V[r][p] = c * vrp - s * vrq
                V[r][q] = s * vrp + c * vrq
    vals = torch.stack([A[i][i] for i in range(4)], dim=-1)
    vecs = torch.stack([torch.stack(row, dim=-1) for row in V], dim=-2)
    return vals, vecs


def _quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = torch.clamp(w * w + x * x + y * y + z * z, min=1e-20)
    w, x, y, z = w / torch.sqrt(n), x / torch.sqrt(n), y / torch.sqrt(n), z / torch.sqrt(n)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def rotation_horn(H: torch.Tensor) -> torch.Tensor:
    """Optimal proper rotation from the cross-covariance
    H[..., i, j] = sum_n src_i tgt_j (Horn 1987)."""
    s00, s01, s02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    s10, s11, s12 = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    s20, s21, s22 = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([s00 + s11 + s22, s12 - s21, s20 - s02, s01 - s10], -1),
            torch.stack([s12 - s21, s00 - s11 - s22, s01 + s10, s20 + s02], -1),
            torch.stack([s20 - s02, s01 + s10, -s00 + s11 - s22, s12 + s21], -1),
            torch.stack([s01 - s10, s20 + s02, s12 + s21, -s00 - s11 + s22], -1),
        ],
        -2,
    )
    vals, vecs = _jacobi_eigh4(N)
    best = torch.argmax(vals, dim=-1)  # first maximum on ties
    q = torch.gather(vecs, -1, best[..., None, None].expand(vecs.shape[:-1] + (1,)))[..., 0]
    return _quat_to_matrix(q)


def matvec3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [..., 3, 3] times v [..., 3], elementwise: ((M_i0 v_0 + M_i1 v_1) +
    M_i2 v_2). A product or a reduction over a small axis can round
    otherwise as the leading axes grow; elementwise operations cannot, so a
    hypothesis scores the same in a batch of any size."""
    return (M[..., 0] * v[..., None, 0] + M[..., 1] * v[..., None, 1]) + M[..., 2] * v[..., None, 2]


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i b_i over the last axis of 3, elementwise (see `matvec3`)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def kabsch_horn(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """`kabsch` with the Horn / Jacobi rotation core, unweighted (the RANSAC
    minimal sample). src/tgt: [..., N, 3] -> [..., 4, 4]. Every sum is
    written out over the N points in ascending order (see `matvec3`)."""
    n = src.shape[-2]
    s_sum, t_sum = src[..., 0, :], tgt[..., 0, :]
    for i in range(1, n):
        s_sum, t_sum = s_sum + src[..., i, :], t_sum + tgt[..., i, :]
    c_src, c_tgt = s_sum / n, t_sum / n
    src_c = src - c_src[..., None, :]
    tgt_c = tgt - c_tgt[..., None, :]
    H = src_c[..., 0, :, None] * tgt_c[..., 0, None, :]
    for i in range(1, n):
        H = H + src_c[..., i, :, None] * tgt_c[..., i, None, :]
    R = rotation_horn(H)
    t = c_tgt - matvec3(R, c_src)
    return _assemble(R, t)
