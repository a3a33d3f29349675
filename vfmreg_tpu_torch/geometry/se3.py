"""SE(3) / SO(3) utilities on torch tensors.

Counterpart of `vfmreg_tpu/geometry/se3.py`. Tangent vectors follow Sophus:
``dx = [upsilon (translation), omega (rotation)]``. Every function takes
arbitrary leading batch dimensions and works in the input's dtype and device.
The small-angle and near-pi branches are the reference's, threshold for
threshold, so both packages pick the same branch for the same input.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat_so3(w: torch.Tensor) -> torch.Tensor:
    """Skew matrix with hat(w) @ v == cross(w, v). (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _so3_coeffs(theta2: torch.Tensor):
    """Rodrigues' coefficients sin(t)/t, (1 - cos t)/t^2 and (t - sin t)/t^3
    of theta2 = t^2, each with its series branch below theta2 = 1e-8."""
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with a series branch below theta^2 = 1e-8."""
    a, b, _ = _so3_coeffs(torch.sum(w * w, dim=-1))
    K = hat_so3(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of exp_so3. (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # 1 - 1e-8 rounds to 1.0 in f32; 1e-6 is the reference's representable bound.
    small = cos_theta > 1.0 - 1e-6
    near_pi_cos = cos_theta < -1.0 + 1e-6
    safe_cos = torch.where(small | near_pi_cos, torch.zeros_like(cos_theta), cos_theta)
    theta_acos = torch.arccos(safe_cos)
    theta_small = 0.5 * torch.sqrt(torch.sum(w_vee * w_vee, dim=-1) + 1e-20)
    theta_pi = math.pi - torch.sqrt(torch.clamp(2.0 * (1.0 + cos_theta), min=0.0))
    theta = torch.where(small, theta_small, torch.where(near_pi_cos, theta_pi, theta_acos))
    sin_theta = torch.where(
        small | near_pi_cos, torch.ones_like(theta_acos), torch.sin(theta_acos)
    )
    factor = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_theta))
    w = factor[..., None] * w_vee
    # Near pi the vee part degenerates: take the axis from the symmetric part
    # R + I, whose columns are proportional to axis outer products. The 1e-2
    # band covers the near_pi_cos zone above (see the reference for why).
    near_pi = theta > math.pi - 1e-2
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = torch.linalg.vector_norm(B, dim=-2)
    best = torch.argmax(col_norms, dim=-1)
    idx = best[..., None, None].expand(*B.shape[:-1], 1)
    axis = torch.gather(B, -1, idx)[..., 0]
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(torch.sum(axis * w_vee, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w)


def _left_jacobian_inv_so3(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = hat_so3(w)
    K2 = K @ K
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / theta2_safe,
    )
    return _eye_like(K) - 0.5 * K + cot_term[..., None, None] * K2


def _exp_se3(dx: torch.Tensor, theta2: torch.Tensor, mm) -> torch.Tensor:
    """exp(dx) = [[R, Jl @ upsilon], [0, 1]] with R and the left Jacobian Jl
    from `_so3_coeffs(theta2)`, theta2 = |omega|^2, and products by `mm`."""
    upsilon, omega = dx[..., :3], dx[..., 3:]
    a, b, c = _so3_coeffs(theta2)
    K = hat_so3(omega)
    K2 = mm(K, K)
    eye = _eye_like(K)
    R = eye + a[..., None, None] * K + b[..., None, None] * K2
    Jl = eye + b[..., None, None] * K + c[..., None, None] * K2
    T = torch.zeros(dx.shape[:-1] + (4, 4), dtype=dx.dtype, device=dx.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = mm(Jl, upsilon[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def exp_se3(dx: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. (..., 6) [upsilon, omega] -> (..., 4, 4)."""
    omega = dx[..., 3:]
    return _exp_se3(dx, torch.sum(omega * omega, dim=-1), torch.matmul)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm. (..., 4, 4) -> (..., 6) [upsilon, omega]."""
    omega = log_so3(T[..., :3, :3])
    upsilon = (_left_jacobian_inv_so3(omega) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([upsilon, omega], dim=-1)


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    T_inv = torch.zeros_like(T)
    T_inv[..., :3, :3] = Rt
    T_inv[..., :3, 3] = -(Rt @ T[..., :3, 3, None])[..., 0]
    T_inv[..., 3, 3] = 1.0
    return T_inv


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 transform to (..., N, 3) points.

    The matmul runs in true f32 (`utils.precision.full_precision`): TF32 would
    cost centimetres at 100 m coordinates."""
    T = T.to(device=points.device, dtype=points.dtype)
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


# Lane forms: [B, ...] with every sum written out entry by entry in
# ascending order. A batched BLAS product, or a reduction over a short axis,
# may round otherwise as the batch changes (on the card, and in the CPU's
# BLAS); these give each lane what its own B = 1 call gives.


def matmul_lanes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B over leading batch dimensions, (..., n, k) @ (..., k, m), each
    entry summed over k in ascending order."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k : k + 1] * B[..., k : k + 1, :]
    return acc


def _sq3_lanes(w: torch.Tensor) -> torch.Tensor:
    return (w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]) + w[..., 2] * w[..., 2]


def exp_se3_lanes(dx: torch.Tensor) -> torch.Tensor:
    """`exp_se3` of dx [B, 6] -> [B, 4, 4] with the sums of `matmul_lanes`."""
    return _exp_se3(dx, _sq3_lanes(dx[..., 3:]), matmul_lanes)


def conjugate_translation_lanes(T: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """T(center) @ T @ T(-center) for T [B, 4, 4] and each lane's center
    [B, 3], without building the translations."""
    out = T.clone()
    out[..., :3, 3] = T[..., :3, 3] + center - matmul_lanes(T[..., :3, :3], center[..., None])[..., 0]
    return out


def transform_points_lanes(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """`transform_points` of points [B, N, 3] by T [B, 4, 4], the product
    written out (exact f32, no TF32 whatever the matmul settings)."""
    T = T.to(device=points.device, dtype=points.dtype)
    return matmul_lanes(points, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]
