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


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with a series branch below theta^2 = 1e-8."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = hat_so3(w)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * K2


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


def _left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = hat_so3(w)
    K2 = K @ K
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * K2


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


def exp_se3(dx: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. (..., 6) [upsilon, omega] -> (..., 4, 4)."""
    upsilon, omega = dx[..., :3], dx[..., 3:]
    R = exp_so3(omega)
    t = (_left_jacobian_so3(omega) @ upsilon[..., None])[..., 0]
    T = torch.zeros(dx.shape[:-1] + (4, 4), dtype=dx.dtype, device=dx.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


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
