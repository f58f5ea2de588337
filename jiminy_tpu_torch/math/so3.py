"""SO(3) / quaternion operations on batched tensors.

Counterpart of ``jiminy_tpu/math/so3.py``, the functions that the
rigid-body algorithms, ``integrate`` and the state observation use.
Quaternions are scalar-last ``(x, y, z, w)`` as in the reference
(Pinocchio's layout). Every function works on any leading batch shape:
quaternions are ``(..., 4)``, vectors ``(..., 3)`` and matrices
``(..., 3, 3)``.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, with broadcasting."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit quaternion (guarded against zero norm)."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / n


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → unit quaternion, Taylor-guarded at 0."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + 1e-24)
    half = 0.5 * theta
    small = theta_sq < 1e-14
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    cos_half = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w * sinc_half[..., None], cos_half[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, w_local: torch.Tensor, dt) -> torch.Tensor:
    """q ⊗ exp(w_local·dt): local (right) increment, Pinocchio convention."""
    return quat_normalize(quat_mul(q, quat_exp(w_local * dt)))


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix (..., 3, 3) of v (..., 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )
