"""SO(3) / quaternion operations on batched tensors.

Counterpart of ``jiminy_tpu/math/so3.py``, the functions that the
rigid-body algorithms, ``integrate``, the springs of the flexibility
joints (``quat_log``), the frame constraint's orientation error
(``log_matrix``), the observations, the sensors and the declarative layer
(``quat_identity``, ``quat_conj``, ``quat_to_rpy``) and the URDF
builders (``rpy_to_quat``) use, and ``quat_rotate`` / ``quat_rotate_inv``.
Quaternions are scalar-last ``(x, y, z, w)`` as in the reference
(Pinocchio's layout). Every function works on any leading batch shape:
quaternions are ``(..., 4)``, vectors ``(..., 3)`` and matrices
``(..., 3, 3)``.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, with broadcasting: one kernel (the plain
    physics calls it ~250 times per ANYmal dynamics evaluation, and its
    launches bound the plain paths' rate on the card)."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity rotation ``(0, 0, 0, 1)`` of shape ``(*batch_shape, 4)``."""
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    return q.expand(*batch_shape, 4).clone()


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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` (..., 3) turned by the unit quaternion ``q`` (frame B → A when
    q is B's orientation in A), by the two-cross-product formula."""
    t = 2.0 * cross(q[..., :3], v)
    return v + q[..., 3:] * t + cross(q[..., :3], t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` turned by the inverse of ``q``."""
    u = -q[..., :3]
    t = 2.0 * cross(u, v)
    return v + q[..., 3:] * t + cross(u, t)


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


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) → rotation vector (..., 3): the shorter
    rotation (q and −q are one rotation, so w < 0 flips the sign), and
    the small-angle scale 2/w where |xyz|² < 1e-14."""
    sin_half_sq = torch.sum(q[..., :3] * q[..., :3], dim=-1)
    sin_half = torch.sqrt(sin_half_sq + 1e-24)
    w = torch.abs(q[..., 3])
    vec = torch.where((q[..., 3] < 0.0)[..., None], -q[..., :3], q[..., :3])
    angle = 2.0 * torch.atan2(sin_half, w)
    small = sin_half_sq < 1e-14
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / sin_half)
    return vec * scale[..., None]


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), xyzw.

    The four-candidate construction: the candidate of the largest of
    (m00, m11, m22, trace) is taken (the first of equal maxima), then
    normalized, and its sign set so that w ≥ 0 (w = 0 counts as
    positive)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack(
        [
            torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], -1),
            torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], -1),
            torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], -1),
            torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1),
        ],
        dim=-2,
    )  # (..., 4 candidates, xyzw)
    idx = torch.argmax(torch.stack([m00, m11, m22, tr], -1), dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    w = q[..., 3:4]
    return quat_normalize(q) * torch.sign(w + (w == 0).to(w.dtype))


def log_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → rotation vector (..., 3), as
    ``quat_log(matrix_to_quat(R))``."""
    return quat_log(matrix_to_quat(R))


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


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (..., 3), XYZ extrinsic (the URDF convention) →
    quaternion (..., 4)."""
    c, s = torch.cos(0.5 * rpy).unbind(-1), torch.sin(0.5 * rpy).unbind(-1)
    (cr, cp, cy), (sr, sp, sy) = c, s
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → roll-pitch-yaw (..., 3), XYZ extrinsic; the pitch's
    sine clamped to [−1, 1]."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
