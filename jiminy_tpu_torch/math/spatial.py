"""6-D spatial algebra (Featherstone) on batched tensors.

Counterpart of ``jiminy_tpu/math/spatial.py``: the part of the algebra
that FK, RNEA, CRBA and ABA use. Motion vectors are
``(angular ω, linear v)`` and force vectors ``(couple n, force f)``,
shape ``(..., 6)``. A :class:`Transform` is the pose ``(rot, pos)`` of a
child frame C in a parent frame A (``x_A = rot @ x_C + pos``); its fields
may be unbatched constants (a joint placement) or batched per env, and
every operation broadcasts between the two.
"""

from __future__ import annotations

import dataclasses

import torch

from jiminy_tpu_torch.math.so3 import cross, hat, quat_to_matrix


def mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R @ x for (..., 3, 3) matrices and (..., 3) vectors."""
    return (R @ x[..., None])[..., 0]


def mtv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rᵀ @ x."""
    return mv(R.transpose(-1, -2), x)


@dataclasses.dataclass(frozen=True)
class Transform:
    rot: torch.Tensor  # (..., 3, 3)
    pos: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, device="cpu") -> "Transform":
        return Transform(rot=torch.eye(3, dtype=dtype, device=device),
                         pos=torch.zeros(3, dtype=dtype, device=device))

    @staticmethod
    def from_quat_pos(quat: torch.Tensor, pos: torch.Tensor) -> "Transform":
        """From a unit quaternion (x, y, z, w) and a position."""
        return Transform(rot=quat_to_matrix(quat), pos=pos)

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other: pose of C in A from B-in-A (self) and C-in-B."""
        return Transform(
            rot=self.rot @ other.rot, pos=mv(self.rot, other.pos) + self.pos
        )

    def inverse(self) -> "Transform":
        rot_t = self.rot.transpose(-1, -2)
        return Transform(rot=rot_t, pos=-mv(rot_t, self.pos))

    def apply(self, point: torch.Tensor) -> torch.Tensor:
        return mv(self.rot, point) + self.pos

    def apply_inv(self, point: torch.Tensor) -> torch.Tensor:
        """A point from A-coordinates to C-coordinates."""
        return mtv(self.rot, point - self.pos)

    def motion_child_to_parent(self, m: torch.Tensor) -> torch.Tensor:
        """A motion in C (at C's origin) → in A (at A's origin)."""
        w = mv(self.rot, m[..., :3])
        v = mv(self.rot, m[..., 3:]) + cross(self.pos, w)
        return torch.cat([w, v], dim=-1)

    def motion_parent_to_child(self, m: torch.Tensor) -> torch.Tensor:
        w = mtv(self.rot, m[..., :3])
        v = mtv(self.rot, m[..., 3:] - cross(self.pos, m[..., :3]))
        return torch.cat([w, v], dim=-1)

    def force_child_to_parent(self, f: torch.Tensor) -> torch.Tensor:
        lin = mv(self.rot, f[..., 3:])
        ang = mv(self.rot, f[..., :3]) + cross(self.pos, lin)
        return torch.cat([ang, lin], dim=-1)

    def force_parent_to_child(self, f: torch.Tensor) -> torch.Tensor:
        """A force in A (at A's origin) → in C (at C's origin)."""
        lin = mtv(self.rot, f[..., 3:])
        ang = mtv(self.rot, f[..., :3] - cross(self.pos, f[..., 3:]))
        return torch.cat([ang, lin], dim=-1)


def motion_cross(m: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product m ×ₘ other."""
    w, v = m[..., :3], m[..., 3:]
    ow, ov = other[..., :3], other[..., 3:]
    return torch.cat([cross(w, ow), cross(w, ov) + cross(v, ow)], dim=-1)


def motion_cross_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial motion-force cross product m ×* f."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)


@dataclasses.dataclass(frozen=True)
class SpatialInertia:
    """Spatial inertia about the body-frame origin as (mass, h = m·c, I)
    with I the rotational inertia about the origin (not the CoM)."""

    mass: torch.Tensor  # (...)
    h: torch.Tensor  # (..., 3)
    inertia: torch.Tensor  # (..., 3, 3)

    @staticmethod
    def from_params(mass, com, inertia_at_com) -> "SpatialInertia":
        """From the mass, the CoM and the rotational inertia about the CoM
        (the URDF's parameters), moved to the body origin by the parallel
        axis theorem."""
        mass, com, ic = (torch.as_tensor(x) for x in (mass, com, inertia_at_com))
        ch = hat(com)
        io = ic + mass[..., None, None] * (ch @ ch.transpose(-1, -2))
        return SpatialInertia(mass=mass, h=mass[..., None] * com, inertia=io)

    def mul_motion(self, m: torch.Tensor) -> torch.Tensor:
        """f = I·m."""
        w, v = m[..., :3], m[..., 3:]
        ang = mv(self.inertia, w) + cross(self.h, v)
        lin = self.mass[..., None] * v - cross(self.h, w)
        return torch.cat([ang, lin], dim=-1)

    def to_matrix(self) -> torch.Tensor:
        """Dense (..., 6, 6) spatial inertia [[I, ĥ], [ĥᵀ, m·1]]."""
        hx = hat(self.h)
        m_eye = self.mass[..., None, None] * torch.eye(3, dtype=self.h.dtype, device=self.h.device)
        top = torch.cat([self.inertia, hx], dim=-1)
        bot = torch.cat([hx.transpose(-1, -2), m_eye], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def add(self, other: "SpatialInertia") -> "SpatialInertia":
        return SpatialInertia(
            mass=self.mass + other.mass,
            h=self.h + other.h,
            inertia=self.inertia + other.inertia,
        )

    def transform_by(self, x: Transform) -> "SpatialInertia":
        """Express this inertia (given in C) in A, x being C's pose in A."""
        R, p = x.rot, x.pos
        m = self.mass
        rh = mv(R, self.h)
        h_a = rh + m[..., None] * p
        ph = hat(p)
        Rt = R.transpose(-1, -2)
        i_a = (
            (R @ self.inertia) @ Rt
            + ph @ hat(rh).transpose(-1, -2)
            + hat(h_a) @ ph.transpose(-1, -2)
        )
        return SpatialInertia(mass=m.expand(h_a.shape[:-1]), h=h_a, inertia=i_a)


def transform_matrix_motion(x: Transform) -> torch.Tensor:
    """The dense (..., 6, 6) Plücker motion transform of ``x`` (child →
    parent): [[R, 0], [p̂·R, R]]."""
    R = x.rot
    pR = hat(x.pos) @ R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    return torch.cat([top, torch.cat([pR, R], dim=-1)], dim=-2)
