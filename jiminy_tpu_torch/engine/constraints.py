"""Constraint rows: Baumgarte gain, contact tangent basis, the
joint-position-bound rows and the kinematic constraints.

Counterpart of ``jiminy_tpu/engine/constraints.py`` and of the
bounds-row assembly in ``jiminy_tpu/engine/engine.py``
(``_impulse_substep``). The kinematic constraints, each a frozen
dataclass with the reference's field names and defaults and a
``rows(tree, q, xw, dt, ground=None)`` → J (B, size, nv), target (B,
size) at the velocity level:

- :class:`FrameConstraint`: weld a frame to a world pose (6 rows,
  [angular; linear]);
- :class:`JointConstraint`: lock a REVOLUTE or PRISMATIC joint (1 row);
- :class:`DistanceConstraint`: keep two frames at a distance (1 row;
  closed loops such as Cassie's pushrods);
- :class:`SphereConstraint` and :class:`WheelConstraint`: a sphere or a
  wheel rolling without slip on the ground (3 rows each).

:func:`assemble` stacks them in declaration order, one equality block
each, ahead of the bounds and contact rows, the sphere and wheel rows
against the substep's ground. Only distance constraints ride the
whole-substep kernels (as in the reference); the others run the plain
substep around the chain kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.engine.solver import BlockSpec
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.so3 import cross


def baumgarte_alpha(freq: float, dt: float) -> np.float32:
    """Fraction of the position error corrected per step,
    α = min(2π·f·dt, 1), rounded as the reference's float32 math."""
    f32 = np.float32
    return np.clip(f32(2.0 * math.pi) * f32(freq) * f32(dt), f32(0), f32(1))


def tangent_basis(n: torch.Tensor):
    """Two unit tangents (..., 3) orthogonal to the unit normal n."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    t1 = cross(ref, n)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = cross(n, t1)
    return t1, t2


def bound_rows(
    tree: KinematicTree, joints: list[int], q: torch.Tensor, dt: float,
    alpha: float,
):
    """Joint-position-bound rows for the bounded 1-DoF ``joints``: one
    row per joint, signed toward the nearer limit; a violated limit gets
    a Baumgarte push-back target, a joint inside its range may approach
    the limit but not cross it this step. Returns J (B, k, nv) and the
    target (B, k)."""
    qo = [tree.q_off[i] for i in joints]
    vo = [tree.v_off[i] for i in joints]
    lo, hi = tree.q_min[qo], tree.q_max[qo]
    qj = q[:, qo]
    d_lo = qj - lo  # distance to the lower bound (push +)
    d_hi = hi - qj  # distance to the upper bound (push −)
    one = torch.ones_like(qj)
    s = torch.where(d_lo < d_hi, one, -one)
    dist = torch.minimum(d_lo, d_hi)  # < 0 when violating
    B, k = qj.shape
    J = q.new_zeros(B, k, tree.nv)
    J[:, torch.arange(k), vo] = s
    target = torch.where(dist < 0, -alpha * dist, -dist) / dt
    return J, target


@functools.lru_cache(maxsize=256)
def _const(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A constraint's constant (nested tuples of floats) as a tensor, made
    once per device and dtype."""
    return torch.tensor(values, dtype=dtype, device=device)


def _floats(x, shape):
    """``x`` (array-like) as nested tuples of floats of ``shape``."""
    a = np.asarray(x, dtype=np.float64).reshape(shape)
    return tuple(_floats(r, shape[1:]) for r in a) if len(shape) > 1 else tuple(a.tolist())


def _ground_at(ground, xy: torch.Tensor):
    """(height (B,), unit normal (B, 3)) of ``ground`` under xy (B, 2):
    flat at 0 with normal +z for None, as the reference's rows take it."""
    if ground is not None:
        return ground.query(xy)
    n = xy.new_zeros(xy.shape[0], 3)
    n[:, 2] = 1.0
    return xy.new_zeros(xy.shape[0]), n


class _Baumgarte:
    """α/dt of a constraint's Baumgarte target."""

    def alpha_over_dt(self, dt: float) -> float:
        """α/dt of the Baumgarte target, α = min(2π·f·dt, 1), both
        rounded to float32 as the reference's traced arithmetic rounds
        them."""
        return float(baumgarte_alpha(self.baumgarte_freq, dt) / np.float32(dt))


@dataclasses.dataclass(frozen=True)
class FrameConstraint(_Baumgarte):
    """Weld an operational frame to a world pose (6 rows: [angular;
    linear]): the reference's ``FrameConstraint``. ``ref_rot`` (3, 3) and
    ``ref_pos`` (3,) are the target orientation and position, None the
    identity and the origin."""

    frame: int
    ref_rot: tuple | None = None
    ref_pos: tuple | None = None
    baumgarte_freq: float = 20.0

    size = 6
    kind = "equality"

    def __post_init__(self):
        for name, shape in (("ref_rot", (3, 3)), ("ref_pos", (3,))):
            x = getattr(self, name)
            if x is not None:
                object.__setattr__(self, name, _floats(x, shape))

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float, ground=None):
        """J (B, 6, nv) the frame's world Jacobian, and the target (B, 6)
        −(α/dt)·[log(R·R_refᵀ); p − p_ref]."""
        b = tree.frame_body[self.frame]
        pose = xw[b].compose(tree.frame_placement(self.frame))
        J = algos.frame_jacobian6(tree, xw, b, pose.pos)
        err_rot = pose.rot if self.ref_rot is None else (
            pose.rot @ _const(self.ref_rot, q.device, q.dtype).T)
        err_pos = pose.pos if self.ref_pos is None else (
            pose.pos - _const(self.ref_pos, q.device, q.dtype))
        err = torch.cat([so3.log_matrix(err_rot), err_pos], dim=-1)
        return J, -self.alpha_over_dt(dt) * err


@dataclasses.dataclass(frozen=True)
class JointConstraint(_Baumgarte):
    """Lock a REVOLUTE or PRISMATIC joint at ``ref_q`` (1 row): the
    reference's ``JointConstraint``; the engine refuses any other joint
    type when it is built."""

    joint: int
    ref_q: float = 0.0
    baumgarte_freq: float = 20.0

    size = 1
    kind = "equality"

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float, ground=None):
        """J (B, 1, nv) the joint's unit column, and the target (B, 1)
        −(α/dt)·(q_j − ref_q)."""
        J = q.new_zeros(q.shape[0], 1, tree.nv)
        J[:, 0, tree.v_off[self.joint]] = 1.0
        err = q[:, tree.q_off[self.joint]] - self.ref_q
        return J, (-self.alpha_over_dt(dt) * err)[:, None]


@dataclasses.dataclass(frozen=True)
class DistanceConstraint(_Baumgarte):
    """Keep the distance between two operational frames at ``distance``
    (one equality row): the reference's ``DistanceConstraint``. A frame on
    body −1 is a fixed point of the world."""

    frame1: int
    frame2: int
    distance: float = 1.0
    baumgarte_freq: float = 20.0

    size = 1
    kind = "equality"

    def points(self, tree: KinematicTree, xw, like: torch.Tensor):
        """World positions (B, 3) of the two frames; a frame on body −1 is
        its placement itself (``xw[-1]`` would be the last body)."""
        B = like.shape[0]

        def fpos(f):
            b, p = tree.frame_body[f], tree.fp_pos[f].to(like.dtype)
            return p.expand(B, 3) if b < 0 else xw[b].apply(p)

        return fpos(self.frame1), fpos(self.frame2)

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float, ground=None):
        """J (B, 1, nv) = u·(J_p(b₁, p₁) − J_p(b₂, p₂)), u the unit vector
        from p₂ to p₁ (a body −1 contributes a zero Jacobian), and the
        target (B, 1) −(α/dt)·(|p₁ − p₂| − distance)."""
        p1, p2 = self.points(tree, xw, q)
        d_vec = p1 - p2
        d = torch.linalg.vector_norm(d_vec, dim=-1)
        u = d_vec / torch.clamp_min(d, 1e-9)[:, None]
        b1, b2 = tree.frame_body[self.frame1], tree.frame_body[self.frame2]
        J12 = algos.point_jacobian(tree, xw, b1, p1) - algos.point_jacobian(tree, xw, b2, p2)
        J = (u[:, None, :] @ J12)
        target = -self.alpha_over_dt(dt) * (d - self.distance)
        return J, target[:, None]


def _rolling_rows(c, tree, xw, b, n, h, pc, dt):
    """The rolling rows of a sphere or wheel touching at ``pc``: J (B, 3,
    nv) the contact point's velocity, and the target (B, 3) (α/dt)·depth·n
    with depth = h − pc_z (> 0 when penetrating)."""
    J = algos.point_jacobian(tree, xw, b, pc)
    depth = h - pc[:, 2]
    return J, (c.alpha_over_dt(dt) * depth)[:, None] * n


@dataclasses.dataclass(frozen=True)
class SphereConstraint(_Baumgarte):
    """A sphere of ``radius`` centred at a frame, rolling without slip on
    the ground (3 rows: the contact point's velocity zero, Baumgarte on
    the penetration): the reference's ``SphereConstraint``."""

    frame: int
    radius: float = 0.1
    baumgarte_freq: float = 20.0

    size = 3
    kind = "equality"

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float, ground=None):
        """The contact point centre − r·n, n the ground's normal under the
        centre (flat ground at 0 for ``ground`` None)."""
        b = tree.frame_body[self.frame]
        center = xw[b].apply(tree.fp_pos[self.frame])
        h, n = _ground_at(ground, center[:, :2])
        return _rolling_rows(self, tree, xw, b, n, h, center - self.radius * n, dt)


@dataclasses.dataclass(frozen=True)
class WheelConstraint(_Baumgarte):
    """A wheel of ``radius`` about ``axis`` (in the frame), rolling without
    slip (3 rows): the reference's ``WheelConstraint``. It touches at the
    point of its circle lowest along the ground's normal."""

    frame: int
    radius: float = 0.1
    axis: tuple = (0.0, 1.0, 0.0)
    baumgarte_freq: float = 20.0

    size = 3
    kind = "equality"

    def __post_init__(self):
        object.__setattr__(self, "axis", _floats(self.axis, (3,)))

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float, ground=None):
        """The contact point centre + r·d, d the unit direction of the
        wheel's plane most along −n (n the ground's normal under the
        centre)."""
        b = tree.frame_body[self.frame]
        pose = xw[b].compose(tree.frame_placement(self.frame))
        center = pose.pos
        a_w = (pose.rot @ _const(self.axis, q.device, q.dtype)[:, None])[..., 0]
        h, n = _ground_at(ground, center[:, :2])
        d = -(n - torch.sum(n * a_w, dim=-1, keepdim=True) * a_w)
        d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-9)
        return _rolling_rows(self, tree, xw, b, n, h, center + self.radius * d, dt)


KINDS = {
    "frame": FrameConstraint,
    "joint": JointConstraint,
    "distance": DistanceConstraint,
    "sphere": SphereConstraint,
    "wheel": WheelConstraint,
}
CONSTRAINTS = tuple(KINDS.values())


def constraint_from_arrays(kind: str, fields: dict):
    """The port's constraint of ``kind`` (a key of :data:`KINDS`) from the
    reference's fields as numpy arrays or scalars; a field left out (or
    None) takes its default."""
    cls = KINDS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        x = fields.get(f.name)
        if x is None:
            continue
        a = np.asarray(x)
        kw[f.name] = int(a) if f.type == "int" else float(a) if a.ndim == 0 else a
    return cls(**kw)


def distance_constraint_from_arrays(d: dict) -> DistanceConstraint:
    """The port's DistanceConstraint from the reference's fields
    (``frame1``, ``frame2``, ``distance``, ``baumgarte_freq``) as numpy
    scalars."""
    return constraint_from_arrays("distance", d)


def assemble(tree: KinematicTree, constraints, q: torch.Tensor, xw, dt: float, ground=None):
    """Stack the kinematic constraints' rows in declaration order →
    J (B, n, nv), target (B, n) and their blocks [BlockSpec("equality",
    start, size)], the sphere and wheel rows against ``ground`` (one
    ground, or one per env; None: flat at 0). The engine puts the bounds
    and contact rows after them."""
    Js, targets, blocks, off = [], [], [], 0
    for c in constraints:
        J, t = c.rows(tree, q, xw, dt, ground)
        Js.append(J)
        targets.append(t)
        blocks.append(BlockSpec(c.kind, off, c.size))
        off += c.size
    if not Js:
        B = q.shape[0]
        return q.new_zeros(B, 0, tree.nv), q.new_zeros(B, 0), []
    return torch.cat(Js, dim=1), torch.cat(targets, dim=1), blocks
