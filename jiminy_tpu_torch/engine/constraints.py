"""Constraint rows: Baumgarte gain, contact tangent basis, the
joint-position-bound rows and the kinematic distance constraint.

Counterpart of the parts of ``jiminy_tpu/engine/constraints.py`` and of
the bounds-row assembly in ``jiminy_tpu/engine/engine.py``
(``_impulse_substep``) that the impulse substep uses:
:class:`DistanceConstraint` (closed loops such as Cassie's pushrods) and
:func:`assemble`, which stacks the kinematic rows in declaration order
ahead of the bounds and contact rows. The other kinematic constraints
(frame, joint, sphere, wheel) are not ported yet (ROADMAP A.22); the
engine refuses them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.engine.solver import BlockSpec
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


@dataclasses.dataclass(frozen=True)
class DistanceConstraint:
    """Keep the distance between two operational frames at ``distance``
    (one equality row): the reference's ``DistanceConstraint``. A frame on
    body −1 is a fixed point of the world."""

    frame1: int
    frame2: int
    distance: float = 1.0
    baumgarte_freq: float = 20.0

    size = 1
    kind = "equality"

    def alpha_over_dt(self, dt: float) -> float:
        """α/dt of the Baumgarte target, α = min(2π·f·dt, 1), both
        rounded to float32 as the reference's traced arithmetic rounds
        them."""
        return float(baumgarte_alpha(self.baumgarte_freq, dt) / np.float32(dt))

    def points(self, tree: KinematicTree, xw, like: torch.Tensor):
        """World positions (B, 3) of the two frames; a frame on body −1 is
        its placement itself (``xw[-1]`` would be the last body)."""
        B = like.shape[0]

        def fpos(f):
            b, p = tree.frame_body[f], tree.fp_pos[f].to(like.dtype)
            return p.expand(B, 3) if b < 0 else xw[b].apply(p)

        return fpos(self.frame1), fpos(self.frame2)

    def rows(self, tree: KinematicTree, q: torch.Tensor, xw, dt: float):
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


def distance_constraint_from_arrays(d: dict) -> DistanceConstraint:
    """The port's DistanceConstraint from the reference's fields
    (``frame1``, ``frame2``, ``distance``, ``baumgarte_freq``) as numpy
    scalars."""
    return DistanceConstraint(
        frame1=int(np.asarray(d["frame1"])), frame2=int(np.asarray(d["frame2"])),
        distance=float(np.asarray(d["distance"])),
        baumgarte_freq=float(np.asarray(d["baumgarte_freq"])),
    )


def assemble(tree: KinematicTree, constraints, q: torch.Tensor, xw, dt: float):
    """Stack the kinematic constraints' rows in declaration order →
    J (B, n, nv), target (B, n) and their blocks [BlockSpec("equality",
    start, size)]. The engine puts the bounds and contact rows after
    them."""
    Js, targets, blocks, off = [], [], [], 0
    for c in constraints:
        J, t = c.rows(tree, q, xw, dt)
        Js.append(J)
        targets.append(t)
        blocks.append(BlockSpec(c.kind, off, c.size))
        off += c.size
    if not Js:
        B = q.shape[0]
        return q.new_zeros(B, 0, tree.nv), q.new_zeros(B, 0), []
    return torch.cat(Js, dim=1), torch.cat(targets, dim=1), blocks
