"""Constraint-row helpers: Baumgarte gain, contact tangent basis and the
joint-position-bound rows.

Counterpart of the parts of ``jiminy_tpu/engine/constraints.py`` and of
the bounds-row assembly in ``jiminy_tpu/engine/engine.py``
(``_impulse_substep``) that the impulse substep of the slice uses.
Kinematic constraints (weld, joint, distance, sphere, wheel) are not
ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import KinematicTree
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
