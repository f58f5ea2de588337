"""Registered external forces: impulses, profiles and viscoelastic
couplings, batched.

Counterpart of ``jiminy_tpu/engine/forces.py`` (the reference's
``registerImpulseForce``, ``registerProfileForce`` and force couplings).
Each force acts at an operational frame; :func:`compute_forces` sums them
into every body's local wrench (B, nb, 6) at the state of a substep. The
clock is each env's own (B,) time: an impulse's window is a mask on it,
so envs at different times see the force at their own times. Couplings
tie two frames of one tree, which may belong to two robots of a forest
(:func:`~jiminy_tpu_torch.core.tree.merge_trees`).

``Engine(..., forces=)`` takes them. They keep an impulse model off the
whole-substep kernels, as in the reference: its substep then runs the
plain physics around the chain kernel K1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import mtv, mv


def _as(x, like: torch.Tensor):
    """A float as it is; a tuple or a tensor as a tensor on ``like``'s
    device and dtype (a tensor already there is used as it is)."""
    if isinstance(x, float):
        return x
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _split(f: torch.Tensor):
    """A world force (…, 3) as (no torque, force), or a wrench (…, 6) as
    (torque, force)."""
    if f.shape[-1] == 3:
        return torch.zeros_like(f), f
    return f[..., :3], f[..., 3:]


@dataclasses.dataclass(frozen=True)
class ImpulseForce:
    """A world force (3,) or wrench (6,) [torque; force] at ``frame``
    while t_start ≤ t < t_start + duration (the reference's
    ``registerImpulseForce``). ``force`` may also be each env's (B, 3 |
    6); a tensor on the engine's device and dtype is read as it is, else
    copied there at every substep."""

    frame: int
    t_start: float
    duration: float
    force: object

    def wrench_world(self, t: torch.Tensor, pos):
        active = (t >= self.t_start) & (t < self.t_start + self.duration)
        f = active.to(t.dtype)[:, None] * _as(self.force, t)
        return _split(f)


@dataclasses.dataclass(frozen=True)
class ProfileForce:
    """A world force or wrench at ``frame`` from a callback of time (the
    reference's ``registerProfileForce``). ``fn`` receives each env's time
    (B,) and returns (B, 3) or (B, 6) [torque; force], or a (3,) or (6,)
    tensor that broadcasts over the batch."""

    frame: int
    fn: Callable

    def wrench_world(self, t: torch.Tensor, pos):
        f = _as(self.fn(t), t)
        return _split(f.expand(t.shape[0], f.shape[-1]))


@dataclasses.dataclass(frozen=True)
class CouplingForce:
    """A viscoelastic 6-D spring-damper between two frames (the
    reference's viscoelastic force coupling): f = k_lin·(p2 − p1) +
    c_lin·(v2 − v1) pulls frame 1 toward frame 2 (and frame 2 back), and
    τ = k_ang·log(R1ᵀR2) + c_ang·(ω2 − ω1), in frame 1's axes, turns
    them together. Gains are floats or (3,) per axis; :meth:`create`
    rounds them to float32 as the reference's does."""

    frame1: int
    frame2: int
    k_lin: object = 0.0
    c_lin: object = 0.0
    k_ang: object = 0.0
    c_ang: object = 0.0

    @staticmethod
    def create(frame1, frame2, k_lin=0.0, c_lin=0.0, k_ang=0.0, c_ang=0.0) -> "CouplingForce":
        def f32(x):
            a = np.asarray(x, np.float32)
            return float(a) if a.ndim == 0 else tuple(float(y) for y in a)

        return CouplingForce(frame1, frame2, f32(k_lin), f32(c_lin), f32(k_ang), f32(c_ang))


FORCES = (ImpulseForce, ProfileForce, CouplingForce)


def _frame_state(tree: KinematicTree, xw, vel, f: int):
    """(body, world pose, world linear velocity, world angular velocity)
    of frame ``f``."""
    b = tree.frame_body[f]
    pose = xw[b].compose(tree.frame_placement(f))
    w_l, v_l = vel[b][:, :3], vel[b][:, 3:]
    v_w = mv(xw[b].rot, v_l + so3.cross(w_l, tree.fp_pos[f]))
    return b, pose, v_w, mv(xw[b].rot, w_l)


def _wrench(xw, body: int, p_w, torque_w, force_w) -> torch.Tensor:
    """A world wrench at the point ``p_w`` as ``body``'s local wrench
    (B, 6) at its origin."""
    n_w = torque_w + so3.cross(p_w - xw[body].pos, force_w)
    return torch.cat([mtv(xw[body].rot, n_w), mtv(xw[body].rot, force_w)], dim=-1)


def compute_forces(tree: KinematicTree, forces, t: torch.Tensor, xw, vel) -> torch.Tensor:
    """Every registered force at each env's time ``t`` (B,) and state
    (world poses ``xw`` and local velocities ``vel`` of the bodies) →
    local wrenches (B, nb, 6)."""
    per_body = {}

    def add(b, w):
        per_body[b] = w if b not in per_body else per_body[b] + w

    for frc in forces:
        if isinstance(frc, CouplingForce):
            b1, pose1, v1, w1 = _frame_state(tree, xw, vel, frc.frame1)
            b2, pose2, v2, w2 = _frame_state(tree, xw, vel, frc.frame2)
            f = _as(frc.k_lin, t) * (pose2.pos - pose1.pos) + _as(frc.c_lin, t) * (v2 - v1)
            tau = _as(frc.k_ang, t) * so3.log_matrix(
                pose1.rot.transpose(-1, -2) @ pose2.rot) + _as(frc.c_ang, t) * (w2 - w1)
            tau_w = mv(pose1.rot, tau)
            add(b1, _wrench(xw, b1, pose1.pos, tau_w, f))
            add(b2, _wrench(xw, b2, pose2.pos, -tau_w, -f))
        else:  # an impulse or a profile force
            b = tree.frame_body[frc.frame]
            pose = xw[b].compose(tree.frame_placement(frc.frame))
            torque_w, force_w = frc.wrench_world(t, pose.pos)
            add(b, _wrench(xw, b, pose.pos, torque_w, force_w))
    zero = t.new_zeros(t.shape[0], 6)
    return torch.stack([per_body.get(b, zero) for b in range(tree.nb)], dim=1)
