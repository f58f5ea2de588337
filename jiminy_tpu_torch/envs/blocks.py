"""Observer and controller blocks of the env pipeline.

Counterpart of ``jiminy_tpu/envs/blocks.py`` (the reference's block
library: ``MahonyFilter``, an IMU attitude observer; ``PDControllerBlock``,
PD with target integration and effort limits; ``MotorSafetyLimit``;
``DeformationEstimator``, a flexibility's deflection from two IMUs).

A block is a pair of functions over a batch of B envs:

    init(generator, batch_size, ...) → state
    apply(state, **inputs) → (state', output)

A block's state is a plain dict of (B, ...) tensors (empty for a
stateless block), so that a checkpoint carries it and an auto-reset
picks it env by env; :mod:`jiminy_tpu_torch.envs.pipeline` composes
blocks into env layers. No block draws from ``generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_tpu_torch.math import so3


class MahonyFilter:
    """Mahony complementary attitude filter on (gyro, accel): ``kp`` and
    ``ki`` are the proportional and integral gains, ``dt`` the update
    period (its pipeline layer's step). State: ``quat`` (B, 4) xyzw, the
    attitude estimate, and ``bias`` (B, 3), the gyro bias estimate."""

    def __init__(self, dt: float, kp: float = 1.0, ki: float = 0.1):
        self.dt, self.kp, self.ki = dt, kp, ki

    def init(self, generator=None, batch_size: int = 1, device=None,
             dtype=torch.float32) -> dict:
        return {"quat": so3.quat_identity((batch_size,), dtype=dtype, device=device),
                "bias": torch.zeros(batch_size, 3, dtype=dtype, device=device)}

    def apply(self, state: dict, gyro: torch.Tensor, accel: torch.Tensor):
        """One update from (B, 3) gyro and accelerometer readings →
        (state', the attitude estimate (B, 4))."""
        # an accelerometer at rest reads −g: +z in a level body frame
        a_norm = accel / torch.clamp(torch.linalg.norm(accel, dim=-1, keepdim=True), min=1e-6)
        # the estimated up direction in the body frame, Rᵀ·e_z: R's last row
        v_hat = so3.quat_to_matrix(state["quat"])[:, 2, :]
        e = so3.cross(a_norm, v_hat)
        bias = state["bias"] - self.ki * e * self.dt
        w = gyro - bias + self.kp * e
        quat = so3.quat_integrate(state["quat"], w, self.dt)
        return {"quat": quat, "bias": bias}, quat


class PDControllerBlock:
    """PD controller: the action is an absolute target position, or with
    ``integrate_velocity`` a target velocity that the block integrates;
    the target clipped to ``target_limits`` ((lo, hi), each (nm,)) when
    given, the torque to the motors' effort limits. State: ``target``
    (B, nm)."""

    def __init__(self, motors, kp: float, kd: float, dt: float,
                 integrate_velocity: bool = False, target_limits=None):
        self.motors = motors
        self.kp, self.kd, self.dt = kp, kd, dt
        self.integrate_velocity = integrate_velocity
        self.target_limits = target_limits

    def init(self, generator=None, batch_size: int = 1, q0=None, device=None,
             dtype=torch.float32) -> dict:
        """The target at 0, or at the motors' positions in ``q0`` (B, nq)."""
        if q0 is None:
            return {"target": torch.zeros(batch_size, self.motors.nm, dtype=dtype, device=device)}
        return {"target": q0[:, list(self.motors.q_idx)].clone()}

    def apply(self, state: dict, action, qm, vm):
        """(state, action, motor positions, motor velocities), each
        (B, nm) → (state', motor torques (B, nm))."""
        target = state["target"] + action * self.dt if self.integrate_velocity else action
        if self.target_limits is not None:
            lo, hi = (torch.as_tensor(x, dtype=target.dtype, device=target.device)
                      for x in self.target_limits)
            target = torch.clamp(target, lo, hi)
        u = self.kp * (target - qm) - self.kd * vm
        lim = self.motors.effort_limit.to(u)
        return {"target": target}, torch.clamp(u, -lim, lim)


class MotorSafetyLimit:
    """Stateless command shaper: a torque pushing a joint toward a position
    limit fades to zero across ``soft_margin`` of it, and a damper of gain
    ``kd`` engages there. ``q_min``, ``q_max``: the model's (nq,)
    limits."""

    def __init__(self, motors, q_min, q_max, soft_margin: float = 0.1, kd: float = 2.0):
        qi = list(motors.q_idx)
        self.motors = motors
        self.q_min = np.asarray(torch.as_tensor(q_min).cpu())[qi]
        self.q_max = np.asarray(torch.as_tensor(q_max).cpu())[qi]
        self.soft_margin = soft_margin
        self.kd = kd

    def init(self, generator=None, batch_size: int = 1, **_) -> dict:
        return {}

    def apply(self, state: dict, u, qm, vm):
        m = self.soft_margin
        q_min = torch.as_tensor(self.q_min, dtype=u.dtype, device=u.device)
        q_max = torch.as_tensor(self.q_max, dtype=u.dtype, device=u.device)
        # fade 0 → 1 across the margin from each limit
        up_room = torch.clamp((q_max - qm) / m, 0.0, 1.0)
        dn_room = torch.clamp((qm - q_min) / m, 0.0, 1.0)
        u = torch.where(u > 0, u * up_room, u * dn_room)
        # damping inside the margin
        engage = torch.maximum(1.0 - up_room, 1.0 - dn_room)
        return state, u + engage * (-self.kd * vm)


class DeformationEstimator:
    """A flexibility's deflection from the IMU quaternions of the bodies
    on either side of it: log(q_parent⁻¹ ⊗ q_child ⊗ q_joint⁻¹), relative
    to ``nominal_rel_quat`` when given."""

    def __init__(self, nominal_rel_quat=None):
        self.nominal = nominal_rel_quat

    def init(self, generator=None, batch_size: int = 1, **_) -> dict:
        return {}

    def apply(self, state: dict, quat_parent, quat_child, quat_joint=None):
        """``quat_joint`` (B, 4): the known articulated rotation between the
        two IMU bodies (from the encoders) where actuated joints sit
        between them, e.g. Cassie's hip: R_rel = R_flex·R_hip(θ), so
        R_flex = R_rel·R_hipᵀ. → (state, the rotation vector (B, 3))."""
        rel = so3.quat_mul(so3.quat_conj(quat_parent), quat_child)
        if quat_joint is not None:
            rel = so3.quat_mul(rel, so3.quat_conj(quat_joint))
        if self.nominal is not None:
            nominal = torch.as_tensor(self.nominal, dtype=rel.dtype, device=rel.device)
            rel = so3.quat_mul(so3.quat_conj(nominal).expand_as(rel), rel)
        return state, so3.quat_log(rel)
