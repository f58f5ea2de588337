"""Motor bank: command → joint effort, batched.

Counterpart of ``jiminy_tpu/hardware/motors.py`` (the reference's
SimpleMotor: reduction, effort and velocity limits, dry + viscous
friction). The motor → dof maps are static index lists; parameters are
(nm,) tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_PARAMS = (
    "reduction", "effort_limit", "velocity_limit", "friction_dry",
    "friction_viscous", "friction_vel_eps",
)


@dataclasses.dataclass(frozen=True)
class Motors:
    v_idx: tuple  # (nm,) velocity dof per motor
    q_idx: tuple  # (nm,) position index per motor (1-DoF joints)
    name: tuple
    reduction: torch.Tensor
    effort_limit: torch.Tensor  # motor-side torque limit
    velocity_limit: torch.Tensor  # joint-side velocity limit
    friction_dry: torch.Tensor
    friction_viscous: torch.Tensor
    friction_vel_eps: torch.Tensor  # dry-friction smoothing velocity

    @property
    def nm(self) -> int:
        return len(self.v_idx)

    @staticmethod
    def create(
        v_idx, q_idx=None, names=None, reduction=1.0, effort_limit=1e6,
        velocity_limit=1e6, friction_dry=0.0, friction_viscous=0.0,
        friction_vel_eps=1e-2, device="cuda", dtype=torch.float32,
    ) -> "Motors":
        from jiminy_tpu_torch import resolve_device

        dev = resolve_device(device)
        nm = len(v_idx)

        def arr(x):
            a = np.broadcast_to(np.asarray(x, np.float32), (nm,))
            return torch.as_tensor(a.copy(), dtype=dtype, device=dev)

        return Motors(
            v_idx=tuple(int(i) for i in v_idx),
            q_idx=tuple(int(i) for i in (q_idx if q_idx is not None else v_idx)),
            name=tuple(names) if names else tuple(f"motor_{i}" for i in v_idx),
            reduction=arr(reduction),
            effort_limit=arr(effort_limit),
            velocity_limit=arr(velocity_limit),
            friction_dry=arr(friction_dry),
            friction_viscous=arr(friction_viscous),
            friction_vel_eps=arr(friction_vel_eps),
        )

    def to(self, device=None, dtype=None) -> "Motors":
        return dataclasses.replace(
            self,
            **{k: getattr(self, k).to(device=device, dtype=dtype) for k in _PARAMS},
        )

    def compute_effort(self, command: torch.Tensor, v: torch.Tensor, mscale=None):
        """(B, nm) motor command + (B, nv) joint velocity → (B, nv) joint
        torque: clamp, reduction, velocity-limit derating, friction.
        ``mscale``: optional per-env (gain, friction scale), (B, nm) each,
        applied as the whole-substep kernels apply them (the reference's
        ``_compute_tau``): the reduction times the gain, the friction
        torque as a whole times the scale."""
        v_j = v[:, list(self.v_idx)]
        u = torch.clamp(command, -self.effort_limit, self.effort_limit)
        red = self.reduction if mscale is None else self.reduction * mscale[0]
        tau_m = red * u
        over = torch.clamp(
            (torch.abs(v_j) - self.velocity_limit)
            / (0.1 * torch.clamp_min(self.velocity_limit, 1e-6)),
            0.0,
            1.0,
        )
        same_dir = torch.sign(tau_m) == torch.sign(v_j)
        tau_m = torch.where(same_dir, tau_m * (1.0 - over), tau_m)
        fric = (
            self.friction_dry * torch.tanh(v_j / self.friction_vel_eps)
            + self.friction_viscous * v_j
        )
        if mscale is not None:
            fric = fric * mscale[1]
        out = torch.zeros_like(v)
        out[:, list(self.v_idx)] = tau_m - fric
        return out

    def joint_state(self, q: torch.Tensor, v: torch.Tensor):
        """Motor-ordered joint positions and velocities, (B, nm) each."""
        return q[..., list(self.q_idx)], v[..., list(self.v_idx)]


def motors_from_arrays(d: dict, device="cuda", dtype=torch.float32) -> Motors:
    """The port's motor bank from the reference ``Motors`` fields as
    numpy arrays (``v_idx``, ``q_idx``, ``name`` and the (nm,) params)."""
    return Motors.create(
        v_idx=np.asarray(d["v_idx"]).tolist(),
        q_idx=np.asarray(d["q_idx"]).tolist(),
        names=[str(x) for x in np.asarray(d["name"])],
        **{k: np.asarray(d[k]) for k in _PARAMS},
        device=device,
        dtype=dtype,
    )
