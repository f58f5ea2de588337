"""ANYmal quadruped locomotion env — the flagship environment.

Counterpart of ``jiminy_tpu/envs/anymal.py`` with ``terrain=None``,
``push_magnitude=0`` and ``observe="state"``: 12 actuated joints, a PD
inner loop at the physics rate, the policy setting PD targets at 50 Hz.
Other options raise ``NotImplementedError`` naming the ROADMAP item that
ports them. Unlike the reference, ``observe`` defaults to ``"state"``,
the only path ported so far.
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.envs.locomotion import WalkerEnv
from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

_LATER = {
    "sensor_delay": "A.9 (sensors)",
    "imu_noise": "A.9 (sensors)",
    "encoder_noise": "A.9 (sensors)",
    "terrain_seed": "A.10 (terrain)",
    "terrain_amplitude": "A.10 (terrain)",
    "terrain_wavelength": "A.10 (terrain)",
    "model_randomization": "A.11 (model randomization)",
    "constraints": "A.12 (closed loops)",
    "collision_pairs": "A.13 (body-body collision)",
    "reward_fn": "A.17 (declarative layer)",
    "termination_fn": "A.17 (declarative layer)",
    "engine_options": "A.16 (paths off the impulse engine)",
}


class ANYmalEnv(WalkerEnv):
    """Velocity-tracking quadruped locomotion (12 actuated DoF).
    Observation (B, 33); action (B, 12) in [-1, 1]."""

    def __init__(
        self,
        step_dt: float = 0.02,
        sim_dt: float = 5e-3,
        max_steps: int = 1000,
        kp: float = 80.0,
        kd: float = 2.0,
        action_scale: float = 0.5,
        target_speed: float = 0.8,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        terrain: str | None = None,
        push_magnitude: float = 0.0,
        observe: str = "state",
        constraint_solver: str = "auto",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        for k in kwargs:
            if k not in _LATER:
                raise TypeError(f"ANYmalEnv: unexpected argument {k!r}")
            raise NotImplementedError(
                f"ANYmalEnv({k}=...) is not ported yet (ROADMAP {_LATER[k]})"
            )
        if observe == "sensors":
            raise NotImplementedError(
                "observe='sensors' is not ported yet (ROADMAP A.9)"
            )
        if observe != "state":
            raise ValueError(f"unknown observe mode {observe!r}")
        if terrain not in (None, "flat"):
            raise NotImplementedError(
                f"terrain={terrain!r} is not ported yet (ROADMAP A.10)"
            )
        if push_magnitude:
            raise NotImplementedError("pushes are not ported yet (ROADMAP A.10)")
        dev = resolve_device(device)
        tree, motors = make_anymal(device=dev, dtype=dtype)
        super().__init__(
            tree,
            motors,
            stand_pose=stand_q(tree),
            step_dt=step_dt,
            sim_dt=sim_dt,
            max_steps=max_steps,
            kp=kp,
            kd=kd,
            action_scale=action_scale,
            target_speed=target_speed,
            pgs_iters=pgs_iters,
            reset_noise=reset_noise,
            constraint_solver=constraint_solver,
            device=dev,
        )
