"""ANYmal quadruped locomotion env — the flagship environment.

Counterpart of ``jiminy_tpu/envs/anymal.py`` with ``terrain=None`` and
``push_magnitude=0``: 12 actuated joints, a PD inner loop at the physics
rate, the policy setting PD targets at 50 Hz. As in the reference,
``observe`` defaults to ``"sensors"``: the policy sees the IMU and the
encoders, sampled every ``sim_dt``, delayed by ``sensor_delay`` and
corrupted with Gaussian noise (``imu_noise``, ``encoder_noise``);
``observe="state"`` is the privileged path. Other options raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.envs.locomotion import WalkerEnv
from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

_LATER = {
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
        observe: str = "sensors",
        sensor_delay: float = 0.0,
        imu_noise: float = 0.0,
        encoder_noise: float = 0.0,
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
        if terrain not in (None, "flat"):
            raise NotImplementedError(
                f"terrain={terrain!r} is not ported yet (ROADMAP A.10)"
            )
        if push_magnitude:
            raise NotImplementedError("pushes are not ported yet (ROADMAP A.10)")
        dev = resolve_device(device)
        tree, motors, sensors = make_anymal(
            device=dev, dtype=dtype, sensor_period=sim_dt, sensor_delay=sensor_delay,
            imu_noise=imu_noise, encoder_noise=encoder_noise,
        )
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
            observe=observe,
            sensors=sensors,
            device=dev,
        )
