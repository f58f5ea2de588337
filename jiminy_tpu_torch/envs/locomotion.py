"""Velocity-tracking locomotion env on a floating-base legged robot.

Counterpart of ``jiminy_tpu/envs/locomotion.py`` (``WalkerEnv``) on flat
ground with no pushes: ``_sample_state``, ``_observe``,
``_observe_from_sensors``, ``_reward``, ``_terminated`` and
``_action_to_command``, batched.

Action: (B, nm) PD target offsets around the stand pose in [-1, 1].
Observation, ``observe="sensors"`` (the default, as in the reference):
from the delayed, corrupted readings of the sensor suite, gravity
direction from the IMU quaternion (3), gyro (3), 0.05 × accelerometer
(3), encoder positions relative to the stand pose (nm) and 0.1 × encoder
velocities (nm). ``observe="state"`` (privileged): gravity direction (3),
base angular velocity (3), base linear velocity (3) [base-local], motor
positions relative to the stand pose (nm) and 0.1 × motor velocities
(nm).
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.engine.engine import (
    Engine,
    EngineOptions,
    PDController,
    SimState,
)
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.envs.base import BaseEnv, EnvState
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import mv


class WalkerEnv(BaseEnv):
    def __init__(
        self,
        tree: KinematicTree,
        motors: Motors,
        stand_pose,  # (nq,) nominal configuration, feet on the ground
        step_dt: float = 0.02,
        sim_dt: float = 2.5e-3,
        max_steps: int = 1000,
        kp: float = 80.0,
        kd: float = 2.0,
        action_scale: float = 0.5,
        target_speed: float = 0.8,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        min_height: float = 0.3,
        max_tilt_cos: float = 0.6,
        constraint_solver: str = "auto",
        observe: str = "sensors",  # "sensors" | "state" (privileged)
        sensors=None,  # SensorSuite of the robot, needed by "sensors"
        device="cuda",
    ):
        if observe == "sensors":
            if sensors is None:
                raise ValueError(
                    "observe='sensors' requires the robot's sensor suite "
                    "(make_anymal returns it)"
                )
            enc = next(g for g in sensors.groups if g.type == "encoder")
            # static encoder → motor permutation (matched on q index)
            enc_q = [tree.q_off[j] for j in enc.target]
            self._enc_perm = [enc_q.index(qi) for qi in motors.q_idx]
        elif observe != "state":
            raise ValueError(f"unknown observe mode {observe!r}")
        self.observe_mode = observe
        engine = Engine(
            tree,
            EngineOptions(
                dt=sim_dt,
                pgs_iters=pgs_iters,
                # RL envs do not read the solver residual
                compute_solver_residual=False,
                constraint_solver=constraint_solver,
            ),
            ground=FlatGround(),
            motors=motors,
            controller=PDController(kp, kd),
            device=device,
        )
        suite = None
        if observe == "sensors":
            suite = sensors.to(device=engine.device, dtype=engine.tree.dtype)
        super().__init__(engine, step_dt=step_dt, max_steps=max_steps, sensors=suite)
        self.motors = engine.motors
        self.action_scale = action_scale
        self.target_speed = target_speed
        self.reset_noise = reset_noise
        self.min_height = min_height
        self.max_tilt_cos = max_tilt_cos
        self._q_stand = torch.as_tensor(
            stand_pose, dtype=self.tree.dtype, device=self.device
        )
        self._stand_targets, _ = self.motors.joint_state(
            self._q_stand, torch.zeros(self.tree.nv, dtype=self.tree.dtype, device=self.device)
        )

    def _sample_state(self, generator: torch.Generator, batch_size: int):
        """Stand pose + U(−1, 1)·reset_noise on the motor joints, and
        N(0, 1)·0.1·reset_noise velocities."""
        nm, nv = self.motors.nm, self.tree.nv
        kw = dict(generator=generator, device=generator.device)
        dq = self.reset_noise * (2.0 * torch.rand(batch_size, nm, **kw) - 1.0)
        v = 0.1 * self.reset_noise * torch.randn(batch_size, nv, **kw)
        q = self._q_stand.expand(batch_size, -1).clone()
        idx = list(self.motors.q_idx)
        q[:, idx] = q[:, idx] + dq.to(device=self.device, dtype=q.dtype)
        return q, v.to(device=self.device, dtype=q.dtype)

    def _base_frames(self, sim: SimState):
        R = so3.quat_to_matrix(sim.q[:, 3:7])
        down = torch.tensor([0.0, 0.0, -1.0], dtype=R.dtype, device=R.device)
        grav_b = mv(R.transpose(-1, -2), down)
        return R, grav_b, sim.v[:, 3:6], sim.v[:, 0:3]

    def _observe(self, sim: SimState) -> torch.Tensor:
        _, grav_b, w_b, v_b = self._base_frames(sim)
        qm, vm = self.motors.joint_state(sim.q, sim.v)
        return torch.cat(
            [grav_b, w_b, v_b, qm - self._stand_targets, 0.1 * vm], dim=-1
        )

    def _observe_from_sensors(self, readings: dict, sim: SimState) -> torch.Tensor:
        """Measurement observation, the layout of the privileged one with
        the scaled accelerometer in place of the base linear velocity."""
        imu = readings["imu"][:, 0]
        R = so3.quat_to_matrix(imu[:, :4])
        down = torch.tensor([0.0, 0.0, -1.0], dtype=R.dtype, device=R.device)
        grav_b = mv(R.transpose(-1, -2), down)
        enc = readings["encoder"][:, self._enc_perm]
        return torch.cat(
            [grav_b, imu[:, 4:7], 0.05 * imu[:, 7:10], enc[..., 0] - self._stand_targets,
             0.1 * enc[..., 1]],
            dim=-1,
        )

    def _action_to_command(self, action, sim):
        return self._stand_targets + self.action_scale * torch.clamp(action, -1.0, 1.0)

    def _reward(self, prev: EnvState, action, sim: SimState) -> torch.Tensor:
        R, grav_b, w_b, v_b = self._base_frames(sim)
        v_world = mv(R, v_b)
        track = torch.exp(-torch.square(v_world[:, 0] - self.target_speed) / 0.25)
        upright = -grav_b[:, 2]
        lateral = torch.square(v_world[:, 1]) + 0.5 * torch.square(w_b[:, 2])
        ctrl = torch.sum(torch.square(action), dim=-1)
        return (
            1.0 * track
            + 0.5 * upright
            - 0.1 * lateral
            - 0.005 * ctrl
            - 0.05 * torch.square(v_world[:, 2])
        )

    def _terminated(self, sim: SimState) -> torch.Tensor:
        _, grav_b, _, _ = self._base_frames(sim)
        fallen = grav_b[:, 2] > -self.max_tilt_cos
        h, _ = self.engine.ground.query(sim.q[:, :2])
        low = (sim.q[:, 2] - h) < self.min_height
        return fallen | low
