"""The legged envs beside ANYmal: the Cassie biped, the Atlas humanoid,
the Ant and Spotmicro.

Counterpart of ``jiminy_tpu/envs/legged.py`` (the reference's
``CassieJiminyEnv``, ``AtlasJiminyEnv``, ``AntJiminyEnv`` and
``SpotmicroJiminyEnv``), each a thin :class:`WalkerEnv` configuration
with the reference's defaults.

``CassieEnv``: the closed-loop biped of :mod:`jiminy_tpu_torch.models.biped`,
its two pushrod distance constraints rows of every substep's solve and its
shin springs in the actuation torque; with ``self_collision=True`` the
legs' capsule pairs
(:func:`~jiminy_tpu_torch.models.biped.cassie_self_collision_pairs`, or
``collision_pairs`` given) are contact rows of the solve too; with
``flexibility=True`` a SPHERICAL flexibility joint sits above each hip
roll (stiffness 600, damping 5) and an IMU on each hip (the observation
still reads the pelvis IMU, the suite's first). The reference's defaults:
1 ms substeps, PD kp 150, kd 6, action scale 0.4, terminated below 0.6
m, observing through the pelvis IMU and the 10 motor encoders
(``observe="sensors"``, sampled every ``sim_dt``). ``examples/train.py
--env cassie`` trains it with ``sim_dt=2e-3, target_speed=0.4``,
``--env cassie_flex`` with ``flexibility=True`` too.

``AtlasEnv``: the humanoid of :mod:`jiminy_tpu_torch.models.humanoid`
(23 motors, nv 29, four sole-corner contact points per foot: nc 47),
20 ms env steps of 5 substeps of 4 ms, PD kp 300, kd 15, action scale
0.4, terminated below 0.55 m, target speed 0.5 m/s, observing through
the pelvis IMU and the 23 encoders (``observe="sensors"``, sampled every
``sim_dt``); with ``self_collision=True`` the thigh, shank and
lower-arm-against-torso pairs
(:func:`~jiminy_tpu_torch.models.humanoid.atlas_self_collision_pairs`:
12 pair contacts, nc 83) are contact rows of the solve too, still one K2
launch per env step on the card. ``examples/train.py --env atlas`` trains
it with ``target_speed=0.3``. Observation (B, 55); action (B, 23).

``AntEnv``: the splayed 8-DoF quadruped of :mod:`jiminy_tpu_torch.models.ant`,
50 ms env steps of 20 substeps of 2.5 ms, PD kp 15, kd 0.8, action scale
0.5, terminated below 0.12 m, target speed 1 m/s; its sensors (the torso
IMU and 8 encoders) sample every 5 ms, so on ``observe="sensors"`` each
update follows every second substep (k_obs = 2). Observation (B, 25);
action (B, 8).

``SpotmicroEnv``: the small quadruped (:data:`~jiminy_tpu_torch.models.quadruped.SPOTMICRO`),
20 ms env steps of 20 substeps of 1 ms, PD kp 4, kd 0.1, action scale
0.4, terminated below 0.08 m, target speed 0.3 m/s, sensors sampled
every ``sim_dt`` (``sensor_period``, ``sensor_delay``, ``imu_noise``,
``encoder_noise`` as on ANYmal). Observation (B, 33); action (B, 12).

``max_tilt_cos``, ``nan_guard``, ``ground``, ``ground_sampler``,
``spawn_radius``, ``engine_options`` and the push and randomization
options pass through to :class:`WalkerEnv`; other options raise, naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.envs.locomotion import WalkerEnv, check_options
from jiminy_tpu_torch.models.ant import make_ant
from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs, make_cassie
from jiminy_tpu_torch.models.humanoid import atlas_self_collision_pairs, atlas_stand_q, make_atlas
from jiminy_tpu_torch.models.quadruped import SPOTMICRO, make_spotmicro, stand_q

_PASSED_ON = ("push_prob", "push_duration", "model_randomization", "collision_pairs",
              "max_tilt_cos", "nan_guard", "ground", "ground_sampler", "spawn_radius",
              "engine_options")


class CassieEnv(WalkerEnv):
    """Velocity-tracking biped locomotion with pushrod closed loops and
    passive shin springs. Observation (B, 29); action (B, 10) in [-1, 1]."""

    def __init__(
        self,
        step_dt: float = 0.02,
        sim_dt: float = 1e-3,
        max_steps: int = 1000,
        kp: float = 150.0,
        kd: float = 6.0,
        action_scale: float = 0.4,
        target_speed: float = 0.8,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        min_height: float = 0.6,
        push_magnitude: float = 0.0,
        observe: str = "sensors",
        sensor_period: float | None = None,
        sensor_delay: float = 0.0,
        imu_noise: float = 0.0,
        encoder_noise: float = 0.0,
        self_collision: bool = False,
        flexibility: bool = False,
        constraint_solver: str = "auto",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        check_options("CassieEnv", kwargs, _PASSED_ON)
        if self_collision:
            kwargs.setdefault("collision_pairs", cassie_self_collision_pairs())
        dev = resolve_device(device)
        tree, motors, sensors, constraints, stand = make_cassie(
            sensor_period=sim_dt if sensor_period is None else sensor_period,
            sensor_delay=sensor_delay, imu_noise=imu_noise, encoder_noise=encoder_noise,
            flexibility=flexibility, device=dev, dtype=dtype,
        )
        super().__init__(
            tree,
            motors,
            stand_pose=stand,
            step_dt=step_dt,
            sim_dt=sim_dt,
            max_steps=max_steps,
            kp=kp,
            kd=kd,
            action_scale=action_scale,
            target_speed=target_speed,
            pgs_iters=pgs_iters,
            reset_noise=reset_noise,
            min_height=min_height,
            constraint_solver=constraint_solver,
            observe=observe,
            sensors=sensors,
            push_magnitude=push_magnitude,
            constraints=constraints,
            device=dev,
            **kwargs,
        )


class AtlasEnv(WalkerEnv):
    """Velocity-tracking humanoid locomotion (23 actuated DoF).
    Observation (B, 55); action (B, 23) in [-1, 1]."""

    def __init__(
        self,
        step_dt: float = 0.02,
        sim_dt: float = 4e-3,
        max_steps: int = 1000,
        kp: float = 300.0,
        kd: float = 15.0,
        action_scale: float = 0.4,
        target_speed: float = 0.5,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        min_height: float = 0.55,
        push_magnitude: float = 0.0,
        observe: str = "sensors",
        sensor_period: float | None = None,
        sensor_delay: float = 0.0,
        imu_noise: float = 0.0,
        encoder_noise: float = 0.0,
        self_collision: bool = False,
        constraint_solver: str = "auto",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        check_options("AtlasEnv", kwargs, _PASSED_ON)
        if self_collision:
            kwargs.setdefault("collision_pairs", atlas_self_collision_pairs())
        dev = resolve_device(device)
        tree, motors, sensors = make_atlas(
            device=dev, dtype=dtype,
            sensor_period=sim_dt if sensor_period is None else sensor_period,
            sensor_delay=sensor_delay, imu_noise=imu_noise, encoder_noise=encoder_noise,
        )
        super().__init__(
            tree, motors, stand_pose=atlas_stand_q(tree), step_dt=step_dt, sim_dt=sim_dt,
            max_steps=max_steps, kp=kp, kd=kd, action_scale=action_scale,
            target_speed=target_speed, pgs_iters=pgs_iters, reset_noise=reset_noise,
            min_height=min_height, constraint_solver=constraint_solver, observe=observe,
            sensors=sensors, push_magnitude=push_magnitude, device=dev, **kwargs,
        )


_QUADRUPED_PASSED_ON = _PASSED_ON + ("constraints",)


class AntEnv(WalkerEnv):
    """Velocity-tracking locomotion of the Ant (8 actuated DoF).
    Observation (B, 25); action (B, 8) in [-1, 1]."""

    def __init__(
        self,
        step_dt: float = 0.05,
        sim_dt: float = 2.5e-3,
        max_steps: int = 1000,
        kp: float = 15.0,
        kd: float = 0.8,
        action_scale: float = 0.5,
        target_speed: float = 1.0,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        min_height: float = 0.12,
        push_magnitude: float = 0.0,
        observe: str = "sensors",
        constraint_solver: str = "auto",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        check_options("AntEnv", kwargs, _QUADRUPED_PASSED_ON)
        dev = resolve_device(device)
        tree, motors, sensors, stand = make_ant(device=dev, dtype=dtype)
        super().__init__(
            tree, motors, stand_pose=stand, step_dt=step_dt, sim_dt=sim_dt,
            max_steps=max_steps, kp=kp, kd=kd, action_scale=action_scale,
            target_speed=target_speed, pgs_iters=pgs_iters, reset_noise=reset_noise,
            min_height=min_height, constraint_solver=constraint_solver, observe=observe,
            sensors=sensors, push_magnitude=push_magnitude, device=dev, **kwargs,
        )


class SpotmicroEnv(WalkerEnv):
    """Velocity-tracking locomotion of the Spotmicro (12 actuated DoF).
    Observation (B, 33); action (B, 12) in [-1, 1]."""

    def __init__(
        self,
        step_dt: float = 0.02,
        sim_dt: float = 1e-3,
        max_steps: int = 1000,
        kp: float = 4.0,
        kd: float = 0.1,
        action_scale: float = 0.4,
        target_speed: float = 0.3,
        pgs_iters: int = 8,
        reset_noise: float = 0.1,
        min_height: float = 0.08,
        push_magnitude: float = 0.0,
        observe: str = "sensors",
        sensor_period: float | None = None,
        sensor_delay: float = 0.0,
        imu_noise: float = 0.0,
        encoder_noise: float = 0.0,
        constraint_solver: str = "auto",
        device="cuda",
        dtype=torch.float32,
        **kwargs,
    ):
        check_options("SpotmicroEnv", kwargs, _QUADRUPED_PASSED_ON)
        dev = resolve_device(device)
        tree, motors, sensors = make_spotmicro(
            device=dev, dtype=dtype,
            sensor_period=sim_dt if sensor_period is None else sensor_period,
            sensor_delay=sensor_delay, imu_noise=imu_noise, encoder_noise=encoder_noise,
        )
        super().__init__(
            tree, motors, stand_pose=stand_q(tree, SPOTMICRO), step_dt=step_dt, sim_dt=sim_dt,
            max_steps=max_steps, kp=kp, kd=kd, action_scale=action_scale,
            target_speed=target_speed, pgs_iters=pgs_iters, reset_noise=reset_noise,
            min_height=min_height, constraint_solver=constraint_solver, observe=observe,
            sensors=sensors, push_magnitude=push_magnitude, device=dev, **kwargs,
        )
