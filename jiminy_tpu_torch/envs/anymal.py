"""ANYmal quadruped locomotion env — the flagship environment.

Counterpart of ``jiminy_tpu/envs/anymal.py``: 12 actuated joints, a PD
inner loop at the physics rate, the policy setting PD targets at 50 Hz.
As in the reference, ``observe`` defaults to ``"sensors"``: the policy
sees the IMU and the encoders, sampled every ``sim_dt``, delayed by
``sensor_delay`` and corrupted with Gaussian noise (``imu_noise``,
``encoder_noise``); ``observe="state"`` is the privileged path.

``terrain``: None or ``"flat"``; ``"fourier"`` (a random Fourier ground
per env, 16 terms, drawn again at every reset) and ``"perlin"`` (a
random analytic Perlin ground per env, 3 octaves), both of
``terrain_amplitude`` and ``terrain_wavelength``; ``"stairs"`` (the
analytic staircase 0.4 m × 0.08 m, 10 steps, 5 cm ramps); these four run
in the whole-substep kernels. ``"perlin_grid"`` is one shared bilinear
heightmap from ``terrain_seed`` with a flat spawn disk and spawns within
4 m, on the plain physics around the chain kernel. ``push_magnitude``
(N) turns pushes on; ``push_prob``, ``push_duration``,
``model_randomization`` (per-episode masses, centres of mass, inertias,
armature, motor gains and friction, sensor offsets), ``constraints``
(kinematic constraints: frame, joint, distance, sphere and wheel),
``collision_pairs`` (declared body-body pairs), ``min_height``,
``max_tilt_cos`` (the termination's limits), ``nan_guard``,
``engine_options`` (the engine's options as a whole, e.g. the
reference's default penalty contacts), ``reward_fn`` and
``termination_fn`` (a declarative MDP, e.g.
:func:`anymal_declarative_mdp`'s) pass through to :class:`WalkerEnv`.
Other options raise ``TypeError``.

:class:`ANYmalGantryEnv` is ANYmal on a gantry: the base welded (a
:class:`~jiminy_tpu_torch.engine.constraints.FrameConstraint`) 0.25 m
above its stand pose, where it spawns, the legs free, and the left front
knee held at its stand angle (a
:class:`~jiminy_tpu_torch.engine.constraints.JointConstraint`: a
failed-actuator test). Its ``"auto"`` resolves to the chain kernel.

``mirror_spec`` and ``symmetry_fn`` are the reference's left-right mirror
(the reflection across the robot's xz-plane), which PPO's symmetry loss
reads (``PPOConfig.symmetry_coef``).
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.engine.constraints import FrameConstraint, JointConstraint
from jiminy_tpu_torch.engine.ground import (
    StairsGround,
    sample_fourier_ground,
    sample_perlin_ground,
)
from jiminy_tpu_torch.engine.terrain import perlin_ground
from jiminy_tpu_torch.envs.locomotion import WalkerEnv, check_options
from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

_PASSED_ON = ("push_prob", "push_duration", "model_randomization", "constraints",
              "collision_pairs", "min_height", "max_tilt_cos", "nan_guard", "engine_options",
              "reward_fn", "termination_fn")


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
        terrain_seed: int = 0,
        terrain_amplitude: float = 0.08,
        terrain_wavelength: float = 1.5,
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
        check_options("ANYmalEnv", kwargs, _PASSED_ON)
        dev = resolve_device(device)
        ground, sampler, spawn_radius = None, None, 0.0
        if terrain == "fourier":
            def sampler(generator, batch_shape):
                return sample_fourier_ground(
                    generator, n_terms=16, amplitude=terrain_amplitude,
                    wavelength=terrain_wavelength, octaves=3, batch_shape=batch_shape, dtype=dtype,
                )
        elif terrain == "perlin":
            def sampler(generator, batch_shape):
                return sample_perlin_ground(
                    generator, amplitude=terrain_amplitude, wavelength=terrain_wavelength,
                    octaves=3, batch_shape=batch_shape, dtype=dtype,
                )
        elif terrain == "perlin_grid":
            ground = perlin_ground(seed=terrain_seed, size=8.0, resolution=0.1, amplitude=0.08,
                                   wavelength=1.5, flat_radius=1.0, device=dev)
            spawn_radius = 4.0
        elif terrain == "stairs":
            ground = StairsGround.create(step_width=0.4, step_height=0.08, n_steps=10,
                                         ramp=0.05, device=dev)
        elif terrain not in (None, "flat"):
            raise ValueError(f"unknown terrain {terrain!r}")
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
            ground=ground,
            ground_sampler=sampler,
            spawn_radius=spawn_radius,
            push_magnitude=push_magnitude,
            device=dev,
            **kwargs,
        )
        self._mirror = None  # ((device, dtype), mirror_spec as tensors), made on first use

    # ---- left-right mirror symmetry: reflection across the robot's
    # xz-plane; linear (x, y, z) → (x, −y, z), angular (ωx, ωy, ωz) →
    # (−ωx, ωy, −ωz); the legs swap L↔R with the abduction (HAA) sign flipped
    def mirror_spec(self):
        """(obs_perm, obs_sign, act_perm, act_sign) as numpy arrays."""
        names = list(self.motors.name)
        act_perm = np.zeros(12, np.int32)
        act_sign = np.ones(12, np.float32)
        swap = {"LF": "RF", "RF": "LF", "LH": "RH", "RH": "LH"}
        for i, n in enumerate(names):
            leg, joint = n.split("_")
            act_perm[i] = names.index(f"{swap[leg]}_{joint}")
            if joint == "HAA":
                act_sign[i] = -1.0
        obs_perm = np.arange(33, dtype=np.int32)
        obs_sign = np.ones(33, np.float32)
        obs_sign[0:3] = [1, -1, 1]  # gravity direction
        obs_sign[3:6] = [-1, 1, -1]  # base angular velocity
        obs_sign[6:9] = [1, -1, 1]  # base linear velocity
        obs_perm[9:21] = 9 + act_perm
        obs_sign[9:21] = act_sign
        obs_perm[21:33] = 21 + act_perm
        obs_sign[21:33] = act_sign
        return obs_perm, obs_sign, act_perm, act_sign

    def symmetry_fn(self, obs, action):
        """(obs, action) → the mirrored pair (``action`` may be None), for
        ``PPOConfig.symmetry_coef``."""
        key = (obs.device, obs.dtype)
        if self._mirror is None or self._mirror[0] != key:
            obs_perm, obs_sign, act_perm, act_sign = self.mirror_spec()
            as_index = dict(dtype=torch.long, device=obs.device)
            as_sign = dict(dtype=obs.dtype, device=obs.device)
            self._mirror = (key, torch.as_tensor(obs_perm, **as_index),
                            torch.as_tensor(obs_sign, **as_sign),
                            torch.as_tensor(act_perm, **as_index),
                            torch.as_tensor(act_sign, **as_sign))
        _, obs_perm, obs_sign, act_perm, act_sign = self._mirror
        obs_m = obs[..., obs_perm] * obs_sign
        act_m = None if action is None else action[..., act_perm] * act_sign
        return obs_m, act_m


class ANYmalGantryEnv(ANYmalEnv):
    """ANYmal with its base welded ``LIFT`` m above the stand pose (where
    each episode spawns) and the ``LOCKED`` joint held at its stand angle
    (a failed-actuator test); the other options as :class:`ANYmalEnv`'s.
    Rows: the weld's 6 and the lock's 1 ahead of the 12 bounds and 12
    contacts (nc 31)."""

    LIFT = 0.25
    LOCKED = "LF_KFE"

    def __init__(self, **kwargs):
        if "constraints" in kwargs:
            raise TypeError("ANYmalGantryEnv makes its own constraints")
        tree = make_anymal(device="cpu", dtype=torch.float64)[0]
        q = torch.as_tensor(stand_q(tree), dtype=torch.float64)[None].clone()
        q[0, 2] += self.LIFT
        frame = tree.frame_index("base_frame")
        pose = algos.forward_kinematics(tree, q)[tree.frame_body[frame]].compose(
            tree.frame_placement(frame))
        weld = FrameConstraint(frame, ref_rot=pose.rot[0].numpy(), ref_pos=pose.pos[0].numpy())
        j = tree.joint_index(self.LOCKED)
        lock = JointConstraint(j, ref_q=float(q[0, tree.q_off[j]]))
        super().__init__(constraints=(weld, lock), **kwargs)

    def _sample_state(self, generator: torch.Generator, batch_size: int, info: dict):
        q, v = super()._sample_state(generator, batch_size, info)
        q[:, 2] = q[:, 2] + self.LIFT
        return q, v


def anymal_declarative_mdp(target_speed: float = 0.8, min_height: float = 0.3,
                           max_tilt_cos: float = 0.6):
    """ANYmal's MDP rebuilt from the declarative layer: a reward and a
    termination composed (:mod:`~jiminy_tpu_torch.envs.compositions`)
    over :class:`~jiminy_tpu_torch.envs.quantities.QuantityContext`,
    equal to :class:`WalkerEnv`'s hand-coded ones at these defaults.
    Returns ``(reward_fn, termination_fn)`` for
    ``ANYmalEnv(reward_fn=..., termination_fn=...)``."""
    from jiminy_tpu_torch.envs import compositions as C

    # exp(−err²/0.25) is radial_basis(err², cutoff) at this cutoff
    cutoff = float(np.sqrt(0.25 * np.log(1.0 / C.CUTOFF_ESP)))
    reward_fn = C.additive_mixture([
        (1.0, C.tracking_reward(lambda ctx: ctx.base_velocity_world[:, 0], target_speed, cutoff)),
        # uprightness: cos(tilt) = R[2, 2] = −(the gravity direction)_z
        (0.5, C.quantity_reward(lambda ctx: ctx.base_tilt)),
        (-0.1, C.quantity_reward(lambda ctx: torch.square(ctx.base_velocity_world[:, 1])
                                 + 0.5 * torch.square(ctx.base_angular_velocity[:, 2]))),
        (0.005, C.action_penalty(1.0)),
        (-0.05, C.quantity_reward(lambda ctx: torch.square(ctx.base_velocity_world[:, 2]))),
    ])
    termination_fn = C.any_termination([
        C.base_tilt_termination(max_tilt_cos),
        C.base_height_termination(min_height),
    ])
    return reward_fn, termination_fn
