"""Velocity-tracking locomotion env on a floating-base legged robot.

Counterpart of ``jiminy_tpu/envs/locomotion.py`` (``WalkerEnv``):
``_sample_state``, ``_observe``, ``_observe_from_sensors``, ``_reward``,
``_terminated`` and ``_action_to_command``, batched, with the terrain and
push hooks:

- ``ground`` (one ground for the batch) or ``ground_sampler`` (a fresh
  analytic ground per env at every reset, carried in ``info["ground"]``
  as its coefficients and handed to the engine each step); the spawn sits
  on it: with ``spawn_radius`` at a uniform xy in the square of that
  half-width, raised by the height there, else with a sampler raised by
  the height at the stand xy;
- pushes: each step an env not being pushed starts a push with
  probability ``push_prob``, a horizontal world force of
  ``push_magnitude`` N in a uniform direction held for ``push_duration``
  s (``info["push_force"]``, ``info["push_steps_left"]``), applied at the
  base as a local wrench (:meth:`WalkerEnv._base_wrench`). The draws come
  from :meth:`WalkerEnv._push_draws`, which a caller may replace;
- ``_terminated`` measures the base height against each env's own ground;
- ``model_randomization`` (a
  :class:`~jiminy_tpu_torch.engine.randomization.ModelRandomization`):
  each episode draws its env's masses, centres of mass, inertias,
  armature and motor gains and friction, packed once into the engine's
  row (``Engine._pack_model_params``, (B, n_mp)), carried in
  ``info["model_params"]`` and handed to the engine each step, and with ``sensor_bias > 0`` on the sensor path its
  calibration offsets, ``info["sensor_bias"]`` (B, n_eps), added to every
  corruption draw. The draws come from :meth:`WalkerEnv._model_draws`,
  which a caller may replace;
- ``constraints``: kinematic constraints (frame, joint, distance,
  sphere and wheel constraints: Cassie's pushrods, a gantry's weld, a
  locked joint), handed to the engine; any but distance ones send
  ``"auto"`` to the chain kernel (``constraint_solver="kernel"``), and the
  state's ``lam`` has the engine's nc;
- ``collision_pairs``: declared body-body pairs
  (:class:`~jiminy_tpu_torch.engine.collision.CollisionPair`, e.g.
  Cassie's leg capsules), handed to the engine;
- ``nan_guard`` (default True): an env whose state goes non-finite or
  explodes terminates with zero reward and observation
  (:class:`~jiminy_tpu_torch.envs.base.BaseEnv`).

The engine runs contacts as PGS rows (``contact_model="constraint"``, as
the reference's walker envs ask for), unless ``engine_options`` (an
:class:`~jiminy_tpu_torch.engine.engine.EngineOptions`) replaces the
env's own options as a whole, as in the reference: e.g. the reference's
default penalty contacts and bounds on the continuous path
(``EngineOptions(dt=1e-3)``), whose dt then sets the substeps per step.

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
from jiminy_tpu_torch.engine.randomization import ModelRandomization
from jiminy_tpu_torch.envs.base import BaseEnv, EnvState
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import mtv, mv


# options of the reference's walker envs that the port does not take yet,
# by the ROADMAP item that ports them
UNPORTED_OPTIONS = {
    "reward_fn": "A.17 (declarative layer)",
    "termination_fn": "A.17 (declarative layer)",
}


def check_options(env: str, kwargs: dict, passed_on: tuple):
    """Refuse an option of ``kwargs`` that is not in ``passed_on``:
    NotImplementedError naming its ROADMAP item for an option still to
    port, TypeError for an unknown one."""
    for k in kwargs:
        if k in passed_on:
            continue
        if k not in UNPORTED_OPTIONS:
            raise TypeError(f"{env}: unexpected argument {k!r}")
        raise NotImplementedError(
            f"{env}({k}=...) is not ported yet (ROADMAP {UNPORTED_OPTIONS[k]})"
        )


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
        ground=None,  # one ground for the whole batch (default flat)
        ground_sampler=None,  # (generator, batch_shape) -> analytic ground, per env
        spawn_radius: float = 0.0,  # spawn xy uniform in [−r, r]² over the terrain
        push_magnitude: float = 0.0,  # N; 0 disables pushes
        push_prob: float = 0.01,  # per-step probability of a push onset
        push_duration: float = 0.1,  # s
        model_randomization: ModelRandomization | None = None,  # per-episode draws
        constraints: tuple = (),  # kinematic constraints (engine.constraints)
        collision_pairs: tuple = (),  # engine.collision.CollisionPair
        nan_guard: bool = True,  # BaseEnv: auto-reset non-finite envs
        engine_options: EngineOptions | None = None,  # replaces the options below
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
        self.ground_sampler = ground_sampler
        if ground_sampler is not None:
            if ground is not None:
                raise ValueError("pass ground or ground_sampler, not both")
            # the engine's ground fixes the kernel's kind and term count;
            # each env's own coefficients come from info at every step
            ground = ground_sampler(torch.Generator(device=device).manual_seed(0), ())
        opts = engine_options or EngineOptions(
            dt=sim_dt,
            contact_model="constraint",
            pgs_iters=pgs_iters,
            # RL envs do not read the solver residual
            compute_solver_residual=False,
            constraint_solver=constraint_solver,
        )
        engine = Engine(
            tree,
            opts,
            ground=ground if ground is not None else FlatGround(),
            motors=motors,
            controller=PDController(kp, kd),
            constraints=constraints,
            collision_pairs=collision_pairs,
            device=device,
        )
        suite = None
        if observe == "sensors":
            suite = sensors.to(device=engine.device, dtype=engine.tree.dtype)
        super().__init__(engine, step_dt=step_dt, max_steps=max_steps, sensors=suite,
                         nan_guard=nan_guard)
        self.motors = engine.motors
        self.action_scale = action_scale
        self.target_speed = target_speed
        self.reset_noise = reset_noise
        self.min_height = min_height
        self.max_tilt_cos = max_tilt_cos
        self.spawn_radius = spawn_radius
        self.push_magnitude = push_magnitude
        self.push_prob = push_prob
        self.push_steps = max(1, round(push_duration / step_dt))
        self.model_randomization = model_randomization
        self._q_stand = torch.as_tensor(
            stand_pose, dtype=self.tree.dtype, device=self.device
        )
        self._stand_targets, _ = self.motors.joint_state(
            self._q_stand, torch.zeros(self.tree.nv, dtype=self.tree.dtype, device=self.device)
        )

    @property
    def action_size(self) -> int:
        return len(self.motors.name)

    def _episode_ground(self, info: dict):
        """Each env's ground: from its coefficients in ``info`` with a
        sampler, else the engine's own."""
        g = self.engine.ground
        return type(g).from_coef(info["ground"], g) if "ground" in info else g

    def _sample_state(self, generator: torch.Generator, batch_size: int, info: dict):
        """Stand pose + U(−1, 1)·reset_noise on the motor joints, and
        N(0, 1)·0.1·reset_noise velocities; the base on the episode's
        ground (see the module's docstring)."""
        nm, nv = self.motors.nm, self.tree.nv
        kw = dict(generator=generator, device=generator.device)
        dq = self.reset_noise * (2.0 * torch.rand(batch_size, nm, **kw) - 1.0)
        v = 0.1 * self.reset_noise * torch.randn(batch_size, nv, **kw)
        q = self._q_stand.expand(batch_size, -1).clone()
        idx = list(self.motors.q_idx)
        q[:, idx] = q[:, idx] + dq.to(device=self.device, dtype=q.dtype)
        ground = self._episode_ground(info)
        if self.spawn_radius > 0:
            xy = self.spawn_radius * (2.0 * torch.rand(batch_size, 2, **kw) - 1.0)
            q[:, 0:2] = xy.to(device=self.device, dtype=q.dtype)
            q[:, 2] = q[:, 2] + ground.query(q[:, 0:2])[0]
        elif self.ground_sampler is not None:
            q[:, 2] = q[:, 2] + ground.query(q[:, 0:2])[0]
        return q, v.to(device=self.device, dtype=q.dtype)

    # ---- terrain, randomization and pushes (info entries, picked by auto-reset)
    def _model_draws(self, generator: torch.Generator, batch_size: int):
        """Fresh episodes' model randomization: (ModelParams (B,), the
        sensor offsets as one (B, ns, ndim) tensor per group, or None when
        ``sensor_bias`` is 0 or the env observes the state)."""
        mr = self.model_randomization
        params = mr.sample(generator, self.tree, self.motors, batch_size)
        bias = None
        if mr.sensor_bias > 0.0 and self.sensors is not None:
            bias = mr.sample_sensor_bias(generator, self.sensors, batch_size)
        return params, bias

    def _init_info(self, generator: torch.Generator, batch_size: int) -> dict:
        info = {}
        if self.ground_sampler is not None:
            info["ground"] = self.ground_sampler(generator, (batch_size,)).coef().to(
                device=self.device, dtype=self.tree.dtype)
        if self.model_randomization is not None:
            params, bias = self._model_draws(generator, batch_size)
            info["model_params"] = self.engine._pack_model_params(params)
            if bias is not None:
                info["sensor_bias"] = torch.cat([b.flatten(1) for b in bias], dim=1).to(
                    device=self.device, dtype=self.tree.dtype)
        if self.push_magnitude > 0.0:
            info["push_force"] = torch.zeros(batch_size, 3, dtype=self.tree.dtype,
                                             device=self.device)
            info["push_steps_left"] = torch.zeros(batch_size, dtype=torch.int32,
                                                  device=self.device)
        return info

    def _step_ground(self, info: dict):
        return self._episode_ground(info) if "ground" in info else None

    def _model_params(self, info: dict):
        return info.get("model_params")

    def _sensor_bias(self, info: dict):
        return self.sensors._split_eps(info["sensor_bias"]) if "sensor_bias" in info else None

    def _push_draws(self, generator: torch.Generator, batch_size: int):
        """This step's push draws: (onset (B,) bool, Bernoulli(push_prob);
        direction angle (B,), U(0, 2π))."""
        kw = dict(generator=generator, device=generator.device)
        onset = torch.rand(batch_size, **kw) < self.push_prob
        theta = 2.0 * torch.pi * torch.rand(batch_size, **kw)
        return onset.to(self.device), theta.to(device=self.device, dtype=self.tree.dtype)

    def _update_info(self, prev: EnvState, sim: SimState, generator: torch.Generator) -> dict:
        """The push schedule: an env whose push has run out starts a new
        one on its onset draw; the others count down."""
        if self.push_magnitude <= 0.0:
            return {}
        onset, theta = self._push_draws(generator, sim.q.shape[0])
        left = prev.info["push_steps_left"]
        start = onset & (left <= 0)
        force = self.push_magnitude * torch.stack(
            [torch.cos(theta), torch.sin(theta), torch.zeros_like(theta)], dim=-1)
        return {
            "push_force": torch.where(start[:, None], force, prev.info["push_force"]),
            "push_steps_left": torch.where(
                start, torch.full_like(left, self.push_steps), torch.clamp(left - 1, min=0)),
        }

    def _base_wrench(self, state: EnvState):
        """The active push as a local wrench on the base: the world force
        at the base origin rotated into the base frame, no torque."""
        if self.push_magnitude <= 0.0:
            return None
        active = (state.info["push_steps_left"] > 0).to(state.sim.q.dtype)
        f_world = active[:, None] * state.info["push_force"]
        R = so3.quat_to_matrix(state.sim.q[:, 3:7])
        return torch.cat([torch.zeros_like(f_world), mtv(R, f_world)], dim=-1)

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

    def _terminated(self, sim: SimState, info: dict) -> torch.Tensor:
        _, grav_b, _, _ = self._base_frames(sim)
        fallen = grav_b[:, 2] > -self.max_tilt_cos
        # the height above each env's own ground
        h, _ = self._episode_ground(info).query(sim.q[:, :2])
        low = (sim.q[:, 2] - h) < self.min_height
        return fallen | low
