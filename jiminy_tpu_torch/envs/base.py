"""Batched RL environment base with auto-reset.

Counterpart of ``jiminy_tpu/envs/base.py``: ``reset``, ``step_no_reset``
and ``step`` with auto-reset and ``info["final_obs"]``, over a batch of
envs held in one :class:`EnvState`. The reference's per-env PRNG key
becomes one ``torch.Generator`` carried by the state: ``reset`` takes it
and auto-reset draws the fresh episodes from it.

With ``sensors=`` (a :class:`~jiminy_tpu_torch.hardware.sensors.SensorSuite`)
the observation comes from delayed, corrupted measurements: the ring
buffers live in ``info["sensor_bufs"]`` as one flat (B, n_buf) tensor
(the kernel's layout) and take ``n_obs_updates`` updates per env step,
either inside the one K2 launch of :meth:`Engine.step_with_sensors` (the
fused path) or after each of ``n_obs_updates`` engine steps (the chunked
fallback). The corruption of each update is drawn by
:meth:`BaseEnv._sensor_eps`, which a caller may replace to hand in its
own draws.

Per-env state beyond the simulation lives in ``info`` as tensors with a
leading (B,) batch, so that auto-reset picks it like the rest: the hooks
:meth:`BaseEnv._init_info` (drawn at reset), :meth:`BaseEnv._update_info`
(after each step), :meth:`BaseEnv._step_ground` (a per-env ground for the
engine, e.g. from its coefficients in ``info``),
:meth:`BaseEnv._base_wrench` (a push on the root body),
:meth:`BaseEnv._external_forces` (wrenches on any body; a step with them
runs the engine's plain substep around the chain kernel, and on the
sensor path the chunked fallback),
:meth:`BaseEnv._model_params` (each env's model randomization for the
engine) and :meth:`BaseEnv._sensor_bias` (each env's sensor calibration
offsets, added to every corruption draw).

The spaces' sizes are the reference's properties: ``action_size`` (from
the subclass), ``observation_size`` (one reset of one env, cached),
``discrete_actions`` (None: continuous) and ``termination_meaning``
(``"failure"``), which the policy, ``rl.evaluate`` and PPO read;
:meth:`BaseEnv.rollout` steps a fixed action sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.engine import Engine, SimState, sim_state_from_arrays
from jiminy_tpu_torch.engine.randomization import ModelParams
from jiminy_tpu_torch.utils import health


@dataclasses.dataclass
class EnvState:
    """Everything about a batch of env instances."""

    sim: SimState
    obs: torch.Tensor  # (B, obs_dim)
    reward: torch.Tensor  # (B,)
    terminated: torch.Tensor  # (B,) bool — MDP termination
    truncated: torch.Tensor  # (B,) bool — time limit
    steps: torch.Tensor  # (B,) int32 — steps in the current episode
    generator: torch.Generator  # draws the auto-reset episodes
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def env_state_from_arrays(
    d: dict, generator: torch.Generator, device="cuda", dtype=torch.float32, engine=None
) -> EnvState:
    """EnvState from the reference's batched fields as numpy arrays:
    ``d["sim"]`` holds the SimState fields, ``d["info"]`` the info dict;
    ``obs``, ``reward``, ``terminated``, ``truncated`` and ``steps`` the
    rest. The reference's PRNG key has no counterpart: ``generator``
    takes its place. Two info entries change form: ``model_params`` (the
    reference's ``ModelParams`` as a mapping of its fields, each (B, ...))
    becomes ``engine``'s packed (B, n_mp) rows
    (``Engine._pack_model_params``; it needs the env's ``engine``), and
    ``sensor_bias`` (one (B, ns, ndim) array per sensor group) one (B,
    n_eps) row in the eps layout."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    def info_entry(k, x):  # floats take ``dtype``; integer and bool entries keep theirs
        if k == "model_params":
            if engine is None:
                raise ValueError("a state with model_params needs the env's engine to pack them")
            return engine._pack_model_params(ModelParams(*(f(x[n]) for n in ModelParams.FIELDS)))
        if k == "sensor_bias":
            return torch.cat([f(g).flatten(1) for g in x], dim=1)
        a = np.array(x)
        return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None, device=dev)

    return EnvState(
        sim=sim_state_from_arrays(d["sim"], device=dev, dtype=dtype),
        obs=f(d["obs"]),
        reward=f(d["reward"]),
        terminated=torch.as_tensor(np.array(d["terminated"]), dtype=torch.bool, device=dev),
        truncated=torch.as_tensor(np.array(d["truncated"]), dtype=torch.bool, device=dev),
        steps=torch.as_tensor(np.array(d["steps"]), dtype=torch.int32, device=dev),
        generator=generator,
        info={k: info_entry(k, x) for k, x in d.get("info", {}).items()},
    )


def _pick(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where done else b, with ``done`` (B,) broadcast over a's tail."""
    return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)


class BaseEnv:
    """Subclasses define the MDP on batched tensors:

    - ``_sample_state(generator, B, info) -> (q, v)``, ``info`` being
      what ``_init_info`` drew for the same episodes
    - ``_observe(sim) -> obs``, or with sensors
      ``_observe_from_sensors(readings, sim) -> obs``
    - ``_reward(prev, action, sim) -> (B,)``
    - ``_terminated(sim, info) -> (B,) bool``
    - ``_action_to_command(action, sim) -> (B, nm)``

    and optionally the per-env hooks ``_init_info``, ``_update_info``,
    ``_step_ground``, ``_base_wrench``, ``_external_forces``,
    ``_model_params`` and ``_sensor_bias``.
    """

    def __init__(
        self,
        engine: Engine,
        step_dt: float,
        max_steps: int = 1000,
        sensors=None,
        observe_dt: float | None = None,
        nan_guard: bool = True,
    ):
        """``observe_dt``: the period of the observation's refresh. With
        ``sensors`` it defaults to the suite's period and must equal it
        (delay interpolation counts buffer slots in periods), and
        ``step_dt`` must be a multiple of it, itself a multiple of the
        engine's dt, or ValueError; without, it is stored (default
        ``step_dt``). ``nan_guard``: terminate, with zero reward and
        observation, any env whose state goes non-finite or explodes, so
        that auto-reset recovers it (the reference's default)."""
        self.engine = engine
        self.nan_guard = nan_guard
        self.tree = engine.tree
        self.device = engine.device
        self.step_dt = step_dt
        self.n_substeps = max(1, round(step_dt / engine.options.dt))
        self.max_steps = max_steps
        self.sensors = sensors
        self._observation_size = None  # learned on first use
        if sensors is not None:
            self.observe_dt = float(sensors.period if observe_dt is None else observe_dt)
            if abs(self.observe_dt - sensors.period) > 1e-9:
                raise ValueError(
                    f"observe_dt={self.observe_dt} must equal the sensor suite period "
                    f"{sensors.period} (delay interpolation counts buffer slots in periods)"
                )
            self.n_obs_updates = max(1, round(step_dt / self.observe_dt))
            self.n_substeps_per_obs = max(1, round(self.observe_dt / engine.options.dt))
            if self.n_obs_updates * self.n_substeps_per_obs != self.n_substeps:
                raise ValueError(
                    f"step_dt={step_dt} must be a multiple of observe_dt={self.observe_dt}, "
                    f"itself a multiple of the engine dt={engine.options.dt}"
                )
        else:
            self.observe_dt = float(observe_dt or step_dt)
            self.n_obs_updates = 1
            self.n_substeps_per_obs = self.n_substeps
        # does the sensor path run the kernel's sensor stage (one launch
        # per env step) rather than the chunked fallback? Decided once;
        # setting it False forces the fallback
        self._fused_sensors = sensors is not None and engine.sensor_fusion_ready(
            sensors, self.n_substeps, self.n_substeps_per_obs
        )

    def _sample_state(self, generator, batch_size, info):
        raise NotImplementedError

    def _observe(self, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _observe_from_sensors(self, readings: dict, sim: SimState) -> torch.Tensor:
        """Observation from the delayed readings {type: (B, ns, dim)} of
        ``SensorSuite.read``; needed when the env has ``sensors``."""
        raise NotImplementedError

    def _make_obs(self, sim: SimState, info: dict) -> torch.Tensor:
        if self.sensors is None:
            return self._observe(sim)
        suite = self.sensors
        return self._observe_from_sensors(
            suite.read(suite.unflatten_buffers(info["sensor_bufs"])), sim
        )

    def _sensor_eps(self, generator: torch.Generator, batch_size: int, n_updates: int,
                    bias_extra=None) -> torch.Tensor:
        """Corruption of ``n_updates`` sensor updates (B, n_updates·n_eps),
        update after update; reset asks for one, a step for
        ``n_obs_updates``. ``bias_extra``: each env's calibration offsets
        (:meth:`_sensor_bias`) or None."""
        return torch.cat(
            [self.sensors.sample_eps(generator, batch_size, bias_extra) for _ in range(n_updates)],
            dim=1,
        )

    def _reward(self, prev: EnvState, action, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _terminated(self, sim: SimState, info: dict) -> torch.Tensor:
        raise NotImplementedError

    def _action_to_command(self, action, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _init_info(self, generator: torch.Generator, batch_size: int) -> dict:
        """Per-env info entries of fresh episodes, (B, ...) tensors drawn
        from ``generator`` (e.g. each env's ground, the push state)."""
        return {}

    def _update_info(self, prev: EnvState, sim: SimState, generator: torch.Generator) -> dict:
        """Info entries to replace after a step from ``prev`` to ``sim``
        (the same keys as ``_init_info``'s)."""
        return {}

    def _step_ground(self, info: dict):
        """The per-env ground that ``engine.step`` takes this step, or None
        for the engine's own."""
        return None

    def _base_wrench(self, state: EnvState) -> torch.Tensor | None:
        """A (B, 6) local [ang; lin] wrench on the root body held over the
        next step (pushes), or None."""
        return None

    def _external_forces(self, state: EnvState) -> torch.Tensor | None:
        """(B, nb, 6) or (nb, 6) local [ang; lin] wrenches on the bodies
        held over the next step (force profiles), or None. Generic, but a
        step with them leaves the whole-substep kernels (the engine's
        ``fext_user``); for pushes on the base prefer :meth:`_base_wrench`."""
        return None

    def _model_params(self, info: dict):
        """Each env's packed model parameters (B, n_mp) for ``engine.step``
        (``Engine._pack_model_params``, drawn and packed into ``info`` at
        reset, so that auto-reset draws anew per episode), or None for the
        nominal model."""
        return None

    def _sensor_bias(self, info: dict):
        """Each env's additive sensor offsets, one (B, ns, ndim) tensor per
        sensor group, or None."""
        return None

    # ---- spaces metadata (sizes), as the reference's
    @property
    def action_size(self) -> int:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        """Learned once from a reset of one env on the env's device (from
        a fixed seed), then cached."""
        if self._observation_size is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self._observation_size = int(self.reset(gen, 1).obs.shape[-1])
        return self._observation_size

    @property
    def discrete_actions(self) -> int | None:
        """Number of discrete actions, or None for continuous."""
        return None

    @property
    def termination_meaning(self) -> str:
        """How ``evaluate`` reads MDP termination: ``"failure"`` (walkers:
        terminated means fell) or ``"success"`` (goal tasks)."""
        return "failure"

    def reset(self, generator: torch.Generator, batch_size: int) -> EnvState:
        """``batch_size`` fresh episodes drawn from ``generator``. With
        sensors, the buffers hold one corrupted measurement at the
        initial state (a, τ and contact forces zero) in every slot."""
        info = self._init_info(generator, batch_size)
        q, v = self._sample_state(generator, batch_size, info)
        sim = self.engine.reset(q=q, v=v)
        if self.sensors is not None:
            suite = self.sensors
            eps = self._sensor_eps(generator, batch_size, 1, self._sensor_bias(info))
            info["sensor_bufs"] = suite.flatten_buffers(suite.reset(eps, sim.q, sim.v))
        obs = self._make_obs(sim, info)
        if self.sensors is not None:
            # the buffers that go with final_obs (after an auto-reset,
            # sensor_bufs already hold the next episode's)
            info["final_sensor_bufs"] = info["sensor_bufs"]
        B, dev = batch_size, self.device
        return EnvState(
            sim=sim,
            obs=obs,
            reward=torch.zeros(B, dtype=obs.dtype, device=dev),
            terminated=torch.zeros(B, dtype=torch.bool, device=dev),
            truncated=torch.zeros(B, dtype=torch.bool, device=dev),
            steps=torch.zeros(B, dtype=torch.int32, device=dev),
            generator=generator,
            info={"final_obs": obs, **info},
        )

    def _step_sensors(self, state: EnvState, u: torch.Tensor, wrench, ground, mp, fext=None):
        """The engine step with the sensor updates → (sim, new flat
        buffers): fused (one K2 launch) when the engine's kernel takes
        this ground and no ``fext`` is given, else chunked (n_obs_updates
        engine steps of n_substeps_per_obs, each followed by the suite's
        update at the accepted state). ``mp``: each env's model parameters
        or None; ``fext``: the bodies' wrenches or None."""
        suite, eng = self.sensors, self.engine
        eps = self._sensor_eps(state.generator, state.obs.shape[0], self.n_obs_updates,
                               self._sensor_bias(state.info))
        bufs = state.info["sensor_bufs"]
        if self._fused_sensors and fext is None \
                and eng._kernel_ground_ok(ground if ground is not None else eng.ground):
            return eng.step_with_sensors(
                state.sim, u, self.n_substeps, suite, bufs, eps,
                k_obs=self.n_substeps_per_obs, base_wrench=wrench, ground=ground,
                model_params=mp,
            )
        sim, tup = state.sim, suite.unflatten_buffers(bufs)
        for e in eps.split(suite.n_eps, dim=1):
            sim = eng.step(sim, u, n_substeps=self.n_substeps_per_obs, base_wrench=wrench,
                           ground=ground, model_params=mp, fext_user=fext)
            tup = suite.update(tup, e, sim.q, sim.v, sim.a, sim.contact_forces, sim.tau)
        return sim, suite.flatten_buffers(tup)

    def step_no_reset(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One env step without auto-reset."""
        u = self._action_to_command(action, state.sim)
        fext = self._external_forces(state)
        wrench = self._base_wrench(state)
        ground = self._step_ground(state.info)
        mp = self._model_params(state.info)
        info = dict(state.info)
        if self.sensors is None:
            sim = self.engine.step(state.sim, u, n_substeps=self.n_substeps, base_wrench=wrench,
                                   ground=ground, model_params=mp, fext_user=fext)
        else:
            sim, info["sensor_bufs"] = self._step_sensors(state, u, wrench, ground, mp, fext)
        obs = self._make_obs(sim, info)
        reward = self._reward(state, action, sim)
        steps = state.steps + 1
        terminated = self._terminated(sim, state.info)
        if self.nan_guard:
            bad = health.is_bad_state(sim)
            terminated = terminated | bad
            reward = torch.where(bad, torch.zeros_like(reward), reward)
            obs = torch.where(bad[:, None], torch.zeros_like(obs), obs)
        truncated = steps >= self.max_steps
        info.update(self._update_info(state, sim, state.generator))
        return state.replace(
            sim=sim,
            obs=obs,
            reward=reward.to(torch.float32),
            terminated=terminated,
            truncated=truncated,
            steps=steps,
            info=info,
        )

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One env step with auto-reset: where an episode ends, the
        returned state is a fresh episode; reward/terminated/truncated
        still describe the finished step, ``info["final_obs"]`` holds its
        terminal observation and, with sensors,
        ``info["final_sensor_bufs"]`` its buffers."""
        nxt = self.step_no_reset(state, action)
        fresh = self.reset(state.generator, state.obs.shape[0])
        done = nxt.terminated | nxt.truncated
        sim = SimState(
            **{
                k: _pick(done, getattr(fresh.sim, k), getattr(nxt.sim, k))
                for k in SimState.FIELDS
            }
        )
        info = {
            k: _pick(done, fresh.info[k], nxt.info[k])
            for k in nxt.info if k in fresh.info
        }
        info["final_obs"] = nxt.obs
        if self.sensors is not None:
            info["final_sensor_bufs"] = nxt.info["sensor_bufs"]
        return nxt.replace(
            sim=sim,
            obs=_pick(done, fresh.obs, nxt.obs),
            steps=_pick(done, fresh.steps, nxt.steps),
            info=info,
        )

    def rollout(self, state: EnvState, actions: torch.Tensor) -> tuple[EnvState, dict]:
        """``step`` (with auto-reset) through the actions (T, B, A); returns
        the final state and the stacked (T, B, ...) ``obs``, ``reward``,
        ``terminated`` and ``truncated`` of every step."""
        T, B = actions.shape[:2]
        out = {
            "obs": torch.empty(T, B, *state.obs.shape[1:], dtype=state.obs.dtype,
                               device=state.obs.device),
            "reward": torch.empty(T, B, dtype=state.reward.dtype, device=state.reward.device),
            "terminated": torch.empty(T, B, dtype=torch.bool, device=state.obs.device),
            "truncated": torch.empty(T, B, dtype=torch.bool, device=state.obs.device),
        }
        for t in range(T):
            state = self.step(state, actions[t])
            for k, buf in out.items():
                buf[t] = getattr(state, k)
        return state, out
