"""Batched RL environment base with auto-reset.

Counterpart of ``jiminy_tpu/envs/base.py``: ``reset``, ``step_no_reset``
and ``step`` with auto-reset and ``info["final_obs"]``, over a batch of
envs held in one :class:`EnvState`. The reference's per-env PRNG key
becomes one ``torch.Generator`` carried by the state: ``reset`` takes it
and auto-reset draws the fresh episodes from it.

The sensor observation path, per-step grounds, pushes and model
randomization are not ported yet (ROADMAP A.9–A.11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.engine import Engine, SimState, sim_state_from_arrays
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
    d: dict, generator: torch.Generator, device="cuda", dtype=torch.float32
) -> EnvState:
    """EnvState from the reference's batched fields as numpy arrays:
    ``d["sim"]`` holds the SimState fields, ``d["info"]`` the info dict;
    ``obs``, ``reward``, ``terminated``, ``truncated`` and ``steps`` the
    rest. The reference's PRNG key has no counterpart: ``generator``
    takes its place."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return EnvState(
        sim=sim_state_from_arrays(d["sim"], device=dev, dtype=dtype),
        obs=f(d["obs"]),
        reward=f(d["reward"]),
        terminated=torch.as_tensor(np.array(d["terminated"]), dtype=torch.bool, device=dev),
        truncated=torch.as_tensor(np.array(d["truncated"]), dtype=torch.bool, device=dev),
        steps=torch.as_tensor(np.array(d["steps"]), dtype=torch.int32, device=dev),
        generator=generator,
        info={k: f(x) for k, x in d.get("info", {}).items()},
    )


def _pick(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where done else b, with ``done`` (B,) broadcast over a's tail."""
    return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)


class BaseEnv:
    """Subclasses define the MDP on batched tensors:

    - ``_sample_state(generator, B) -> (q, v)``
    - ``_observe(sim) -> obs``
    - ``_reward(prev, action, sim) -> (B,)``
    - ``_terminated(sim) -> (B,) bool``
    - ``_action_to_command(action, sim) -> (B, nm)``
    """

    def __init__(self, engine: Engine, step_dt: float, max_steps: int = 1000):
        self.engine = engine
        self.tree = engine.tree
        self.device = engine.device
        self.step_dt = step_dt
        self.n_substeps = max(1, round(step_dt / engine.options.dt))
        self.max_steps = max_steps

    def _sample_state(self, generator, batch_size):
        raise NotImplementedError

    def _observe(self, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _reward(self, prev: EnvState, action, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _terminated(self, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def _action_to_command(self, action, sim: SimState) -> torch.Tensor:
        raise NotImplementedError

    def reset(self, generator: torch.Generator, batch_size: int) -> EnvState:
        """``batch_size`` fresh episodes drawn from ``generator``."""
        q, v = self._sample_state(generator, batch_size)
        sim = self.engine.reset(q=q, v=v)
        obs = self._observe(sim)
        B, dev = batch_size, self.device
        return EnvState(
            sim=sim,
            obs=obs,
            reward=torch.zeros(B, dtype=obs.dtype, device=dev),
            terminated=torch.zeros(B, dtype=torch.bool, device=dev),
            truncated=torch.zeros(B, dtype=torch.bool, device=dev),
            steps=torch.zeros(B, dtype=torch.int32, device=dev),
            generator=generator,
            info={"final_obs": obs},
        )

    def step_no_reset(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One env step without auto-reset."""
        u = self._action_to_command(action, state.sim)
        sim = self.engine.step(state.sim, u, n_substeps=self.n_substeps)
        obs = self._observe(sim)
        reward = self._reward(state, action, sim)
        steps = state.steps + 1
        # NaN guard: a non-finite or exploding env terminates with zero
        # reward and observation, so auto-reset recovers it
        bad = health.is_bad_state(sim)
        terminated = self._terminated(sim) | bad
        reward = torch.where(bad, torch.zeros_like(reward), reward)
        obs = torch.where(bad[:, None], torch.zeros_like(obs), obs)
        truncated = steps >= self.max_steps
        return state.replace(
            sim=sim,
            obs=obs,
            reward=reward.to(torch.float32),
            terminated=terminated,
            truncated=truncated,
            steps=steps,
            info=dict(state.info),
        )

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One env step with auto-reset: where an episode ends, the
        returned state is a fresh episode; reward/terminated/truncated
        still describe the finished step and ``info["final_obs"]`` holds
        its terminal observation."""
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
        return nxt.replace(
            sim=sim,
            obs=_pick(done, fresh.obs, nxt.obs),
            steps=_pick(done, fresh.steps, nxt.steps),
            info=info,
        )
