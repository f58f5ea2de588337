"""CartPole env, batched.

Counterpart of ``jiminy_tpu/envs/cartpole.py`` (the reference's
``CartPoleJiminyEnv``): a ±``force_mag`` push on the cart, discrete
(action 0 or 1) or continuous (an action in [−1, 1] scaling the force),
the classic termination (|x| > 2.4 m, |θ| > 12°), reward 1 per step.
The engine is the reference's: ``make_cartpole(x_limit=4.8)`` (the
cart's bounds beyond the termination box), 10 symplectic-Euler substeps
of 2 ms per 20 ms step on the continuous path (no contact, no motor: the
command is the joint torque), ``enable_bounds=False``.
"""

from __future__ import annotations

import math

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.engine import Engine, EngineOptions, SimState
from jiminy_tpu_torch.envs.base import BaseEnv, EnvState
from jiminy_tpu_torch.models import make_cartpole


class CartPoleEnv(BaseEnv):
    """Observation (B, 4): x, ẋ, θ, θ̇; action (B,) in {0, 1}, or (B, 1)
    continuous."""

    THETA_LIMIT = 12.0 * math.pi / 180.0
    X_LIMIT = 2.4

    def __init__(self, force_mag: float = 10.0, step_dt: float = 0.02, sim_dt: float = 0.002,
                 max_steps: int = 500, continuous: bool = False, device="cuda",
                 dtype=torch.float32):
        dev = resolve_device(device)
        tree = make_cartpole(x_limit=4.8, device=dev, dtype=dtype)  # bounds beyond the box
        engine = Engine(tree, EngineOptions(dt=sim_dt, enable_bounds=False), device=dev)
        super().__init__(engine, step_dt=step_dt, max_steps=max_steps)
        self.force_mag = force_mag
        self.continuous = continuous

    @property
    def action_size(self) -> int:
        return 1

    @property
    def discrete_actions(self) -> int | None:
        return None if self.continuous else 2

    def _sample_state(self, generator: torch.Generator, batch_size: int, info: dict):
        """q and v each U(−0.05, 0.05)² per env."""
        kw = dict(generator=generator, device=generator.device)
        q = 0.1 * torch.rand(batch_size, 2, **kw) - 0.05
        v = 0.1 * torch.rand(batch_size, 2, **kw) - 0.05
        return (q.to(device=self.device, dtype=self.tree.dtype),
                v.to(device=self.device, dtype=self.tree.dtype))

    def _action_to_command(self, action, sim: SimState):
        a = action.reshape(-1).to(sim.q.dtype)
        if self.continuous:
            f = torch.clamp(a, -1.0, 1.0) * self.force_mag
        else:
            f = (2.0 * torch.clamp(a, 0.0, 1.0) - 1.0) * self.force_mag
        return torch.stack([f, torch.zeros_like(f)], dim=-1)

    def _observe(self, sim: SimState) -> torch.Tensor:
        return torch.stack([sim.q[:, 0], sim.v[:, 0], sim.q[:, 1], sim.v[:, 1]], dim=-1)

    def _reward(self, prev: EnvState, action, sim: SimState) -> torch.Tensor:
        return torch.ones_like(sim.t)

    def _terminated(self, sim: SimState, info: dict) -> torch.Tensor:
        return (torch.abs(sim.q[:, 0]) > self.X_LIMIT) | (torch.abs(sim.q[:, 1]) > self.THETA_LIMIT)
