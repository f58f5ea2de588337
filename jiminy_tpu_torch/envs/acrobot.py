"""Acrobot swing-up env, batched.

Counterpart of ``jiminy_tpu/envs/acrobot.py`` (the reference's
``AcrobotJiminyEnv``): a torque on the elbow alone, discrete (actions 0,
1, 2 → −τ, 0, +τ) or continuous (an action in [−1, 1] scaling τ);
reward −1 per step until the tip rises above one link length over the
pivot, which ends the episode as a success (``termination_meaning``).
The engine is the reference's: ``make_acrobot()``, RK4 with 20 ms
substeps and 0.2 s steps on the continuous path, the ground 10 m down,
out of reach, ``enable_bounds=False``.
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.engine import Engine, EngineOptions, SimState
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.envs.base import BaseEnv, EnvState
from jiminy_tpu_torch.models import make_acrobot


class AcrobotEnv(BaseEnv):
    """Observation (B, 6): cos θ1, sin θ1, cos θ2, sin θ2, θ̇1, θ̇2; action
    (B,) in {0, 1, 2}, or (B, 1) continuous."""

    def __init__(self, torque_mag: float = 1.0, step_dt: float = 0.2, sim_dt: float = 0.02,
                 max_steps: int = 500, continuous: bool = False, device="cuda",
                 dtype=torch.float32):
        dev = resolve_device(device)
        engine = Engine(
            make_acrobot(device=dev, dtype=dtype),
            EngineOptions(dt=sim_dt, solver="runge_kutta_4", enable_bounds=False),
            ground=FlatGround(height=-10.0), device=dev,
        )
        super().__init__(engine, step_dt=step_dt, max_steps=max_steps)
        self.torque_mag = torque_mag
        self.continuous = continuous

    @property
    def termination_meaning(self) -> str:
        return "success"  # terminated: the swing-up reached its goal

    @property
    def action_size(self) -> int:
        return 1

    @property
    def discrete_actions(self) -> int | None:
        return None if self.continuous else 3

    def _sample_state(self, generator: torch.Generator, batch_size: int, info: dict):
        """q and v each U(−0.1, 0.1)² per env."""
        kw = dict(generator=generator, device=generator.device)
        q = 0.2 * torch.rand(batch_size, 2, **kw) - 0.1
        v = 0.2 * torch.rand(batch_size, 2, **kw) - 0.1
        return (q.to(device=self.device, dtype=self.tree.dtype),
                v.to(device=self.device, dtype=self.tree.dtype))

    def _action_to_command(self, action, sim: SimState):
        a = action.reshape(-1).to(sim.q.dtype)
        if self.continuous:
            t = torch.clamp(a, -1.0, 1.0) * self.torque_mag
        else:
            t = (torch.clamp(a, 0.0, 2.0) - 1.0) * self.torque_mag
        return torch.stack([torch.zeros_like(t), t], dim=-1)

    def _observe(self, sim: SimState) -> torch.Tensor:
        t1, t2 = sim.q[:, 0], sim.q[:, 1]
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2),
                            sim.v[:, 0], sim.v[:, 1]], dim=-1)

    def _tip_height(self, sim: SimState) -> torch.Tensor:
        """The tip's height over the pivot (links of 1 m hanging down at
        q = 0)."""
        t1, t2 = sim.q[:, 0], sim.q[:, 1]
        return -torch.cos(t1) - torch.cos(t1 + t2)

    def _reward(self, prev: EnvState, action, sim: SimState) -> torch.Tensor:
        done = self._terminated(sim, prev.info)
        return torch.where(done, torch.zeros_like(sim.t), -torch.ones_like(sim.t))

    def _terminated(self, sim: SimState, info: dict) -> torch.Tensor:
        return self._tip_height(sim) > 1.0
