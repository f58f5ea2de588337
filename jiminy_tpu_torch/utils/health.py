"""Numerical-health checks, batched. Counterpart of the per-step tier of
``jiminy_tpu/utils/health.py`` (``is_bad_state``), which the env's NaN
guard calls every step."""

from __future__ import annotations

import torch


def is_bad_state(sim, vel_limit: float = 1e4, residual_limit: float = 1e6):
    """(B,) bool: state non-finite, velocities above ``vel_limit`` or the
    solver residual non-finite / above ``residual_limit``."""
    bad_q = ~torch.all(torch.isfinite(sim.q), dim=-1)
    bad_v = ~torch.all(torch.isfinite(sim.v), dim=-1)
    huge_v = torch.any(torch.abs(sim.v) > vel_limit, dim=-1)
    res = sim.solver_residual
    bad_res = ~torch.isfinite(res) | (res > residual_limit)
    return bad_q | bad_v | huge_v | bad_res
