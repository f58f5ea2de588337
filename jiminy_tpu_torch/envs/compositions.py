"""Reward and termination compositions over quantities.

Counterpart of ``jiminy_tpu/envs/compositions.py`` (the reference's
declarative compositions: radial-basis tracking rewards over quantities,
additive and multiplicative mixtures, the survival reward; quantity-bound,
drift, flying and mechanical-safety terminations). Each is a function of a
:class:`~jiminy_tpu_torch.envs.quantities.QuantityContext` (and the
action, (B, A)): a reward gives (B,), a termination (B,) bool.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from jiminy_tpu_torch.envs.quantities import QuantityContext

# reward (ctx, action) → (B,); termination ctx → (B,) bool
RewardFn = Callable[[QuantityContext, torch.Tensor], torch.Tensor]
TerminationFn = Callable[[QuantityContext], torch.Tensor]

CUTOFF_ESP = 1e-2  # radial-basis value at the cutoff (the reference's constant)


def _batch(ctx: QuantityContext) -> int:
    return ctx.sim.q.shape[0]


def radial_basis(err2: torch.Tensor, cutoff: float) -> torch.Tensor:
    """exp(−err²·ln(1/ε)/cutoff²): 1 at zero error, ε at the cutoff."""
    return torch.exp(-err2 * (math.log(1.0 / CUTOFF_ESP) / (cutoff * cutoff)))


def tracking_reward(quantity: Callable[[QuantityContext], torch.Tensor], target,
                    cutoff: float) -> RewardFn:
    """Radial-basis tracking of a quantity toward ``target`` (a constant,
    or fn(ctx) → tensor), its error summed over each env's components."""

    def fn(ctx: QuantityContext, action) -> torch.Tensor:
        val = quantity(ctx)
        tgt = target(ctx) if callable(target) else torch.as_tensor(target, dtype=val.dtype,
                                                                   device=val.device)
        err = (val - tgt).reshape(_batch(ctx), -1)
        return radial_basis(torch.sum(err * err, dim=-1), cutoff)

    return fn


def quantity_reward(quantity: Callable[[QuantityContext], torch.Tensor]) -> RewardFn:
    """The raw quantity (B,) as a reward term; weight it in
    :func:`additive_mixture`."""
    return lambda ctx, action: quantity(ctx)


def survival_reward(value: float = 1.0) -> RewardFn:
    """A constant alive bonus, (B,): ``value`` rounded to float32, as the
    reference's constant is."""
    value = float(np.float32(value))
    return lambda ctx, action: torch.full_like(ctx.sim.q[:, 0], value)


def action_penalty(weight: float = 1.0) -> RewardFn:
    """−w·‖action‖² per env."""
    return lambda ctx, action: -weight * torch.sum(torch.square(action), dim=-1)


def additive_mixture(parts: Sequence[tuple[float, RewardFn]]) -> RewardFn:
    """Σ wᵢ·rᵢ."""

    def fn(ctx, action):
        total = ctx.sim.q.new_zeros(_batch(ctx))
        for w, r in parts:
            total = total + w * r(ctx, action)
        return total

    return fn


def multiplicative_mixture(parts: Sequence[RewardFn]) -> RewardFn:
    """Π rᵢ."""

    def fn(ctx, action):
        total = ctx.sim.q.new_ones(_batch(ctx))
        for r in parts:
            total = total * r(ctx, action)
        return total

    return fn


# ---- terminations


def quantity_termination(quantity: Callable[[QuantityContext], torch.Tensor], low=None,
                         high=None) -> TerminationFn:
    """Terminate where any component of a quantity leaves [low, high]."""

    def fn(ctx) -> torch.Tensor:
        val = quantity(ctx).reshape(_batch(ctx), -1)
        bad = torch.zeros(val.shape[0], dtype=torch.bool, device=val.device)
        if low is not None:
            bad = bad | torch.any(val < low, dim=-1)
        if high is not None:
            bad = bad | torch.any(val > high, dim=-1)
        return bad

    return fn


def base_height_termination(min_height: float) -> TerminationFn:
    """Terminate where the base is below ``min_height`` above the ground
    under it (the context's ground)."""
    return quantity_termination(lambda ctx: ctx.base_height_above_ground, low=min_height)


def base_tilt_termination(max_tilt_cos: float = 0.6) -> TerminationFn:
    """Terminate where the base tilts past arccos(max_tilt_cos)."""
    return quantity_termination(lambda ctx: ctx.base_tilt, low=max_tilt_cos)


def drift_termination(max_drift: float) -> TerminationFn:
    """Terminate where the planar odometry is more than ``max_drift`` m
    from the origin."""
    return quantity_termination(lambda ctx: torch.linalg.norm(ctx.odometry[:, :2], dim=-1),
                                high=max_drift)


def flying_termination(max_flight_z: float) -> TerminationFn:
    """Terminate where every contact is unloaded and the base is above
    ``max_flight_z``."""

    def fn(ctx):
        airborne = ctx.total_contact_force[:, 2] < 1e-3
        return airborne & (ctx.sim.q[:, 2] > max_flight_z)

    return fn


def mechanical_safety_termination(tree, q_margin: float = 0.0,
                                  v_limit_scale: float = 1.0) -> TerminationFn:
    """Terminate on a joint position past its limits by more than
    ``q_margin`` or a velocity past ``v_limit_scale`` times its limit."""
    q_min, q_max, v_max = tree.q_min, tree.q_max, tree.v_max

    def fn(ctx):
        q, v = ctx.sim.q, ctx.sim.v
        bad_q = torch.any((q < q_min - q_margin) | (q > q_max + q_margin), dim=-1)
        bad_v = torch.any(torch.abs(v) > v_limit_scale * v_max, dim=-1)
        return bad_q | bad_v

    return fn


def any_termination(parts: Sequence[TerminationFn]) -> TerminationFn:
    """OR of terminations."""

    def fn(ctx):
        bad = torch.zeros(_batch(ctx), dtype=torch.bool, device=ctx.sim.q.device)
        for p in parts:
            bad = bad | p(ctx)
        return bad

    return fn
