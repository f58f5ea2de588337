"""Numerical-health checks, cheapest first.

Counterpart of ``jiminy_tpu/utils/health.py``:

1. :func:`is_bad_state` / :func:`state_flags` — elementwise checks of a
   batched state, cheap enough for every step (the env's NaN guard calls
   ``is_bad_state``);
2. :func:`checkify_fn` — wrap a step so that the same checks run on every
   :class:`SimState` in its result and a failed one raises naming it (the
   reference's ``checkify`` user checks, with its messages);
3. :func:`debug_nans` — a context manager that raises at the first torch
   operation whose output holds a NaN, naming the operation (the
   reference's ``jax_debug_nans``). It runs a dispatch mode over every
   operation, so it belongs in a CPU repro, not on a hot path.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

# bits of state_flags
NONFINITE_Q = 1
NONFINITE_V = 2
VEL_EXPLOSION = 4
RESIDUAL_BLOWUP = 8


def state_flags(sim, vel_limit: float = 1e4, residual_limit: float = 1e6) -> torch.Tensor:
    """(B,) int32 bitmask of each env's violations: non-finite q or v,
    a velocity above ``vel_limit`` (explosions pass through huge finite
    velocities before NaN), a non-finite residual or one above
    ``residual_limit``."""
    bad_q = ~torch.all(torch.isfinite(sim.q), dim=-1)
    bad_v = ~torch.all(torch.isfinite(sim.v), dim=-1)
    huge_v = torch.any(torch.abs(sim.v) > vel_limit, dim=-1)
    res = sim.solver_residual
    bad_res = ~torch.isfinite(res) | (res > residual_limit)
    flags = torch.zeros_like(bad_q, dtype=torch.int32)
    for bit, bad in ((NONFINITE_Q, bad_q), (NONFINITE_V, bad_v), (VEL_EXPLOSION, huge_v),
                     (RESIDUAL_BLOWUP, bad_res)):
        flags = flags | (bad.to(torch.int32) * bit)
    return flags


def is_bad_state(sim, vel_limit: float = 1e4, residual_limit: float = 1e6):
    """(B,) bool: any flag of :func:`state_flags` set."""
    return state_flags(sim, vel_limit, residual_limit) != 0


def _sim_states(x, where: str):
    """(path, SimState) of every SimState inside ``x`` (dataclasses,
    dicts, lists and tuples walked), paths written as the reference's
    ``keystr``."""
    from jiminy_tpu_torch.engine.engine import SimState

    if isinstance(x, SimState):
        yield where, x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _sim_states(getattr(x, f.name), f"{where}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _sim_states(v, f"{where}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _sim_states(v, f"{where}[{i}]")


def checkify_fn(fn, vel_limit: float = 1e4):
    """``fn`` wrapped so that every SimState in its result is checked
    after the call: non-finite q, non-finite v, or |v| above
    ``vel_limit``. A failed check raises ValueError with the reference's
    message (``"non-finite q at <path>"``, ``"velocity explosion
    (>|limit|) at <path>"``); the checks read the device once."""

    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        checks = []
        for path, st in _sim_states(out, ""):
            where = path or "<result>"
            checks += [
                (torch.all(torch.isfinite(st.q)), f"non-finite q at {where}"),
                (torch.all(torch.isfinite(st.v)), f"non-finite v at {where}"),
                (torch.all(torch.abs(st.v) <= vel_limit),
                 f"velocity explosion (>|{vel_limit}|) at {where}"),
            ]
        if checks:
            ok = torch.stack([c for c, _ in checks]).cpu().tolist()
            for good, (_, msg) in zip(ok, checks):
                if not good:
                    raise ValueError(msg)
        return out

    return checked


class _NanMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises at the first operation whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(o) and o.is_floating_point() and bool(torch.isnan(o).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, any torch operation that outputs a NaN raises
    FloatingPointError naming the operation (``aten.<op>``)."""
    if not enable:
        yield
        return
    with _NanMode():
        yield
