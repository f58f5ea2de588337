"""ODE steppers on the configuration manifold, batched.

Counterpart of ``jiminy_tpu/engine/steppers.py``: symplectic Euler (the
reference's ``euler_explicit`` semantics, velocity first), classic RK4
with its position stages as tangent increments applied through
``integrate``, one DOPRI-5(4) step with its embedded error, and
:func:`integrate_adaptive`, the adaptive DOPRI stepper with the PI
step-size controller. Each takes ``dyn(q, v, t) → a`` on a batch: q (B,
nq), v (B, nv), t (B,).

The engine's continuous-force path (penalty contacts, no kinematic
constraint) runs a stepper of :data:`STEPPERS` per substep; the impulse
path is symplectic Euler fused with the velocity-level solve.
"""

from __future__ import annotations

from typing import Callable

import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree

DynFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def euler_semi_implicit(tree: KinematicTree, dyn: DynFn, q, v, t, dt):
    """Symplectic Euler: v ← v + a·dt, then q ← q ⊕ v·dt."""
    v_next = v + dyn(q, v, t) * dt
    return algos.integrate(tree, q, v_next, dt), v_next


def runge_kutta_4(tree: KinematicTree, dyn: DynFn, q, v, t, dt):
    """Classic RK4 on the manifold: each position stage is a tangent
    increment applied to the base configuration through ``integrate``."""
    half = 0.5 * dt
    k1q = v
    k1v = dyn(q, v, t)
    q2 = algos.integrate(tree, q, k1q, half)
    k2q = v + half * k1v
    k2v = dyn(q2, k2q, t + half)
    q3 = algos.integrate(tree, q, k2q, half)
    k3q = v + half * k2v
    k3v = dyn(q3, k3q, t + half)
    q4 = algos.integrate(tree, q, k3q, dt)
    k4q = v + dt * k3v
    k4v = dyn(q4, k4q, t + dt)
    dq = (k1q + 2.0 * k2q + 2.0 * k3q + k4q) / 6.0
    dv = (k1v + 2.0 * k2v + 2.0 * k3v + k4v) / 6.0
    return algos.integrate(tree, q, dq, dt), v + dt * dv


# Dormand-Prince 5(4), the reference's tableau (boost-odeint's dopri5)
_DOPRI_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def runge_kutta_dopri5(tree: KinematicTree, dyn: DynFn, q, v, t, dt):
    """One DOPRI-5 step of ``dt`` (a float or each env's (B,)) → (q⁺, v⁺,
    each env's error (B,)): the largest |5th − 4th order| increment of
    q's tangent or of v, times dt."""
    dt_c = dt[:, None] if torch.is_tensor(dt) else dt
    kq, kv = [], []
    for s in range(7):
        dq_s = sum((a * k for a, k in zip(_DOPRI_A[s], kq)), torch.zeros_like(v))
        dv_s = sum((a * k for a, k in zip(_DOPRI_A[s], kv)), torch.zeros_like(v))
        v_s = v + dt_c * dv_s
        kq.append(v_s)
        kv.append(dyn(algos.integrate(tree, q, dq_s, dt_c), v_s, t + _DOPRI_C[s] * dt))
    dq5 = sum(b * k for b, k in zip(_DOPRI_B5, kq))
    dv5 = sum(b * k for b, k in zip(_DOPRI_B5, kv))
    dq4 = sum(b * k for b, k in zip(_DOPRI_B4, kq))
    dv4 = sum(b * k for b, k in zip(_DOPRI_B4, kv))
    err = torch.maximum(torch.amax(torch.abs(dq5 - dq4), dim=-1) * dt,
                        torch.amax(torch.abs(dv5 - dv4), dim=-1) * dt)
    return algos.integrate(tree, q, dq5, dt_c), v + dt_c * dv5, err


def integrate_adaptive(tree: KinematicTree, dyn: DynFn, q, v, t0, t_end, dt_init=1e-3,
                       dt_max=0.02, dt_min=1e-7, tol_abs=1e-8, tol_rel=1e-6,
                       max_steps=100_000):
    """Adaptive DOPRI-5(4) to ``t_end`` with the reference's PI controller
    (dt' = dt·0.9·ratio^−0.14·err_prev^0.08, the factor clamped to [0.2,
    5], dt' to [dt_min, dt_max]; a step is accepted when its error is
    within tol_abs + tol_rel·max(|v|, |v⁺|, 1)). One trajectory: q (1, nq),
    v (1, nv); the step count depends on the data, so the loop reads its
    condition on the host once per iteration. Returns (t (1,), q, v,
    {"accepted", "rejected", "iters"}), the reference's counters."""
    if q.shape[0] != 1:
        raise ValueError(f"integrate_adaptive integrates one trajectory, got a batch of "
                         f"{q.shape[0]}")
    k_i, k_p, safety = 0.7 / 5.0, 0.4 / 5.0, 0.9
    kw = dict(dtype=q.dtype, device=q.device)
    t = torch.as_tensor(t0, **kw).reshape(1)
    t_end = torch.as_tensor(t_end, **kw).reshape(1)
    dt = torch.full((1,), dt_init, **kw)
    err_prev = torch.ones(1, **kw)
    n_acc = torch.zeros(1, dtype=torch.int32, device=q.device)
    n_rej = torch.zeros_like(n_acc)
    n = 0
    while n < max_steps and bool(t < t_end):
        dt = torch.minimum(dt, t_end - t)
        q2, v2, err = runge_kutta_dopri5(tree, dyn, q, v, t, dt)
        m = torch.maximum(torch.amax(torch.abs(v), dim=-1),
                          torch.clamp_min(torch.amax(torch.abs(v2), dim=-1), 1.0))
        ratio = err / (tol_abs + tol_rel * m)
        accept = ratio <= 1.0
        fac = safety * torch.pow(torch.clamp_min(ratio, 1e-10), -k_i) * torch.pow(
            torch.clamp_min(err_prev, 1e-10), k_p)
        dt_next = torch.clamp(dt * torch.clamp(fac, 0.2, 5.0), dt_min, dt_max)
        t = torch.where(accept, t + dt, t)
        q = torch.where(accept[:, None], q2, q)
        v = torch.where(accept[:, None], v2, v)
        err_prev = torch.where(accept, torch.clamp_min(ratio, 1e-10), err_prev)
        n_acc = n_acc + accept.to(torch.int32)
        n_rej = n_rej + (~accept).to(torch.int32)
        dt = dt_next
        n += 1
    return t, q, v, {"accepted": int(n_acc), "rejected": int(n_rej), "iters": n}


STEPPERS = {
    "euler_symplectic": euler_semi_implicit,
    "euler_explicit": euler_semi_implicit,  # the reference's option name
    "runge_kutta_4": runge_kutta_4,
}
