"""The simulation engine: advances a batch of (t, q, v) states.

Counterpart of ``jiminy_tpu/engine/engine.py`` for the slice's
configuration: the impulse path (contacts and joint bounds as rows of a
PGS velocity-level solve fused with a semi-implicit Euler step), flat
ground, a declarative :class:`PDController` evaluated at every substep
against the zero-order-hold command, and no whole-substep kernel.

The dense solve chain of each substep has two backends, selected by
``EngineOptions.constraint_solver``:

- ``"kernel"`` (default): :func:`jiminy_tpu_torch.ops.solve_batched`,
  which launches the CUDA kernel on the card and runs its plain version
  on the CPU (the reference's ``"pallas"`` branch);
- ``"inline"``: the chain written inline in PyTorch (the reference's
  ``"xla"`` branch), so the same physics runs with no kernel.

Not ported yet (each raises): penalty contacts and other steppers
(ROADMAP A.16), kinematic constraints and collision pairs (A.12, A.13),
flexibility and joint springs (A.14), model randomization (A.11), other
grounds (A.10), the whole-substep kernel (B2/B3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import JointType, KinematicTree
from jiminy_tpu_torch.engine import constraints as cstr
from jiminy_tpu_torch.engine.contact import ContactParams, surface_contacts
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.engine.solver import pgs_solve_grouped
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.math import linalg
from jiminy_tpu_torch.ops.constraint_solve import SolveConfig, solve_batched


@dataclasses.dataclass
class SimState:
    """Batched simulation state (the reference's SimState with the batch
    written out)."""

    t: torch.Tensor  # (B,)
    q: torch.Tensor  # (B, nq)
    v: torch.Tensor  # (B, nv)
    contact_forces: torch.Tensor  # (B, ncp, 3) world frame, last substep
    solver_residual: torch.Tensor  # (B,)
    lam: torch.Tensor  # (B, nc) impulses of the last substep (warm start)
    a: torch.Tensor  # (B, nv) accepted acceleration of the last substep
    tau: torch.Tensor  # (B, nv) actuation torque of the last substep

    FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")


def sim_state_from_arrays(d: dict, device="cuda", dtype=torch.float32) -> SimState:
    """SimState from the reference's batched fields as numpy arrays."""
    dev = resolve_device(device)
    return SimState(
        **{k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=dev)
           for k in SimState.FIELDS}
    )


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The subset of the reference's EngineOptions that the slice reads
    (same names and defaults, except ``constraint_solver``). Joint bounds
    always run as PGS rows, the reference's choice on the impulse path."""

    solver: str = "euler_symplectic"
    dt: float = 1e-3
    contacts: ContactParams = dataclasses.field(default_factory=ContactParams)
    contact_model: str = "constraint"
    pgs_iters: int = 16
    pgs_relax: float = 1.0
    pgs_reg: float = 1e-6
    contact_baumgarte_freq: float = 20.0
    contact_max_correction_vel: float = 0.2
    contact_slop: float = 1e-3
    # rows activate at depth > −margin with a velocity-barrier target
    # depth/dt (the point may approach the surface this substep but not
    # cross it) instead of a hard depth > 0 flip: continuous activation,
    # so f32 noise between backends near grazing contact cannot flip the
    # active set
    contact_margin: float = 5e-3
    constraint_solver: str = "kernel"  # "kernel" | "inline"
    bounds_baumgarte_freq: float = 20.0
    compute_solver_residual: bool = True


class PDController:
    """Declarative inner-loop PD: motor command = kp·(target − q_motor)
    − kd·v_motor at every substep against the held env action."""

    def __init__(self, kp, kd):
        self.kp = kp
        self.kd = kd

    def bind(self, motors: Motors):
        kp, kd = self.kp, self.kd

        def fn(cmd, q, v):
            qm, vm = motors.joint_state(q, v)
            return kp * (cmd - qm) - kd * vm

        return fn


class Engine:
    """Pure step function of one robot model, batched over envs."""

    def __init__(
        self,
        tree: KinematicTree,
        options: EngineOptions | None = None,
        ground=None,
        motors: Motors | None = None,
        controller=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.tree = tree.to(device=self.device)
        self.options = opts = options or EngineOptions()
        self.ground = ground if ground is not None else FlatGround()
        self.motors = motors.to(device=self.device) if motors is not None else None
        if opts.solver != "euler_symplectic":
            raise NotImplementedError(
                f"stepper {opts.solver!r} is not ported yet (ROADMAP A.16)"
            )
        if opts.contact_model != "constraint":
            raise NotImplementedError(
                "only contact_model='constraint' is ported (ROADMAP A.16)"
            )
        if opts.constraint_solver not in ("kernel", "inline"):
            raise ValueError(f"unknown constraint_solver {opts.constraint_solver!r}")
        if not isinstance(self.ground, FlatGround):
            raise NotImplementedError("only FlatGround is ported (ROADMAP A.10)")
        t = self.tree
        if t.ncp and bool(torch.any(t.contact_radius > 0)):
            raise NotImplementedError(
                "sphere/capsule contact sites are not ported yet (ROADMAP A.13)"
            )
        if bool(torch.any(t.stiffness != 0)):
            raise NotImplementedError(
                "joint springs / flexibility are not ported yet (ROADMAP A.14)"
            )
        if isinstance(controller, PDController):
            if motors is None:
                raise ValueError("PDController requires motors")
            controller = controller.bind(self.motors)
        self.controller = controller

        # static row layout: [bounds | contacts color-major]
        self.bounded_joints = self._bounded_joints()
        ncp = t.ncp
        # color-major contact order: interleaved halves (diagonal leg
        # pairs on quadrupeds), each color's rows contiguous
        self.color_order = list(range(0, ncp, 2)) + list(range(1, ncp, 2))
        inv = [0] * ncp
        for j, k in enumerate(self.color_order):
            inv[k] = j
        self.color_inverse = inv
        nb_rows = len(self.bounded_joints)
        n0 = len(range(0, ncp, 2))
        self.contact_off = nb_rows
        self.nc = nb_rows + 3 * ncp
        self.solve_config = SolveConfig(
            n=t.nv,
            nc=self.nc,
            dt=float(opts.dt),
            eq_blocks=(),
            bounds_span=(0, nb_rows) if nb_rows else None,
            contact_colors=(
                ((nb_rows, n0), (nb_rows + 3 * n0, ncp - n0)) if ncp else ()
            ),
            iters=opts.pgs_iters,
            relax=opts.pgs_relax,
            reg=opts.pgs_reg,
            compute_residual=opts.compute_solver_residual,
        )
        # float32 constants rounded as the reference's traced f32 math
        f32 = np.float32
        self._alpha_bounds = float(cstr.baumgarte_alpha(opts.bounds_baumgarte_freq, opts.dt))
        alpha_c = cstr.baumgarte_alpha(opts.contact_baumgarte_freq, opts.dt)
        self._alpha_c_over_dt = float(alpha_c / f32(opts.dt))

    def _bounded_joints(self) -> list[int]:
        """1-DoF joints with finite position limits."""
        t = self.tree
        q_min = t.q_min.cpu().numpy()
        q_max = t.q_max.cpu().numpy()
        return [
            i for i in range(t.nb)
            if t.joint_type[i] in (JointType.REVOLUTE, JointType.PRISMATIC)
            and (q_min[t.q_off[i]] > -1e5 or q_max[t.q_off[i]] < 1e5)
        ]

    def reset(self, q: torch.Tensor, v: torch.Tensor | None = None) -> SimState:
        """Fresh state at (q, v) for a batch: q (B, nq), v (B, nv)."""
        q = q.to(device=self.device)
        B, dt_ = q.shape[0], q.dtype
        t = self.tree
        z = dict(dtype=dt_, device=self.device)
        return SimState(
            t=torch.zeros(B, **z),
            q=q,
            v=torch.zeros(B, t.nv, **z) if v is None else v.to(device=self.device),
            contact_forces=torch.zeros(B, t.ncp, 3, **z),
            solver_residual=torch.zeros(B, **z),
            lam=torch.zeros(B, self.nc, **z),
            a=torch.zeros(B, t.nv, **z),
            tau=torch.zeros(B, t.nv, **z),
        )

    def _joint_torque(self, u, q, v):
        """Command → actuation torque: inner-loop controller, motor
        model, joint damping."""
        if self.controller is not None:
            u = self.controller(u, q, v)
        tau = self.motors.compute_effort(u, v) if self.motors is not None else u
        return tau - self.tree.damping * v

    def _impulse_substep(self, q, v, u, lam0):
        """One semi-implicit Euler substep with velocity-level PGS impulses
        for joint bounds and ground contacts. Returns (q⁺, v⁺,
        contact_forces, residual, λ, a, τ)."""
        tree, opts = self.tree, self.options
        dt = float(opts.dt)
        xl = algos.local_transforms(tree, q)
        xw, vel = algos.kinematics(tree, q, v, xl=xl)
        tau = self._joint_torque(u, q, v)
        # implicit joint damping: (M + dt·C)·Δv = dt·(τ − C·v − bias)
        M = algos.crba(tree, q, xl=xl) + torch.diag(dt * tree.damping)
        bias = algos.rnea(tree, q, v, torch.zeros_like(v), xl=xl)
        p_free = tau - bias

        Js, targets, actives, mus = [], [], [], []
        if self.bounded_joints:
            Jb, tb = cstr.bound_rows(tree, self.bounded_joints, q, dt, self._alpha_bounds)
            Js.append(Jb)
            targets.append(tb)
            actives.append(torch.ones_like(tb, dtype=torch.bool))
            mus.append(torch.zeros_like(tb))
        ncp = tree.ncp
        if ncp:
            pts, _, depth, n = surface_contacts(tree, xw, vel, self.ground)
            t1, t2 = cstr.tangent_basis(n)
            # penetrating: Baumgarte push-back; hovering within the
            # margin: may approach the surface but not cross it
            v_corr = torch.where(
                depth > 0.0,
                torch.clamp(
                    self._alpha_c_over_dt * (depth - opts.contact_slop),
                    0.0, opts.contact_max_correction_vel,
                ),
                depth / dt,
            )
            order = self.color_order
            Jp = torch.stack(
                [algos.point_jacobian(tree, xw, tree.contact_body[k], pts[:, k])
                 for k in order],
                dim=1,
            )  # (B, ncp, 3, nv)
            basis = torch.stack([t1, t2, n], dim=-2)[:, order]  # (B, ncp, 3, 3)
            Js.append((basis @ Jp).reshape(q.shape[0], 3 * ncp, tree.nv))
            tgt = torch.zeros_like(basis[..., 0])
            tgt[..., 2] = v_corr[:, order]
            targets.append(tgt.reshape(q.shape[0], 3 * ncp))
            act = (depth > -opts.contact_margin)[:, order]
            actives.append(act[:, :, None].expand(-1, -1, 3).reshape(q.shape[0], 3 * ncp))
            mus.append(torch.full_like(targets[-1], float(opts.contacts.friction)))

        J = torch.cat(Js, dim=1)
        target = torch.cat(targets, dim=1)
        active = torch.cat(actives, dim=1)
        mu = torch.cat(mus, dim=1)
        cfg = self.solve_config
        if opts.constraint_solver == "kernel":
            v_next, lam, residual = solve_batched(
                cfg, M.contiguous(), p_free.contiguous(), v.contiguous(),
                J.contiguous(), target.contiguous(), mu.contiguous(),
                active.to(q.dtype).contiguous(), lam0.contiguous(),
                device=self.device,
            )
        else:
            L = linalg.cholesky(M)
            a_free = linalg.cho_solve(L, p_free)
            v_free = v + dt * a_free
            MinvJT = linalg.cho_solve(L, J.transpose(-1, -2))
            A = J @ MinvJT + opts.pgs_reg * torch.eye(cfg.nc, dtype=q.dtype, device=q.device)
            rhs = target - (J @ v_free[:, :, None])[..., 0]
            lam, residual = pgs_solve_grouped(
                A, rhs, mu, active,
                eq_blocks=cfg.eq_blocks,
                bounds_span=cfg.bounds_span,
                contact_colors=cfg.contact_colors,
                iters=opts.pgs_iters,
                relax=opts.pgs_relax,
                lam0=lam0,
                compute_residual=opts.compute_solver_residual,
            )
            v_next = v_free + (MinvJT @ lam[:, :, None])[..., 0]
        q_next = algos.integrate(tree, q, v_next, dt)

        if ncp:
            off = self.contact_off
            lam_c = lam[:, off:off + 3 * ncp].reshape(-1, ncp, 3)[:, self.color_inverse]
            f_contact = (
                t1 * lam_c[..., 0:1] + t2 * lam_c[..., 1:2] + n * lam_c[..., 2:3]
            ) / dt
        else:
            f_contact = q.new_zeros(q.shape[0], 0, 3)
        return q_next, v_next, f_contact, residual, lam, (v_next - v) / dt, tau

    def step(self, state: SimState, u: torch.Tensor, n_substeps: int = 1) -> SimState:
        """Advance by ``n_substeps × dt`` with the zero-order-hold command
        ``u`` (B, nm)."""
        q, v, t, lam = state.q, state.v, state.t, state.lam
        f_c, res, a, tau = state.contact_forces, state.solver_residual, state.a, state.tau
        for _ in range(n_substeps):
            q, v, f_c, res, lam, a, tau = self._impulse_substep(q, v, u, lam)
            t = t + self.options.dt
        return SimState(
            t=t, q=q, v=v, contact_forces=f_c, solver_residual=res,
            lam=lam, a=a, tau=tau,
        )
