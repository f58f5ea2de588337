"""The simulation engine: advances a batch of (t, q, v) states.

Counterpart of ``jiminy_tpu/engine/engine.py`` for the slice's
configuration: the impulse path (contacts and joint bounds as rows of a
PGS velocity-level solve fused with a semi-implicit Euler step), a
declarative :class:`PDController` or a direct motor command, and an
optional (6,) local wrench on the root body held over the step.

The ground is flat, a heightmap, or an analytic ground (Fourier, Perlin,
Stairs; :mod:`jiminy_tpu_torch.engine.ground`), which ``step`` and
``step_with_sensors`` also take per env (``ground=``, a ground of the
engine's own kind with a (B,) batch): the whole-substep kernels query it
in-kernel from its coefficients. A heightmap is outside their scope, so
``"auto"`` resolves to ``"kernel"`` for it.

The substep's physics has three backends, selected by
``EngineOptions.constraint_solver``:

- ``"substep"``: the whole-substep CUDA kernels of
  :mod:`jiminy_tpu_torch.ops.substep_kernel` (the reference's
  ``"pallas_substep"``): with ``substep_fusion`` and a declarative torque
  path, all substeps of a step in one launch (K2), else one launch per
  substep with τ computed outside (K3); on the CPU their plain versions;
- ``"kernel"``: plain PyTorch physics around the chain kernel
  :func:`jiminy_tpu_torch.ops.solve_batched` (K1; the reference's
  ``"pallas"``);
- ``"inline"``: plain PyTorch physics with the plain chain (the
  reference's ``"xla"``), so the same physics runs with no kernel;
- ``"auto"`` (the default): ``"substep"`` when the model is within the
  whole-substep kernels' caps (nb ≤ 32, nv ≤ 32, nc ≤ 96, ≤ 24 pair
  contacts, ≤ 16 PGS colors, no kinematic constraint but distance ones:
  every model the port builds, Atlas with its self-collision pairs at nc
  83 included), else ``"kernel"`` when it is
  within the chain kernel's (nv ≤ 32, nc ≤ 96). Beyond both, ``"inline"``
  on the CPU (where every backend runs the plain versions), and on CUDA a
  ValueError: the plain physics runs on the card only when ``"inline"``
  is asked for.
  ``Engine.backend`` is the choice.

Every backend runs the same substep: :func:`substep_reference` is the
plain one, and the kernels are held against it.

The inputs decide the route, as in the reference, and never a failure:
per-body external wrenches (``step(..., fext_user=)``) and per-env
contact parameters (``contact_params=``, a
:class:`~jiminy_tpu_torch.engine.contact.ContactParams` whose friction
may be a (B,) tensor) keep a step off the whole-substep kernels, so on
any backend such a step runs the per-substep loop of the plain substep:
around the chain kernel K1 on ``"substep"`` and ``"kernel"``, around the
plain chain on ``"inline"``. So do kinematic constraints other than
distance ones, through ``"auto"`` resolving to ``"kernel"``.

:meth:`Engine.step_with_sensors` is the fused step with the sensor
stage (the reference's ``step_with_sensors``): on the ``"substep"``
backend with fusion, one K2 launch advances every substep and pushes a
sensor update into the delay lines every ``k_obs`` substeps;
:meth:`Engine.sensor_fusion_ready` says whether a suite and schedule can
take it.

Both steps take per-env model randomization (``model_params=``, each
env's packed row (B, n_mp) that :meth:`Engine._pack_model_params` makes
once from an :class:`~jiminy_tpu_torch.engine.randomization.ModelParams`
with a (B,) batch): it rides the randomized instantiations of the
whole-substep kernels (K2 with τ scaled in-kernel; K3 with τ from the
scaled motors), and the plain physics of ``"kernel"`` and ``"inline"``
reads the same rows.

Collision: contact sites may be spheres (the tree's ``contact_radius``),
and ``collision_pairs`` (:class:`~jiminy_tpu_torch.engine.collision.CollisionPair`:
spheres, capsules, boxes, convex meshes on two bodies) add a [t1, t2, n]
block per pair contact after the ground contacts, each pair one PGS
color, on every backend (the reference's ``pair_rows``); they need
``contact_model="constraint"``. As the reference gates its in-kernel
assembly, more than 24 pair contacts keep a model off the whole-substep
kernels.

Kinematic constraints: ``constraints`` (any of
:mod:`jiminy_tpu_torch.engine.constraints`' frame, joint, distance,
sphere and wheel constraints) are equality rows of every substep, one
block each, stacked ahead of the joint bounds and contacts, on every
backend; the sphere and wheel rows roll on the step's ground. Only
distance constraints (closed loops such as Cassie's pushrods) ride the
whole-substep kernels, as in the reference: ``"substep"`` with any other
raises at ``Engine(...)``. Joint springs (the tree's ``stiffness``: −k·q
on 1-DoF joints, −k·log(quat) on the SPHERICAL flexibility joints) are
part of the actuation torque and integrate implicitly with the joint
damping.

Contacts run as PGS rows: ``EngineOptions.contact_model`` defaults to the
reference's ``"spring_damper"``, which the engine refuses. Not ported
yet (each raises): penalty contacts and other steppers (ROADMAP A.16);
so the stiffness and damping of ``ContactParams`` stay unread.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.engine.collision import CollisionPairSet
from jiminy_tpu_torch.engine.contact import ContactParams
from jiminy_tpu_torch.engine.ground import FlatGround, FourierGround, PerlinGround, StairsGround
from jiminy_tpu_torch.hardware.motors import Motors

# modules, not their names: ops.constraint_solve imports the engine's PGS
# solver, so either package may be the one still importing
from jiminy_tpu_torch.ops import constraint_solve as chain_ops
from jiminy_tpu_torch.ops import substep_kernel as substep_ops


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
    (same names and defaults, so ``contact_model="constraint"`` is asked
    for, as the walker envs do; of ``constraint_solver``, the port's
    ``"substep"``, ``"kernel"`` and ``"inline"`` are the reference's
    ``"pallas_substep"``, ``"pallas"`` and ``"xla"``). Joint bounds always
    run as PGS rows, the reference's choice on the impulse path."""

    solver: str = "euler_symplectic"
    dt: float = 1e-3
    contacts: ContactParams = dataclasses.field(default_factory=ContactParams)
    # "spring_damper" (penalty contacts, ROADMAP A.16: Engine refuses it)
    # or "constraint" (contacts as PGS rows), the reference's default first
    contact_model: str = "spring_damper"
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
    constraint_solver: str = "auto"  # "auto" | "substep" | "kernel" | "inline"
    bounds_baumgarte_freq: float = 20.0
    compute_solver_residual: bool = True
    # with constraint_solver="substep" and a declarative torque path (PD
    # or direct motor command): all substeps of a step() in one launch
    substep_fusion: bool = True


class PDController:
    """Declarative inner-loop PD: motor command = kp·(target − q_motor)
    − kd·v_motor at every substep against the held env action (evaluated
    by :func:`~jiminy_tpu_torch.ops.substep_kernel.torque_reference` and
    in-kernel by K2)."""

    def __init__(self, kp, kd):
        self.kp = kp
        self.kd = kd


class Engine:
    """Pure step function of one robot model, batched over envs.

    ``controller`` is None (the command goes to the motors, or is the
    joint torque when there are none), a :class:`PDController`, or any
    ``fn(cmd, q, v) → motor command``. The first two are declarative, so
    the fused kernel can evaluate them in-kernel. ``constraints``: the
    kinematic constraints of the model (frame, joint, distance, sphere
    and wheel constraints; e.g. Cassie's pushrods), rows of every
    substep's solve.
    ``collision_pairs``: declared body-body pairs
    (:class:`~jiminy_tpu_torch.engine.collision.CollisionPair`), contact
    rows of every substep's solve."""

    def __init__(
        self,
        tree: KinematicTree,
        options: EngineOptions | None = None,
        ground=None,
        motors: Motors | None = None,
        controller=None,
        constraints=(),
        collision_pairs=(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.tree = tree.to(device=self.device)
        self.options = opts = options or EngineOptions()
        self.ground = (ground if ground is not None else FlatGround()).to(
            device=self.device, dtype=self.tree.dtype
        )
        self.motors = motors.to(device=self.device) if motors is not None else None
        if opts.constraint_solver not in ("auto", "substep", "kernel", "inline"):
            raise ValueError(f"unknown constraint_solver {opts.constraint_solver!r}")
        self.collision_pairs = tuple(collision_pairs)
        if self.collision_pairs and opts.contact_model != "constraint":
            raise ValueError("collision_pairs require contact_model='constraint' "
                             "(pair impulses resolve in the PGS)")
        torque = None
        if isinstance(controller, PDController):
            if motors is None:
                raise ValueError("PDController requires motors")
            torque = substep_ops.TorqueSpec.from_motors(self.motors, controller.kp, controller.kd)
            controller = None  # declarative: spec.torque evaluates it
        elif controller is None and self.motors is not None:
            torque = substep_ops.TorqueSpec.from_motors(self.motors)
        self.controller = controller
        self.constraints = tuple(constraints)
        # the static substep: row layout, solve configuration, constants
        self.substep_spec = spec = substep_ops.SubstepSpec(
            self.tree, opts, self.ground, motors=self.motors, torque=torque,
            constraints=self.constraints,
            pairs=CollisionPairSet(self.tree, self.collision_pairs, float(opts.contacts.friction))
            if self.collision_pairs else None,
        )
        self.nc = spec.nc
        self.backend = opts.constraint_solver
        if self.backend == "substep":
            # as the reference's explicit "pallas_substep" request, a model
            # outside the kernels' scope fails here, not at the first step
            spec.check_kernel_caps("constraint_solver='substep'")
        elif self.backend == "auto":
            self.backend = self.auto_backend(spec, self.device)
        self._sensor_specs: dict = {}

    @staticmethod
    def auto_backend(spec: substep_ops.SubstepSpec, device: torch.device) -> str:
        """What ``"auto"`` resolves to for ``spec`` on ``device``: the
        whole-substep kernels, else the chain kernel; beyond both
        ``"inline"`` on the CPU, and a ValueError on CUDA."""
        try:
            spec.check_kernel_caps("constraint_solver='auto'")
            return "substep"
        except ValueError as e:
            if chain_ops.kernel_takes(spec.cfg):
                return "kernel"
            if device.type == "cpu":  # where every backend runs the plain versions
                return "inline"
            raise ValueError(
                f"{e}; nor does the chain kernel take it (nv ≤ {chain_ops.MAX_N}, nc ≤ "
                f"{chain_ops.MAX_NC}, ≤ {chain_ops.MAX_EQ} equality blocks, ≤ "
                f"{chain_ops.MAX_COLORS} colors); pass constraint_solver='inline' to run "
                "the plain physics on the card"
            ) from e

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

    def _joint_torque(self, u, q, v, mscale=None):
        """Command → actuation torque: inner-loop controller, motor
        model, joint damping, 1-DoF joint springs (−k·q). ``mscale``:
        each env's motor (gain, friction scale), (B, nm) each, or None."""
        if self.substep_spec.torque is not None:  # declarative: PD or direct
            return substep_ops.torque_reference(self.substep_spec, q, v, u, mscale)
        if self.controller is not None:
            u = self.controller(u, q, v)
        tau = self.motors.compute_effort(u, v, mscale) if self.motors is not None else u
        return substep_ops.with_springs(self.tree, q, tau - self.tree.damping * v)

    def _pack_model_params(self, model_params):
        """Each env's packed model parameters (B, n_mp) in the tree's
        dtype, the form ``step``'s ``model_params`` takes (the reference's
        ``_pack_model_params``, row by row): the perturbed mass ‖ h ‖
        origin inertia xx, yy, zz, xy, xz, yz ‖ armature
        (``ModelParams.apply_to_tree``) ‖ with a torque path the motor
        gain ‖ friction scale."""
        mp = model_params.to(device=self.device, dtype=self.tree.dtype)
        dyn = mp.apply_to_tree(self.tree)
        I, B = dyn.inertia, mp.batch_size
        i6 = torch.stack([I[..., 0, 0], I[..., 1, 1], I[..., 2, 2],
                          I[..., 0, 1], I[..., 0, 2], I[..., 1, 2]], dim=-1)
        parts = [dyn.mass, dyn.h.reshape(B, -1), i6.reshape(B, -1), dyn.armature]
        if self.substep_spec.torque is not None:
            parts += [mp.motor_gain, mp.motor_friction_scale]
        return torch.cat(parts, dim=1).contiguous()

    def _kernel_ground_ok(self, ground) -> bool:
        """Can the engine's substep take ``ground``? An analytic ground of
        the engine's own kind (the same Fourier term count, the same
        Perlin octaves), shared or one per env, rides the coefficient
        input; a flat or heightmap ground must be the engine's own."""
        own = self.ground
        if isinstance(own, FourierGround):
            return isinstance(ground, FourierGround) and ground.n_terms == own.n_terms
        if isinstance(own, PerlinGround):
            return isinstance(ground, PerlinGround) and ground.octaves == own.octaves
        if isinstance(own, StairsGround):
            return isinstance(ground, StairsGround)
        return ground is own

    def _ground_coef(self, ground, batch_size: int):
        """The coefficient rows (B, n_gc) that the substep reads for
        ``ground`` (None: the engine's own), or None on a flat or
        heightmap ground. Raises ValueError for a ground the engine cannot
        take (:meth:`_kernel_ground_ok`); nothing falls back to another
        path."""
        ground = ground if ground is not None else self.ground
        if not self._kernel_ground_ok(ground):
            raise ValueError(
                f"a {type(ground).__name__} is outside this engine's substep (built for "
                f"a {type(self.ground).__name__}); pass a ground of the engine's own kind"
            )
        if self.substep_spec.n_gc == 0:
            return None
        gc = ground.coef().to(device=self.device, dtype=self.tree.dtype)
        if gc.dim() == 1:
            gc = gc.expand(batch_size, -1)
        if tuple(gc.shape) != (batch_size, self.substep_spec.n_gc):
            raise ValueError(f"ground coefficients {tuple(gc.shape)} for a batch of {batch_size}")
        return gc.contiguous()

    def _solve_chain_kernel(self, cfg, *args):
        return chain_ops.solve_batched(
            cfg, *(a.contiguous() for a in args), device=self.device
        )

    def _impulse_substep(self, q, v, u, lam0, wrench, gc, mp=None, fext=None, friction=None):
        """One semi-implicit Euler substep with velocity-level PGS impulses
        for kinematic constraints, joint bounds, ground contacts and
        collision pairs (``gc``: the per-env ground
        coefficients or None; ``mp``: the per-env packed model parameters
        or None; ``fext``: per-body wrenches or None; ``friction``: the
        ground friction per env or None). K3 on ``"substep"`` unless
        ``fext`` or ``friction`` is given; then, and on ``"kernel"``, the
        plain substep around K1; on ``"inline"`` the plain substep.
        Returns (q⁺, v⁺, contact_forces, residual, λ, a, τ)."""
        spec, dt = self.substep_spec, self.substep_spec.dt
        mscale = substep_ops.unpack_model_params(spec, mp)[1] if mp is not None else None
        tau = self._joint_torque(u, q, v, mscale)
        backend = self.backend
        if backend == "substep" and fext is None and friction is None:
            out = substep_ops.substep_batched(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
        else:
            solve = None if backend == "inline" else self._solve_chain_kernel
            out = substep_ops.substep_reference(
                spec, q, v, tau, lam0, wrench, solve=solve, gc=gc, mp=mp, fext=fext,
                friction=friction,
            )
        q_next, v_next, lam, residual, impulse = out
        return q_next, v_next, impulse / dt, residual, lam, (v_next - v) / dt, tau

    # -- the fused path with the sensor stage ------------------------------
    def _sensor_spec(self, suite, k_obs: int):
        """The suite described for K2's sensor stage, built once per
        (suite, k_obs); the entry holds the suite itself, so a new suite
        at a reused address cannot hit a stale one."""
        key = (id(suite), int(k_obs))
        hit = self._sensor_specs.get(key)
        if hit is None or hit[0] is not suite:
            hit = (suite, substep_ops.SensorKernelSpec(self.tree, suite, k_obs))
            self._sensor_specs[key] = hit
        return hit[1]

    def sensor_fusion_ready(self, suite, n_substeps: int, k_obs: int, ground=None) -> bool:
        """Can :meth:`step_with_sensors` serve this suite at this
        schedule on ``ground`` (None: the engine's own)? Needs the fused
        whole-substep path (``"substep"`` backend, ``substep_fusion``, a
        declarative torque path), k_obs dividing n_substeps, a ground the
        kernel takes (:meth:`_kernel_ground_ok`), sensor types the kernel
        takes (not ``force``) and the sensor stage's caps."""
        if not (
            self.backend == "substep"
            and self.options.substep_fusion
            and self.substep_spec.torque is not None
            and k_obs >= 1
            and n_substeps % k_obs == 0
            and self._kernel_ground_ok(ground if ground is not None else self.ground)
        ):
            return False
        try:
            self._sensor_spec(suite, k_obs).check_kernel_caps("sensor_fusion_ready")
        except ValueError:
            return False
        return True

    def step_with_sensors(
        self, state: SimState, u: torch.Tensor, n_substeps: int, suite,
        bufs: torch.Tensor, eps: torch.Tensor, k_obs: int = 1,
        base_wrench: torch.Tensor | None = None, ground=None, model_params=None,
    ) -> tuple[SimState, torch.Tensor]:
        """The fused step with the sensor stage: every substep and a
        sensor update (measure at the accepted state, corrupt, push)
        every ``k_obs`` substeps in one K2 launch. ``bufs`` (B, n_buf) are
        the suite's flattened ring buffers, ``eps`` (B, n_substeps/k_obs ·
        n_eps) the pre-sampled corruption, update after update; ``ground``
        and ``model_params`` as in :meth:`step`. Raises ValueError when
        :meth:`sensor_fusion_ready` is False. Returns (SimState, new
        bufs)."""
        if not self.sensor_fusion_ready(suite, n_substeps, k_obs, ground):
            raise ValueError("this suite, schedule and ground cannot take the fused sensor path")
        spec, dt = self.substep_spec, self.substep_spec.dt
        B = state.q.shape[0]
        wrench = base_wrench if base_wrench is not None else state.q.new_zeros(B, 6)
        q, v, lam, res, impulse, a, tau, bufs = substep_ops.substep_batched_multi(
            spec, n_substeps, state.q, state.v, u, state.lam, wrench,
            sensors=self._sensor_spec(suite, k_obs), bufs=bufs, eps=eps,
            gc=self._ground_coef(ground, B), mp=model_params,
        )
        sim = SimState(
            t=state.t + n_substeps * dt, q=q, v=v, contact_forces=impulse / dt,
            solver_residual=res, lam=lam, a=a, tau=tau,
        )
        return sim, bufs

    def _friction(self, contact_params, batch_size: int):
        """The ground friction that ``contact_params`` sets: None for None,
        else a float or each env's (B,) tensor on the engine's device."""
        if contact_params is None:
            return None
        mu = contact_params.friction
        if not torch.is_tensor(mu):
            return float(mu)
        mu = mu.to(device=self.device, dtype=self.tree.dtype)
        if mu.dim() > 1 or mu.numel() not in (1, batch_size):
            raise ValueError(f"contact_params.friction of shape {tuple(mu.shape)} for a batch of "
                             f"{batch_size}: a float or one per env")
        return mu

    def _fext(self, fext_user, batch_size: int):
        """``fext_user`` (B, nb, 6) or (nb, 6) on the engine's device, or
        None."""
        if fext_user is None:
            return None
        f = fext_user.to(device=self.device, dtype=self.tree.dtype)
        nb = self.tree.nb
        if tuple(f.shape) not in ((nb, 6), (batch_size, nb, 6)):
            raise ValueError(f"fext_user of shape {tuple(f.shape)}: expected ({nb}, 6) or "
                             f"({batch_size}, {nb}, 6)")
        return f

    def step(
        self, state: SimState, u: torch.Tensor, n_substeps: int = 1,
        base_wrench: torch.Tensor | None = None, ground=None, model_params=None,
        fext_user: torch.Tensor | None = None, contact_params: ContactParams | None = None,
    ) -> SimState:
        """Advance by ``n_substeps × dt`` with the zero-order-hold command
        ``u`` (B, nm). ``base_wrench``: optional (B, 6) local [ang; lin]
        spatial wrench on the root body held over the step (push
        disturbances). ``ground``: optional ground of the engine's own
        kind, an analytic one with a (B,) batch for per-env terrain
        (None: the engine's ground); anything else raises ValueError.
        ``model_params``: optional (B, n_mp) packed rows
        (:meth:`_pack_model_params`) perturbing each env's inertials,
        armature and motors. ``fext_user``: optional (B, nb, 6) or (nb,
        6) local [ang; lin] wrenches on every body held over the step,
        added to ``base_wrench``. ``contact_params``: optional
        :class:`ContactParams` whose ``friction`` (a float or each env's
        (B,) tensor) replaces the options' on the ground contacts (the
        collision pairs keep theirs). Either of the last two keeps the
        step off the whole-substep kernels, as in the reference: every
        backend then runs the plain substep per substep, around the chain
        kernel K1 on ``"substep"`` and ``"kernel"``."""
        spec, dt = self.substep_spec, self.substep_spec.dt
        q, v, t, lam = state.q, state.v, state.t, state.lam
        wrench = base_wrench
        B = q.shape[0]
        gc = self._ground_coef(ground, B)
        mp = model_params
        substep_ops._check_mp("Engine.step", spec, mp, B)
        fext, friction = self._fext(fext_user, B), self._friction(contact_params, B)
        plain = fext is not None or friction is not None
        if self.backend == "substep" and not plain:
            if wrench is None:  # the kernels always take one
                wrench = q.new_zeros(q.shape[0], 6)
            if self.options.substep_fusion and spec.torque is not None:
                q, v, lam, res, impulse, a, tau = substep_ops.substep_batched_multi(
                    spec, n_substeps, q, v, u, lam, wrench, gc=gc, mp=mp
                )
                return SimState(
                    t=t + n_substeps * dt, q=q, v=v, contact_forces=impulse / dt,
                    solver_residual=res, lam=lam, a=a, tau=tau,
                )
        f_c, res, a, tau = state.contact_forces, state.solver_residual, state.a, state.tau
        for _ in range(n_substeps):
            q, v, f_c, res, lam, a, tau = self._impulse_substep(q, v, u, lam, wrench, gc, mp,
                                                                fext, friction)
            t = t + dt
        return SimState(
            t=t, q=q, v=v, contact_forces=f_c, solver_residual=res,
            lam=lam, a=a, tau=tau,
        )
