"""The simulation engine: advances a batch of (t, q, v) states.

Counterpart of ``jiminy_tpu/engine/engine.py``. Two paths, as in the
reference, chosen by the model:

- the **impulse path** (a kinematic constraint, or
  ``contact_model="constraint"``): contacts and joint bounds as rows of a
  PGS velocity-level solve fused with a semi-implicit Euler step;
- the **continuous path** (``contact_model="spring_damper"``, the
  reference's default, and no kinematic constraint): penalty contacts
  (:func:`~jiminy_tpu_torch.engine.contact.compute_contact_fext`) and
  penalty joint bounds as forces, :meth:`Engine.dynamics` (CRBA, RNEA and
  a Cholesky solve) integrated by the options' stepper (symplectic
  Euler, its alias ``"euler_explicit"``, or RK4;
  :mod:`jiminy_tpu_torch.engine.steppers`), and
  :meth:`Engine.simulate_adaptive`, the adaptive DOPRI stepper for one
  trajectory. It runs plain PyTorch: no solve, so no kernel.

The actuation torque (:meth:`Engine._joint_torque`) is, in the
reference's order: a declarative :class:`PDController`, a direct motor
command or any ``fn(cmd, q, v)`` controller, the motor model, joint
damping and springs, penalty bounds (``bounds_model``), and
``internal_dynamics(q, v, t)``. Registered forces (``forces=``: impulse,
profile and coupling forces of :mod:`jiminy_tpu_torch.engine.forces`),
an optional (6,) local wrench on the root body and per-body wrenches
join the bodies' ``fext`` on both paths.

The ground is flat, a heightmap, or an analytic ground (Fourier, Perlin,
Stairs; :mod:`jiminy_tpu_torch.engine.ground`), which ``step`` and
``step_with_sensors`` also take per env (``ground=``, a ground of the
engine's own kind with a (B,) batch): the whole-substep kernels query it
in-kernel from its coefficients. A heightmap is outside their scope, so
``"auto"`` resolves to ``"kernel"`` for it.

The impulse substep's physics has three backends, selected by
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
  whole-substep kernels' scope and caps (symplectic Euler, contacts and
  bounds as rows, no registered force, no kinematic constraint but
  distance ones; nb ≤ 32, nv ≤ 32, nc ≤ 96, ≤ 24 pair contacts, ≤ 16
  PGS colors: every impulse model the port builds, Atlas with its
  self-collision pairs at nc 83 included), else ``"kernel"`` when it is
  within the chain kernel's (nv ≤ 32, nc ≤ 96). Beyond both, ``"inline"``
  on the CPU (where every backend runs the plain versions), and on CUDA a
  ValueError: the plain physics runs on the card only when ``"inline"``
  is asked for. On the continuous path no solve runs, and ``"auto"`` is
  ``"inline"``. ``Engine.backend`` is the choice.

Every backend runs the same substep: :func:`substep_reference` is the
plain one, and the kernels are held against it.

The inputs decide the route, as in the reference, and never a failure:
per-body external wrenches (``step(..., fext_user=)``) and per-env
contact parameters (``contact_params=``, a
:class:`~jiminy_tpu_torch.engine.contact.ContactParams` whose fields may
be (B,) tensors) keep a step off the whole-substep kernels, so on
any backend such a step runs the per-substep loop of the plain substep:
around the chain kernel K1 on ``"substep"`` and ``"kernel"``, around the
plain chain on ``"inline"``. So do, through ``"auto"`` resolving to
``"kernel"``, kinematic constraints other than distance ones, registered
forces, penalty contacts beside kinematic constraints, and bounds not run
as constraints (``bounds_model="penalty"`` or ``enable_bounds=False`` on
the impulse path); ``"substep"`` with any of them raises at
``Engine(...)``.

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
scaled motors), and the plain physics of ``"kernel"``, ``"inline"`` and
the continuous path reads the same rows.

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
whole-substep kernels, as in the reference. Joint springs (the tree's
``stiffness``: −k·q on 1-DoF joints, −k·log(quat) on the SPHERICAL
flexibility joints) are part of the actuation torque and, on the impulse
path, integrate implicitly with the joint damping.

The reference's conveniences: :meth:`Engine.get_options` and
:meth:`Engine.set_options` (which rebuild everything derived from the
options, so a live env follows them), :meth:`Engine.simulate` (a loop of
``step`` calls under a controller, the trajectory recorded on the device
and read once), ``reset()`` at the neutral pose and
``n_constraint_rows``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.core.tree import JointType, KinematicTree
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.engine import steppers
from jiminy_tpu_torch.engine.collision import CollisionPairSet
from jiminy_tpu_torch.engine.contact import (
    ContactParams,
    compute_contact_fext,
    contact_effective_mass,
)
from jiminy_tpu_torch.engine.forces import compute_forces
from jiminy_tpu_torch.engine.ground import FlatGround, FourierGround, PerlinGround, StairsGround
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.math import linalg

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
    """The reference's EngineOptions (same names, defaults and order; of
    ``constraint_solver``, the port's ``"substep"``, ``"kernel"`` and
    ``"inline"`` are the reference's ``"pallas_substep"``, ``"pallas"``
    and ``"xla"``). ``solver``: ``"euler_symplectic"`` (or its alias
    ``"euler_explicit"``) or ``"runge_kutta_4"`` (continuous path only).
    ``bounds_model``: ``"auto"`` (rows on the impulse path, else
    penalty torques), ``"penalty"`` or ``"constraint"`` (rows; off the
    impulse path, as in the reference, no bound at all)."""

    solver: str = "euler_symplectic"
    dt: float = 1e-3
    contacts: ContactParams = dataclasses.field(default_factory=ContactParams)
    # "spring_damper" (penalty contacts, the continuous path unless a
    # kinematic constraint asks for the impulse path) or "constraint"
    # (contacts as PGS rows), the reference's default first
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
    bounds_model: str = "auto"  # "auto" | "penalty" | "constraint"
    bounds_baumgarte_freq: float = 20.0
    compute_solver_residual: bool = True
    # the penalty bounds' spring-damper
    bounds_stiffness: float = 1e4
    bounds_damping: float = 1e2
    enable_bounds: bool = True
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

    def bind(self, motors: Motors):
        """The same law as a plain ``fn(cmd, q, v, t=None)`` on (B, ·)
        tensors, for callers outside the engine's declarative path."""
        def fn(cmd, q, v, t=None):
            qm, vm = motors.joint_state(q, v)
            return self.kp * (cmd - qm) - self.kd * vm

        return fn


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
    rows of every substep's solve. ``forces``: registered forces
    (:mod:`jiminy_tpu_torch.engine.forces`), evaluated at each env's time.
    ``internal_dynamics``: an optional ``fn(q, v, t) → (B, nv)`` torque
    added last to the actuation torque (it keeps the torque off the fused
    kernel, which cannot evaluate it).

    ``contact_m_eff`` holds the contact sites' static tangential
    effective masses (ncp,) that the penalty model's friction clamp
    reads (:func:`~jiminy_tpu_torch.engine.contact.contact_effective_mass`,
    rounded to float32 as the reference's), or None without penalty
    contacts; a caller may replace it with another (ncp,) tensor."""

    def __init__(
        self,
        tree: KinematicTree,
        options: EngineOptions | None = None,
        ground=None,
        motors: Motors | None = None,
        controller=None,
        constraints=(),
        collision_pairs=(),
        forces=(),
        internal_dynamics=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.tree = tree.to(device=self.device)
        self.options = options or EngineOptions()
        self.ground = (ground if ground is not None else FlatGround()).to(
            device=self.device, dtype=self.tree.dtype
        )
        self.motors = motors.to(device=self.device) if motors is not None else None
        # the declarative torque path, as TorqueSpec.from_motors's extra
        # arguments: (kp, kd) for a PDController, () for a direct motor
        # command, None for neither (τ computed outside the kernels)
        self._torque = None
        if isinstance(controller, PDController):
            if motors is None:
                raise ValueError("PDController requires motors")
            self._torque = (controller.kp, controller.kd)
            controller = None  # declarative: spec.torque evaluates it
        elif controller is None and self.motors is not None:
            self._torque = ()
        self.controller = controller
        self.internal_dynamics = internal_dynamics
        self.constraints = tuple(constraints)
        self.collision_pairs = tuple(collision_pairs)
        self.forces = tuple(forces)
        self._rebuild()

    def _rebuild(self) -> None:
        """(Re)derive everything that depends on the options: the static
        substep (row layout, solve configuration, constants), the stepper,
        the backend, ``nc`` and the sensor-spec cache. ``__init__`` and
        :meth:`set_options` call it, so changed options never leave a stale
        spec behind."""
        opts = self.options
        if opts.solver not in steppers.STEPPERS:
            raise ValueError(f"unknown solver {opts.solver!r}")
        if opts.constraint_solver not in ("auto", "substep", "kernel", "inline"):
            raise ValueError(f"unknown constraint_solver {opts.constraint_solver!r}")
        if self.collision_pairs and opts.contact_model != "constraint":
            raise ValueError("collision_pairs require contact_model='constraint' "
                             "(pair impulses resolve in the PGS)")
        torque = None
        if self._torque is not None:
            torque = substep_ops.TorqueSpec.from_motors(self.motors, *self._torque)
        self.substep_spec = spec = substep_ops.SubstepSpec(
            self.tree, opts, self.ground, motors=self.motors, torque=torque,
            constraints=self.constraints,
            pairs=CollisionPairSet(self.tree, self.collision_pairs, float(opts.contacts.friction))
            if self.collision_pairs else None,
            forces=self.forces,
        )
        self.impulse = spec.impulse
        if self.impulse and opts.solver not in ("euler_symplectic", "euler_explicit"):
            raise ValueError("constraint/impulse dynamics requires the euler_symplectic stepper "
                             "(velocity-level impulses)")
        self._stepper = steppers.STEPPERS[opts.solver]
        # K2 evaluates a declarative torque alone: an internal-dynamics hook
        # keeps the torque outside (K3 with τ given), as in the reference
        self._fusable = spec.torque is not None and self.internal_dynamics is None
        self.contact_m_eff = None
        if spec.penalty:
            self.contact_m_eff = torch.as_tensor(
                contact_effective_mass(self.tree), dtype=self.tree.dtype, device=self.device)
        # the 1-DoF joints' q and v offsets, which the penalty bounds read
        one = [i for i in range(self.tree.nb)
               if self.tree.joint_type[i] in (JointType.REVOLUTE, JointType.PRISMATIC)]
        self._one_dof = ([self.tree.q_off[i] for i in one], [self.tree.v_off[i] for i in one])
        self.nc = spec.nc
        self.backend = opts.constraint_solver
        if self.backend == "substep":
            # as the reference's explicit "pallas_substep" request, a model
            # outside the kernels' scope fails here, not at the first step
            spec.check_kernel_caps("constraint_solver='substep'")
        elif self.backend == "auto":
            self.backend = self.auto_backend(spec, self.device)
        self._sensor_specs: dict = {}
        self._sensor_ready: dict = {}

    @property
    def n_constraint_rows(self) -> int:
        """Rows of the stacked PGS system (kinematic constraints, bounds,
        ground contacts, pair contacts); 0 on the continuous path. The
        reference's name for :attr:`nc`."""
        return self.nc if self.impulse else 0

    def get_options(self) -> dict:
        """The options as a nested dict (the reference's ``get_options``)."""
        return dataclasses.asdict(self.options)

    def set_options(self, updates: dict) -> None:
        """Replace the options named in ``updates`` (a partial dict;
        ``"contacts"`` a partial dict of its fields) and rebuild what
        derives from them (the reference's ``set_options``)."""
        updates = dict(updates)
        contacts = updates.pop("contacts", None)
        opts = dataclasses.replace(self.options, **updates)
        if contacts is not None:
            cur = dataclasses.asdict(opts.contacts)
            cur.update(contacts)
            opts = dataclasses.replace(
                opts, contacts=ContactParams(**{k: float(x) for k, x in cur.items()}))
        self.options = opts
        self._rebuild()

    @staticmethod
    def auto_backend(spec: substep_ops.SubstepSpec, device: torch.device) -> str:
        """What ``"auto"`` resolves to for ``spec`` on ``device``: the
        whole-substep kernels, else the chain kernel; beyond both
        ``"inline"`` on the CPU, and a ValueError on CUDA. On the
        continuous path, where no solve runs, ``"inline"``."""
        if not spec.impulse:
            return "inline"
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

    def reset(self, q: torch.Tensor | None = None, v: torch.Tensor | None = None,
              batch_size: int = 1) -> SimState:
        """Fresh state at (q, v) for a batch: q (B, nq), v (B, nv). With q
        None, the neutral configuration for ``batch_size`` envs in the
        tree's dtype (the reference's ``reset()``)."""
        if q is None:
            q = torch.as_tensor(self.tree.neutral_q(), dtype=self.tree.dtype,
                                device=self.device).expand(batch_size, -1).clone()
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

    def _bound_torques(self, q, v):
        """The penalty bounds (B, nv): a spring-damper of
        ``bounds_stiffness`` and ``bounds_damping`` on every REVOLUTE and
        PRISMATIC joint past a limit, pushing it back inside (zero when
        ``enable_bounds`` is off)."""
        tau = torch.zeros_like(v)
        opts, tree = self.options, self.tree
        qo, vo = self._one_dof
        if not opts.enable_bounds or not qo:
            return tau
        ks, kd = opts.bounds_stiffness, opts.bounds_damping
        below = torch.clamp_min(tree.q_min[qo] - q[:, qo], 0.0)
        above = torch.clamp_min(q[:, qo] - tree.q_max[qo], 0.0)
        active = (below > 0) | (above > 0)
        f = ks * below - ks * above
        tau[:, vo] = f - torch.where(active, kd * v[:, vo], torch.zeros_like(f))
        return tau

    def _joint_torque(self, u, q, v, mscale=None, t=None):
        """Command → actuation torque, in the reference's order: the
        inner-loop controller, the motor model, joint damping and 1-DoF
        and spherical springs, the penalty bounds (``bounds_model``
        ``"penalty"``), then ``internal_dynamics(q, v, t)``. ``mscale``:
        each env's motor (gain, friction scale), (B, nm) each, or None;
        ``t`` (B,): each env's time, which the internal dynamics read."""
        if self.substep_spec.torque is not None:  # declarative: PD or direct
            tau = substep_ops.torque_reference(self.substep_spec, q, v, u, mscale)
        else:
            if self.controller is not None:
                u = self.controller(u, q, v)
            tau = self.motors.compute_effort(u, v, mscale) if self.motors is not None else u
            tau = substep_ops.with_springs(self.tree, q, tau - self.tree.damping * v)
        if self.substep_spec.bounds_mode == "penalty":
            tau = tau + self._bound_torques(q, v)
        if self.internal_dynamics is not None:
            tau = tau + self.internal_dynamics(q, v, t)
        return tau

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

    def _impulse_substep(self, q, v, u, lam0, wrench, gc, mp=None, fext=None, friction=None,
                         t=None, contacts=None):
        """One semi-implicit Euler substep with velocity-level PGS impulses
        for kinematic constraints, joint bounds, ground contacts and
        collision pairs (``gc``: the per-env ground coefficients or None;
        ``mp``: the per-env packed model parameters or None; ``fext``:
        per-body wrenches or None; ``friction``: the ground friction per
        env or None; ``t`` (B,): each env's time; ``contacts``: the
        penalty model's per-env ContactParams or None). K3 on
        ``"substep"`` unless ``fext``, ``friction`` or ``contacts`` is
        given; then, and on ``"kernel"``, the plain substep around K1; on
        ``"inline"`` the plain substep. Returns (q⁺, v⁺, contact_forces,
        residual, λ, a, τ)."""
        spec, dt = self.substep_spec, self.substep_spec.dt
        mscale = substep_ops.unpack_model_params(spec, mp)[1] if mp is not None else None
        tau = self._joint_torque(u, q, v, mscale, t)
        backend = self.backend
        if backend == "substep" and fext is None and friction is None and contacts is None:
            out = substep_ops.substep_batched(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
        else:
            solve = None if backend == "inline" else self._solve_chain_kernel
            out = substep_ops.substep_reference(
                spec, q, v, tau, lam0, wrench, solve=solve, gc=gc, mp=mp, fext=fext,
                friction=friction, t=t, contacts=contacts, m_eff=self.contact_m_eff,
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
            and self._fusable
            and k_obs >= 1
            and n_substeps % k_obs == 0
            and self._kernel_ground_ok(ground if ground is not None else self.ground)
        ):
            return False
        # the caps' answer per (suite, k_obs), kept until the next rebuild
        key = (id(suite), int(k_obs))
        hit = self._sensor_ready.get(key)
        if hit is None or hit[0] is not suite:
            try:
                self._sensor_spec(suite, k_obs).check_kernel_caps("sensor_fusion_ready")
                ok = True
            except ValueError:
                ok = False
            hit = self._sensor_ready[key] = (suite, ok)
        return hit[1]

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

    def _contact_params(self, contact_params, batch_size: int):
        """``contact_params`` with each field a float or each env's (B,)
        tensor on the engine's device, or None for None."""
        if contact_params is None:
            return None
        out = {}
        for f in dataclasses.fields(ContactParams):
            x = getattr(contact_params, f.name)
            if torch.is_tensor(x):
                x = x.to(device=self.device, dtype=self.tree.dtype)
                if x.dim() > 1 or x.numel() not in (1, batch_size):
                    raise ValueError(f"contact_params.{f.name} of shape {tuple(x.shape)} for a "
                                     f"batch of {batch_size}: a float or one per env")
            else:
                x = float(x)
            out[f.name] = x
        return ContactParams(**out)

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

    def dynamics(self, q, v, t, u, ground=None, fext_user=None, contact_params=None,
                 model_params=None):
        """The continuous dynamics (the reference's ``dynamics``): (q, v,
        t (B,), command u) → (a (B, nv), world penalty contact forces (B,
        ncp, 3)). The penalty contacts on ``ground`` (None: the engine's),
        the registered forces and ``fext_user`` (B, nb, 6) join the
        bodies' wrenches; a = M⁻¹(τ − bias) by Cholesky. ``contact_params``
        (a ContactParams, fields float or (B,)) replaces the options';
        ``model_params`` (B, n_mp) are each env's packed model parameters
        (:meth:`_pack_model_params`)."""
        tree, spec = self.tree, self.substep_spec
        inertials = mscale = None
        if model_params is not None:
            inertials, mscale = substep_ops.unpack_model_params(spec, model_params)
        cparams = contact_params if contact_params is not None else self.options.contacts
        xl = algos.local_transforms(tree, q)
        xw, vel = algos.kinematics(tree, q, v, xl=xl)
        fext, f_contact = compute_contact_fext(
            tree, xw, vel, ground if ground is not None else self.ground, cparams,
            dt=spec.dt, m_eff=self.contact_m_eff, spheres=spec.spheres)
        if self.forces:
            fext = fext + compute_forces(tree, self.forces, t, xw, vel)
        if fext_user is not None:
            fext = fext + fext_user
        tau = self._joint_torque(u, q, v, mscale, t)
        M = algos.crba(tree, q, xl=xl, inertials=inertials)
        bias = algos.rnea(tree, q, v, torch.zeros_like(v), fext=fext, xl=xl,
                          inertials=inertials)
        return linalg.solve_psd(M, tau - bias), f_contact

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
        (None: the engine's ground); on the impulse path anything else
        raises ValueError. ``model_params``: optional (B, n_mp) packed rows
        (:meth:`_pack_model_params`) perturbing each env's inertials,
        armature and motors. ``fext_user``: optional (B, nb, 6) or (nb,
        6) local [ang; lin] wrenches on every body held over the step,
        added to ``base_wrench``. ``contact_params``: optional
        :class:`ContactParams` whose fields (each a float or each env's
        (B,) tensor) replace the options': the friction of the ground
        contact rows (the collision pairs keep theirs), and every field of
        the penalty model. On the impulse path either of the last two
        keeps the step off the whole-substep kernels, as in the reference:
        every backend then runs the plain substep per substep, around the
        chain kernel K1 on ``"substep"`` and ``"kernel"``. On the
        continuous path the options' stepper integrates
        :meth:`dynamics`, which is then evaluated once more at the
        accepted state for ``a`` and the contact forces; the residual is
        0 and λ stays as it was."""
        spec, dt = self.substep_spec, self.substep_spec.dt
        q, v, t, lam = state.q, state.v, state.t, state.lam
        B = q.shape[0]
        mp = model_params
        substep_ops._check_mp("Engine.step", spec, mp, B)
        fext, cparams = self._fext(fext_user, B), self._contact_params(contact_params, B)
        if not self.impulse:
            return self._continuous_step(state, u, n_substeps, base_wrench, ground, mp, fext,
                                         cparams)
        wrench = base_wrench
        gc = self._ground_coef(ground, B)
        friction = cparams.friction if cparams is not None else None
        plain = fext is not None or cparams is not None
        if self.backend == "substep" and not plain:
            if wrench is None:  # the kernels always take one
                wrench = q.new_zeros(q.shape[0], 6)
            if self.options.substep_fusion and self._fusable:
                q, v, lam, res, impulse, a, tau = substep_ops.substep_batched_multi(
                    spec, n_substeps, q, v, u, lam, wrench, gc=gc, mp=mp
                )
                return SimState(
                    t=t + n_substeps * dt, q=q, v=v, contact_forces=impulse / dt,
                    solver_residual=res, lam=lam, a=a, tau=tau,
                )
        contacts = cparams if spec.penalty else None
        f_c, res, a, tau = state.contact_forces, state.solver_residual, state.a, state.tau
        for _ in range(n_substeps):
            q, v, f_c, res, lam, a, tau = self._impulse_substep(q, v, u, lam, wrench, gc, mp,
                                                                fext, friction, t, contacts)
            t = t + dt
        return SimState(
            t=t, q=q, v=v, contact_forces=f_c, solver_residual=res,
            lam=lam, a=a, tau=tau,
        )

    def _continuous_step(self, state, u, n_substeps, base_wrench, ground, mp, fext, cparams):
        """``step`` on the continuous path (no solve, no kernel)."""
        dt = self.substep_spec.dt
        q, v, t = state.q, state.v, state.t
        if base_wrench is not None:  # on the root body, beside the bodies' wrenches
            bw = q.new_zeros(q.shape[0], self.tree.nb, 6)
            bw[:, 0] = base_wrench
            fext = bw if fext is None else fext + bw

        def dyn(q_, v_, t_):
            return self.dynamics(q_, v_, t_, u, ground, fext, cparams, mp)[0]

        for _ in range(n_substeps):
            q, v = self._stepper(self.tree, dyn, q, v, t, dt)
            t = t + dt
        a, f_contact = self.dynamics(q, v, t, u, ground, fext, cparams, mp)
        mscale = (substep_ops.unpack_model_params(self.substep_spec, mp)[1]
                  if mp is not None else None)
        return SimState(
            t=t, q=q, v=v, contact_forces=f_contact, solver_residual=q.new_zeros(q.shape[0]),
            lam=state.lam, a=a, tau=self._joint_torque(u, q, v, mscale, t),
        )

    def simulate_adaptive(self, state: SimState, t_end: float, u=None, ground=None,
                          dt_max: float | None = None, tol_abs: float = 1e-8,
                          tol_rel: float = 1e-6) -> tuple[SimState, dict]:
        """Integrate one trajectory to ``t_end`` with the adaptive DOPRI-5(4)
        stepper and its PI controller (the reference's ``simulate_adaptive``:
        the options' dt starts it, ``dt_max`` defaults to 20·dt). As in the
        reference it is single-trajectory and needs the continuous path:
        ``state`` is a batch of one, and the impulse path or a larger
        batch raises ValueError. The loop reads its condition on the host
        once per iteration. Returns (the final SimState, {"accepted",
        "rejected", "iters"})."""
        if self.impulse:
            raise ValueError("adaptive stepping requires the spring-damper contact path")
        if state.q.shape[0] != 1:
            raise ValueError(f"simulate_adaptive integrates one trajectory (a batch of 1), got "
                             f"{state.q.shape[0]}")
        n_cmd = self.motors.nm if self.motors is not None else self.tree.nv
        u = state.q.new_zeros(1, n_cmd) if u is None else u.to(device=self.device,
                                                                 dtype=state.q.dtype)

        def dyn(q_, v_, t_):
            return self.dynamics(q_, v_, t_, u, ground)[0]

        dt = self.substep_spec.dt
        t, q, v, stats = steppers.integrate_adaptive(
            self.tree, dyn, state.q, state.v, state.t, t_end, dt_init=dt,
            dt_max=dt_max if dt_max is not None else dt * 20, tol_abs=tol_abs, tol_rel=tol_rel,
        )
        a, f_contact = self.dynamics(q, v, t, u, ground)
        return SimState(
            t=t, q=q, v=v, contact_forces=f_contact, solver_residual=q.new_zeros(1),
            lam=state.lam, a=a, tau=self._joint_torque(u, q, v, t=t),
        ), stats

    def simulate(self, state: SimState, t_end: float, controller=None,
                 control_dt: float | None = None, ground=None) -> tuple[SimState, dict]:
        """Run to ``t_end`` under ``controller(q, v, t) → u`` (on (B, ·)
        tensors; None: a zero command) updated every ``control_dt``
        (default: every substep), one :meth:`step` per update (the
        reference's ``simulate``). t, q and v after each step go into
        preallocated tensors on the engine's device, which reach the host
        once, at the end. Returns (the final state, {"t" (T, B), "q" (T,
        B, nq), "v" (T, B, nv)} as numpy arrays)."""
        dt = self.options.dt
        n_sub = max(1, round((control_dt or dt) / dt))
        n_ctrl = max(1, round(t_end / (n_sub * dt)))
        B = state.q.shape[0]
        n_cmd = self.motors.nm if self.motors is not None else self.tree.nv
        log = {"t": state.t.new_empty(n_ctrl, B), "q": state.q.new_empty(n_ctrl, *state.q.shape),
               "v": state.v.new_empty(n_ctrl, *state.v.shape)}
        zero = state.q.new_zeros(B, n_cmd)
        for i in range(n_ctrl):
            u = controller(state.q, state.v, state.t) if controller is not None else zero
            state = self.step(state, u, n_substeps=n_sub, ground=ground)
            log["t"][i], log["q"][i], log["v"][i] = state.t, state.q, state.v
        return state, {k: x.cpu().numpy() for k, x in log.items()}
