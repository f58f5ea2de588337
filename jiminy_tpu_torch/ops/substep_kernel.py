"""Whole-substep kernels and their plain versions.

Counterpart of ``jiminy_tpu/ops/substep_kernel.py``. One impulse substep
of the engine, for every env of a batch:

    FK → RNEA bias (with a root wrench; per-body wrenches on the plain
      substep) → CRBA + armature + dt·damping + dt²·stiffness (implicit
      joint damping and springs)
    → kinematic-constraint rows, joint-bound rows, ground-contact rows
      color-major (the contact basis from the ground's normal at each
      point; a sphere site touches at its surface point) and the
      collision pairs' contact rows, one color per pair
    → the solve chain (chol → M⁻¹[p|Jᵀ] → Delassus → grouped PGS)
    → world contact impulses → symplectic Euler

- :func:`substep_reference` is the plain PyTorch substep, the very
  function the engine runs on its ``"inline"`` and ``"kernel"`` paths;
  :func:`substep_multi_reference` chains ``n_sub`` of them with the
  actuation torque recomputed before each (:func:`torque_reference`)
  and, given a :class:`SensorKernelSpec`, a sensor update every
  ``k_obs`` substeps (:func:`sensor_stage_reference`: measure at the
  accepted state, corrupt with pre-sampled eps, push the delay lines).
- :func:`substep_batched` (K3, one substep, τ given) and
  :func:`substep_batched_multi` (K2, ``n_sub`` substeps in one launch,
  with the sensor stage when given ``sensors=``) are the entry points:
  on CUDA tensors they launch the hand-written kernels of
  ``csrc/substep.cuh`` (both one warp per env on one substep body,
  ``csrc/substep_warp.cuh``, the workspace in shared memory laid out by
  :meth:`SubstepSpec.warp_workspace`; built with nvcc from
  ``csrc/substep.cu`` and,
  for the randomized instantiations, ``csrc/substep_rand.cu``; loaded
  with ctypes); on CPU tensors they run the plain versions. They never
  fall back from one to the other. Each instantiation counts its own
  launches (``.launches``, ``.sensor_launches``, ``.ground_launches``,
  ``.rand_launches``, …).

:class:`SubstepSpec` is the static description of one engine's substep
(row layout, solve configuration, Baumgarte constants, the tree) and
packs it once per device into the buffers the kernels read;
:class:`TorqueSpec` is the declarative actuation path that K2 evaluates
in-kernel; :class:`SensorKernelSpec` packs a sensor suite for K2's
sensor stage.

Grounds: flat (height baked into the spec) or, through the kernels'
``GEN`` instantiations, an analytic ground (Fourier, Perlin, Stairs)
per env, whose coefficients ``gc`` (B, n_gc) every entry point takes
(``SubstepSpec.n_gc`` wide; the layout of
:mod:`jiminy_tpu_torch.engine.ground`). A :class:`HeightmapGround` runs
on the plain versions alone (``check_kernel_caps`` refuses it).

Model randomization: every entry point takes each env's packed model
parameters ``mp`` (B, n_mp) (``SubstepSpec.n_mp``: the perturbed
masses, first moments and origin inertias, the armature, and with a
torque path the motor gains and friction scales; built by
``Engine._pack_model_params``), which replace the tree's inertials in
RNEA and CRBA, the armature on M's diagonal and, in K2's torque, the
reduction and friction. Kinematics, Jacobians and integration stay on
the nominal tree.

Kinematic constraints (``SubstepSpec(..., constraints=)``: frame, joint,
distance, sphere and wheel constraints) are rows of their own, one
equality block each, ahead of the bounds. Only distance constraints
(closed loops) ride the whole-substep kernels, as in the reference; with
any other, :meth:`SubstepSpec.check_kernel_caps` refuses the model and it
runs :func:`substep_reference` around the chain kernel. So do per-body
external wrenches and per-env ground friction, which only
:func:`substep_reference` takes (``fext=``, ``friction=``). Joint springs
(stiffness k per dof) integrate implicitly: −k·q on a 1-DoF joint and
−k·log(quat) on a SPHERICAL one (the flexibility joints, 3 dofs each) in
the actuation torque, dt²·k on M's diagonal and −dt·k·v in the
free-motion torque (the τ a step returns is the first).

Contact sites may be spheres (``tree.contact_radius`` > 0): the site
touches at centre − r·n̂, the normal taken at the centre's xy
(``surface_contacts``). Declared collision pairs
(:class:`~jiminy_tpu_torch.engine.collision.CollisionPairSet`,
``SubstepSpec(..., pairs=)``) add one [t1, t2, n] block per contact after
the ground contacts, each pair one PGS color with its own friction; the
kernels run the three narrow phases (``seg``, ``ptbox``, ``ptseg``)
in-kernel.

Joints: FREE, REVOLUTE, PRISMATIC (a translation q along the axis, its
motion subspace [0; axis]; bounded and sprung as REVOLUTE) and SPHERICAL
(a quaternion of 4 and ω local of 3; the kernels' frame takes nq ≤ nv +
4).

Off the kernels, as the reference's scope check routes them
(:meth:`SubstepSpec.check_kernel_caps` refuses each, so ``"auto"`` takes
the chain kernel and an explicit ``"substep"`` raises): penalty
(spring-damper) contacts beside kinematic constraints, whose wrenches
join the bodies' ``fext`` and which add no contact rows; registered
forces (:mod:`jiminy_tpu_torch.engine.forces`), evaluated at each env's
time; joint bounds as penalty torques or not at all (no bound rows); and
a stepper other than symplectic Euler. :func:`substep_reference` takes
all of them. With no row at all (nc = 0) it skips the solve: v⁺ = v +
dt·M⁻¹·p.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import JointType, KinematicTree
from jiminy_tpu_torch.engine import collision
from jiminy_tpu_torch.engine import constraints as cstr
from jiminy_tpu_torch.engine import forces as registered
from jiminy_tpu_torch.engine.contact import compute_contact_fext, surface_contacts
from jiminy_tpu_torch.engine.ground import ANALYTIC, FlatGround, HeightmapGround
from jiminy_tpu_torch.engine.randomization import Inertials
from jiminy_tpu_torch.engine.solver import BlockSpec
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite
from jiminy_tpu_torch.math import linalg, so3
from jiminy_tpu_torch.ops import _warp
from jiminy_tpu_torch.ops._warp import SMEM_PER_BLOCK, WARP_MAX_W, WarpWorkspace  # noqa: F401
# a module, not its names: the engine package imports this module while
# ops.constraint_solve may still be importing the engine's PGS solver
from jiminy_tpu_torch.ops import constraint_solve as chain

_TORQUE_MODES = {"pd": 1, "direct": 2}
BOUNDS_MODELS = ("auto", "penalty", "constraint")
_HDR_I, _HDR_F = 10, 16  # header lengths of the packed spec (csrc/substep.cuh)
# the float header's slots that say whether the tree has joint springs, how
# many pair contact generators the spec holds and whether any contact site
# is a sphere
_S_SPRINGS, _S_NGEN, _S_SPHERES = 11, 12, 13
# pair contact generators (csrc/substep.cuh JT_GEN_*) and the ints each takes
_GEN_KINDS = {"seg": 0, "ptbox": 1, "ptseg": 2}
# the kernels' largest instantiation (csrc/substep.cuh JT_SUB_MAX_NB,
# JT_SUB_MAX_N, JT_NQ_EXTRA); nc, the distance constraints (equality
# blocks) and the colors are capped by the chain's limits
# (ops/constraint_solve.py MAX_NC, MAX_EQ, MAX_COLORS). The C entry points
# refuse anything larger as well.
MAX_NB, MAX_NV, NQ_EXTRA = 32, 32, 4
# as the reference gates its in-kernel assembly, the pair contacts the kernels take
MAX_PAIR_CONTACTS = 24
# ground modes and the ground query's caps (csrc/substep.cuh JT_GROUND_*,
# JT_FOURIER_MAX, JT_PERLIN_MAX): K Fourier terms, Perlin octaves
_GROUND_MODES = {"flat": 0, "fourier": 1, "perlin": 2, "stairs": 3}
MAX_FOURIER_TERMS, MAX_PERLIN_OCTAVES = 32, 8
# the sensor stage's caps (csrc/substep.cuh JT_SENS_MAX_*)
MAX_SENS_GROUPS, MAX_SENS_BUF, MAX_SENS_EPS = 8, 4096, 1024
_SENSOR_CODES = {"imu": 0, "encoder": 1, "effort": 2, "contact": 3}
# what a sensor needs of a body and its ancestors (csrc/substep.cuh JT_NEED_*)
_NEED_ROTATION, _NEED_MOTION = 1, 3
# the warp body (csrc/substep_warp.cuh), which every K3 and K2 launch runs:
# the floats each body adds to its parent in the backward pass (JT_CC), and
# its layout's slots in the order of the JT_WL_* enum: a header, then the
# regions outside the union, the union, and the union's three views (each
# live at its own time); its envs per block and a block's shared memory are
# ops/_warp.py's
_CC = 19
_WARP_HEAD = ("W", "stride", "ncp", "n_rows", "ldm", "ldj", "ldx", "lda")
_WARP_OUTSIDE = ("q0", "q1", "v0", "v1", "tau", "lam", "cmd", "w0", "fc", "g", "M", "dL", "pf",
                 "J", "target", "mu", "active", "basis", "rhs", "diag", "vfree")
WARP_VIEWS = {
    "tree": ("xlR", "xlp", "xwR", "xwp", "vel", "acc", "frc", "Ic", "cc"),
    "chain": ("X", "A"),
    "sensors": ("s_xwR", "s_vel", "s_acc", "rows"),
}


@dataclasses.dataclass(frozen=True)
class TorqueSpec:
    """Declarative actuation torque (the reference's ``TorqueSpec``, field
    for field): mode ``"pd"``, u = kp·(cmd − q[q_idx]) − kd·v[v_idx], or
    ``"direct"``, u = cmd; then the motor model and joint damping."""

    mode: str
    q_idx: tuple
    v_idx: tuple
    reduction: tuple
    effort_limit: tuple
    velocity_limit: tuple
    friction_dry: tuple
    friction_viscous: tuple
    friction_vel_eps: tuple
    kp: tuple | None = None
    kd: tuple | None = None

    @property
    def nm(self) -> int:
        return len(self.v_idx)

    @staticmethod
    def from_motors(motors: Motors, kp=None, kd=None) -> "TorqueSpec":
        """PD mode when ``kp`` and ``kd`` are given (scalars or (nm,)),
        else direct motor command."""

        def floats(x):
            return tuple(float(a) for a in np.broadcast_to(np.asarray(x, np.float64), (motors.nm,)))

        def param(name):
            return floats(getattr(motors, name).detach().cpu().numpy())

        pd = kp is not None and kd is not None
        return TorqueSpec(
            mode="pd" if pd else "direct",
            q_idx=tuple(motors.q_idx),
            v_idx=tuple(motors.v_idx),
            reduction=param("reduction"),
            effort_limit=param("effort_limit"),
            velocity_limit=param("velocity_limit"),
            friction_dry=param("friction_dry"),
            friction_viscous=param("friction_viscous"),
            friction_vel_eps=param("friction_vel_eps"),
            kp=floats(kp) if pd else None,
            kd=floats(kd) if pd else None,
        )


class SubstepSpec:
    """Static description of one engine's impulse substep.

    Rows are [constraints | bounds | contacts color-major | pair
    contacts]: each kinematic constraint's ``size`` equality rows (in
    declaration order, each its own block), one row per bounded 1-DoF
    joint, then [t1, t2, n] per
    contact site, the sites in ``color_order`` (interleaved halves:
    diagonal leg pairs on quadrupeds), each color's rows contiguous, then
    [t1, t2, n] per pair contact in generator order, each pair one color
    spanning its contacts (the reference's layout). The impulse path runs
    (``impulse``) when there is a kinematic constraint or
    ``contact_model="constraint"``; bound rows exist only there with the
    bounds run as constraints (``bounds_mode``, ``enable_bounds``), and
    contact rows only under ``"constraint"``; with penalty contacts
    (``penalty``) the sites' wrenches join ``fext`` instead. On the
    continuous path (no impulse) there is no row: nc = 0. ``forces``: the
    engine's registered forces. ``torque`` (or None)
    is the declarative actuation path that K2 needs; ``motors`` the bank
    it reads; ``constraints`` the engine's kinematic constraints (any of
    :data:`~jiminy_tpu_torch.engine.constraints.CONSTRAINTS`), and when
    all of them are distance constraints, the kernels' form of them, the
    reference's tuples (body 1, its local point, body 2, its local point,
    distance, Baumgarte frequency), in ``dist_constraints``; ``pairs`` the
    engine's
    :class:`~jiminy_tpu_torch.engine.collision.CollisionPairSet` or
    None."""

    def __init__(
        self,
        tree: KinematicTree,
        options,
        ground,
        motors: Motors | None = None,
        torque: TorqueSpec | None = None,
        constraints=(),
        pairs: collision.CollisionPairSet | None = None,
        forces=(),
    ):
        if options.bounds_model not in BOUNDS_MODELS:
            raise ValueError(f"unknown bounds_model {options.bounds_model!r} (one of "
                             f"{', '.join(BOUNDS_MODELS)})")
        if not isinstance(ground, (FlatGround, HeightmapGround, *ANALYTIC)):
            raise TypeError(f"unknown ground {type(ground).__name__}")
        if isinstance(ground, ANALYTIC) and ground.coef().dim() != 1:
            raise ValueError("the engine's ground is one ground, not a batch: per-env "
                             "grounds go to step(ground=...)")
        for c in constraints:
            if not isinstance(c, cstr.CONSTRAINTS):
                raise TypeError(
                    f"{type(c).__name__} is not a kinematic constraint (one of "
                    f"{', '.join(k.__name__ for k in cstr.CONSTRAINTS)})"
                )
            lock = isinstance(c, cstr.JointConstraint)
            jt = JointType(tree.joint_type[c.joint]) if lock else None
            if lock and jt not in (JointType.REVOLUTE, JointType.PRISMATIC):
                raise ValueError(f"JointConstraint on joint {c.joint} ({jt.name}): only REVOLUTE "
                                 "and PRISMATIC joints can be locked")
        stiff = tree.stiffness.detach().cpu().numpy()
        if torque is not None and motors is None:
            raise ValueError("a TorqueSpec needs the motor bank")
        self.tree = tree
        self.options = opts = options
        self.motors = motors
        self.torque = torque
        self.ground = ground
        self.ground_mode = ground.MODE
        self.ground_height = float(ground.height) if isinstance(ground, FlatGround) else 0.0
        # the Fourier term or Perlin octave count, static in the kernel's loop
        self.ground_n = (ground.n_terms if self.ground_mode == "fourier"
                         else ground.octaves if self.ground_mode == "perlin" else 0)
        self.n_gc = ground.coef().shape[-1] if isinstance(ground, ANALYTIC) else 0
        self.friction = float(opts.contacts.friction)
        self.dt = float(opts.dt)
        self.springs = bool(np.any(stiff != 0))
        self.constraints = tuple(constraints)
        self.forces = tuple(forces)
        for f in self.forces:
            if not isinstance(f, registered.FORCES):
                raise TypeError(f"{type(f).__name__} is not a registered force (one of "
                                f"{', '.join(k.__name__ for k in registered.FORCES)})")
        # the routes of the reference's _rebuild, _bounds_mode and
        # _impulse_substep: which rows exist, and where the contacts go
        self.impulse = bool(self.constraints) or opts.contact_model == "constraint"
        bm = opts.bounds_model
        self.bounds_mode = ("constraint" if self.impulse else "penalty") if bm == "auto" else bm
        self.contact_rows = opts.contact_model == "constraint"
        self.penalty = not self.contact_rows and tree.ncp > 0
        # the constraints the whole-substep kernels take: distance ones alone
        self.other_constraints = sorted({type(c).__name__ for c in self.constraints
                                         if not isinstance(c, cstr.DistanceConstraint)})
        fb, fp = tree.frame_body, tree.fp_pos.detach().cpu().numpy()
        self.dist_constraints = [] if self.other_constraints else [
            (fb[c.frame1], [float(x) for x in fp[c.frame1]], fb[c.frame2],
             [float(x) for x in fp[c.frame2]], float(c.distance), float(c.baumgarte_freq))
            for c in self.constraints
        ]
        self.n_dist = len(self.dist_constraints)
        n_eq = sum(c.size for c in self.constraints)
        eq_blocks, start = [], 0
        for c in self.constraints:
            eq_blocks.append(BlockSpec("equality", start, c.size))
            start += c.size
        self.contact_radius = [float(r) for r in tree.contact_radius.detach().cpu().numpy()]
        self.spheres = any(r > 0.0 for r in self.contact_radius)
        self.pairs = pairs if pairs is not None and pairs.gens else None
        self.pair_contacts = list(pairs.contacts_per_pair) if self.pairs else []
        self.n_pc = sum(self.pair_contacts)

        # an explicit bounds_model="constraint" off the impulse path applies no
        # bound at all, as in the reference
        bound_rows = self.impulse and self.bounds_mode == "constraint" and opts.enable_bounds
        self.bounded_joints = self._bounded_joints(tree) if bound_rows else []
        ncp = tree.ncp
        self.color_order = list(range(0, ncp, 2)) + list(range(1, ncp, 2))
        inv = [0] * ncp
        for j, k in enumerate(self.color_order):
            inv[k] = j
        self.color_inverse = inv
        nbj = len(self.bounded_joints)
        n0 = len(range(0, ncp, 2))
        off = self.contact_off = n_eq + nbj
        n_rows = ncp if self.contact_rows else 0
        colors = [(off, n0), (off + 3 * n0, ncp - n0)] if n_rows else []
        self.pair_off = pair = off + 3 * n_rows
        for k in self.pair_contacts:  # one color per pair
            colors.append((pair, k))
            pair += 3 * k
        self.nc = pair
        self.cfg = chain.SolveConfig(
            n=tree.nv,
            nc=self.nc,
            dt=self.dt,
            eq_blocks=tuple(eq_blocks),
            bounds_span=(n_eq, nbj) if nbj else None,
            contact_colors=tuple(colors),
            iters=opts.pgs_iters,
            relax=opts.pgs_relax,
            reg=opts.pgs_reg,
            compute_residual=opts.compute_solver_residual,
        )
        # float32 constants rounded as the reference's traced f32 math
        f32 = np.float32
        self.alpha_bounds = float(cstr.baumgarte_alpha(opts.bounds_baumgarte_freq, opts.dt))
        alpha_c = cstr.baumgarte_alpha(opts.contact_baumgarte_freq, opts.dt)
        self.alpha_c_over_dt = float(alpha_c / f32(opts.dt))
        self._packed: dict = {}
        self._warp: dict = {}

    @staticmethod
    def _bounded_joints(tree: KinematicTree) -> list[int]:
        """1-DoF joints with finite position limits."""
        q_min = tree.q_min.cpu().numpy()
        q_max = tree.q_max.cpu().numpy()
        return [
            i for i in range(tree.nb)
            if tree.joint_type[i] in (JointType.REVOLUTE, JointType.PRISMATIC)
            and (q_min[tree.q_off[i]] > -1e5 or q_max[tree.q_off[i]] < 1e5)
        ]

    @property
    def n_mp(self) -> int:
        """Width of each env's packed model parameters (the reference's
        layout): mass (nb) ‖ h (3·nb) ‖ origin inertia xx, yy, zz, xy, xz,
        yz (6·nb) ‖ armature (nv) ‖ with a torque path motor gain (nm) ‖
        motor friction scale (nm). K3 reads the same row and ignores the
        motor tail."""
        n = 10 * self.tree.nb + self.tree.nv
        return n + 2 * self.torque.nm if self.torque is not None else n

    def check_kernel_caps(self, who: str):
        """Raise ValueError when the model is outside the whole-substep
        kernels' scope, as the reference's scope check words it: a stepper
        other than symplectic Euler, penalty contacts, registered forces,
        bounds not run as constraints, or a kinematic constraint other
        than a distance constraint (the chain kernel takes each of these
        impulse models); or larger than they take (more than 24 pair
        contacts, the reference's gate on in-kernel assembly, or more PGS
        colors than the chain's 16); or its ground is one they cannot
        query (a heightmap; more than 32 Fourier terms or 8 Perlin
        octaves)."""
        t, opts = self.tree, self.options
        bad = []
        if opts.solver not in ("euler_symplectic", "euler_explicit"):
            bad.append("stepper must be euler_symplectic")
        if opts.contact_model != "constraint":
            bad.append("contact_model must be 'constraint'")
        if self.forces:
            bad.append("registered forces unsupported")
        if self.bounds_mode != "constraint" or not opts.enable_bounds:
            bad.append("bounds must run as constraints")
        if self.other_constraints:
            bad.append(
                f"{', '.join(self.other_constraints)} outside the whole-substep kernels: only "
                "distance constraints (Cassie's pushrods) ride them"
            )
        if bad:
            raise ValueError(f"{who}: " + "; ".join(bad) + "; the chain kernel takes such an "
                             "impulse model (constraint_solver='kernel')")
        n_colors = len(self.cfg.contact_colors)
        max_nc, max_dist, max_colors = chain.MAX_NC, chain.MAX_EQ, chain.MAX_COLORS
        if t.nb > MAX_NB or t.nv > MAX_NV or not 1 <= self.nc <= max_nc \
                or t.nq > t.nv + NQ_EXTRA or self.n_dist > max_dist \
                or self.n_pc > MAX_PAIR_CONTACTS or n_colors > max_colors:
            raise ValueError(
                f"{who}: nb={t.nb}, nv={t.nv}, nq={t.nq}, nc={self.nc}, "
                f"{self.n_dist} distance constraints, {self.n_pc} pair contacts, {n_colors} "
                f"colors outside the whole-substep kernels' caps (nb ≤ {MAX_NB}, nv ≤ "
                f"{MAX_NV}, 1 ≤ nc ≤ {max_nc}, nq ≤ nv + {NQ_EXTRA}, ≤ {max_dist} distance "
                f"constraints, ≤ {MAX_PAIR_CONTACTS} pair contacts, ≤ {max_colors} colors)"
            )
        cap = {"fourier": MAX_FOURIER_TERMS, "perlin": MAX_PERLIN_OCTAVES}.get(self.ground_mode)
        if self.ground_mode not in _GROUND_MODES or (cap and not 1 <= self.ground_n <= cap):
            raise ValueError(
                f"{who}: a {self.ground_mode} ground (n={self.ground_n}) is outside the "
                f"kernels' ground query (flat, fourier ≤ {MAX_FOURIER_TERMS} terms, perlin "
                f"≤ {MAX_PERLIN_OCTAVES} octaves, stairs)"
            )

    def warp_workspace(self, sensors: "SensorKernelSpec | None" = None) -> WarpWorkspace:
        """The layout of the warp body for this spec (with ``sensors``, the
        sensor stage's too: K2 with its sensor stage; without, K2's and
        K3's); every model inside the kernels' caps has one,
        and a model past them raises ValueError (:meth:`check_kernel_caps`).
        Sized from the model's own dimensions; W, the envs per block, as
        many as fit one block up to ``WARP_MAX_W``."""
        self.check_kernel_caps("warp_workspace")
        n_rows = sensors.n_rows if sensors is not None else 0
        if n_rows not in self._warp:
            self._warp[n_rows] = self._warp_layout(n_rows)
        return self._warp[n_rows]

    def _warp_layout(self, n_rows: int) -> WarpWorkspace:
        t = self.tree
        nb, nq, nv, nc, ncp = t.nb, t.nq, t.nv, self.nc, t.ncp
        nm = self.torque.nm if self.torque is not None else 0
        lds = dict(ldm=nv | 1, ldj=nv | 1, ldx=(nc + 1) | 1, lda=nc | 1)
        sb = nb if n_rows else 0
        sizes = dict(
            q0=nq, q1=nq, v0=nv, v1=nv, tau=nv, lam=nc, cmd=nm, w0=6, fc=3 * ncp, g=self.n_gc,
            M=nv * lds["ldm"], dL=nv, pf=nv, J=nc * lds["ldj"], target=nc, mu=nc, active=nc,
            basis=9 * ncp if self.n_gc else 0, rhs=nc, diag=nc, vfree=nv,
            xlR=9 * nb, xlp=3 * nb, xwR=9 * nb, xwp=3 * nb, vel=6 * nb, acc=6 * nb, frc=6 * nb,
            Ic=13 * nb, cc=_CC * nb, X=nv * lds["ldx"], A=nc * lds["lda"],
            s_xwR=9 * sb, s_vel=6 * sb, s_acc=6 * sb, rows=n_rows,
        )
        regions, union = _warp.pack(sizes, _WARP_OUTSIDE)
        stride = union
        for view in WARP_VIEWS.values():
            placed, end = _warp.pack(sizes, view, union)
            regions.update(placed)
            stride = max(stride, end)
        regions["union"] = (union, stride - union)
        nbytes = 4 * stride
        W = _warp.envs_per_block(nbytes, "the substep kernels' warp workspace")
        head = dict(W=W, stride=stride, ncp=ncp, n_rows=n_rows, **lds)
        order = _WARP_OUTSIDE + ("union",) + sum(WARP_VIEWS.values(), ())
        ints = tuple(head[k] for k in _WARP_HEAD) + tuple(regions[k][0] for k in order)
        return WarpWorkspace(regions=regions, lds=lds, bytes_per_env=nbytes, W=W, ints=ints)

    def ground_of(self, gc):
        """The ground that per-env coefficients ``gc`` (B, n_gc) describe,
        or the spec's own ground for None."""
        return self.ground if gc is None else type(self.ground).from_coef(gc, self.ground)

    def packed(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(int32, float32) buffers of the spec on ``device``, laid out as
        ``csrc/substep.cuh`` reads them; built once per device."""
        key = str(device)
        if key not in self._packed:
            self._packed[key] = tuple(
                torch.as_tensor(a, device=device) for a in self._pack()
            )
        return self._packed[key]

    def _pack(self) -> tuple[np.ndarray, np.ndarray]:
        t, ts = self.tree, self.torque
        bj = self.bounded_joints
        nm = ts.nm if ts is not None else 0
        mode = _TORQUE_MODES[ts.mode] if ts is not None else 0
        ints = [t.nb, t.nq, t.nv, t.ncp, len(bj), nm, mode,
                _GROUND_MODES.get(self.ground_mode, -1), self.ground_n, self.n_dist]
        ints += list(t.parent) + [int(j) for j in t.joint_type]
        ints += list(t.q_off) + list(t.v_off)
        ints += list(t.contact_body) + self.color_order + bj
        if ts is not None:
            ints += list(ts.q_idx) + list(ts.v_idx)
        for b1, _, b2, _, _, _ in self.dist_constraints:
            ints += [b1, b2]
        gen_ints, gen_floats = self._pack_pairs()
        self._check_pair_colors(gen_ints[3::5])
        ints += gen_ints

        def arr(x):
            return x.detach().cpu().numpy().astype(np.float64)

        g = arr(t.gravity)
        scal = [
            self.dt, self.alpha_bounds, self.alpha_c_over_dt,
            self.options.contact_slop, self.options.contact_max_correction_vel,
            self.options.contact_margin, self.friction, self.ground_height,
            *g,
        ]
        scal += [0.0] * (_HDR_F - len(scal))
        scal[_S_SPRINGS] = float(self.springs)
        scal[_S_NGEN] = float(len(self.pairs.gens) if self.pairs else 0)
        scal[_S_SPHERES] = float(self.spheres)
        body = np.concatenate(
            [
                arr(t.axis), arr(t.jp_rot).reshape(t.nb, 9), arr(t.jp_pos),
                arr(t.inertia_mass)[:, None], arr(t.inertia_h),
                arr(t.inertia_mat).reshape(t.nb, 9),
            ],
            axis=1,
        )
        qo = [t.q_off[i] for i in bj]
        parts = [
            np.asarray(scal), body.ravel(), arr(t.armature), arr(t.damping),
            arr(t.contact_pos).ravel(), arr(t.q_min)[qo], arr(t.q_max)[qo],
        ]
        if ts is not None:
            zeros = (0.0,) * nm
            parts += [
                np.asarray(x) for x in (
                    ts.reduction, ts.effort_limit, ts.velocity_limit,
                    ts.friction_dry, ts.friction_viscous, ts.friction_vel_eps,
                    ts.kp or zeros, ts.kd or zeros,
                )
            ]
        for c, (_, p1, _, p2, d0, _) in zip(self.constraints, self.dist_constraints):
            parts.append(np.asarray(p1 + p2 + [d0, c.alpha_over_dt(self.dt)]))
        if self.springs:
            parts.append(arr(t.stiffness))
        if self.spheres:
            parts.append(arr(t.contact_radius))
        parts.append(np.asarray(gen_floats))
        floats = np.concatenate([np.asarray(p, np.float64).ravel() for p in parts])
        return np.asarray(ints, np.int32), floats.astype(np.float32)


    def _check_pair_colors(self, gen_counts):
        """The kernels write the generators' contacts (``gen_counts``, each
        generator's packed count) in order from ``pair_off``: the colors
        from there must cover exactly those contacts, each ending at a
        generator's last, and the colors before it the ground sites."""
        sizes = [k for _, k in self.cfg.contact_colors]
        n_ground = 2 if self.tree.ncp else 0  # the ground sites' two colors
        ground, pair = sizes[:n_ground], sizes[n_ground:]
        ends = set(np.cumsum(gen_counts).tolist())
        if sum(ground) != self.tree.ncp or sum(gen_counts) != sum(pair) \
                or 3 * sum(pair) != self.nc - self.pair_off \
                or not ends.issuperset(np.cumsum(pair).tolist()):
            raise ValueError(
                f"the pair generators' contact counts {list(gen_counts)} do not match the "
                f"pair colors {pair} (rows {self.pair_off}–{self.nc} after "
                f"{self.tree.ncp} ground sites)"
            )

    def _pack_pairs(self) -> tuple[list, list]:
        """The pair section of the packed spec: per generator five ints
        [kind, the points' body, the other shape's body, contact count,
        offset of its floats in the section] and its floats — seg: [μ,
        r_a, r_b, a0, a1, b0, b1]; ptbox: [μ, r_p, box centre c, box
        rotation R (row-major), half-extents h, points]; ptseg: [μ, r_p,
        r_s, p0, p1, points]; every point and segment in its body's
        frame."""
        ints, floats = [], []
        for kind, g in (self.pairs.gens if self.pairs else ()):
            if kind == "seg":
                f = [g["mu"], g["ra"], g["rb"], *g["a0"], *g["a1"], *g["b0"], *g["b1"]]
                ints += [_GEN_KINDS[kind], g["ba"], g["bb"], 1, len(floats)]
            else:
                pts = np.asarray(g["pts"], np.float64).ravel().tolist()
                if kind == "ptbox":
                    f = [g["mu"], g["rp"], *g["c"], *np.ravel(g["R"]), *g["h"], *pts]
                else:
                    f = [g["mu"], g["rp"], g["rs"], *g["p0"], *g["p1"], *pts]
                ints += [_GEN_KINDS[kind], g["bp"], g["bf"], len(g["pts"]), len(floats)]
            floats += [float(x) for x in f]
        return ints, floats


def _mark_chain(tree: KinematicTree, need: list, body: int, what: int):
    """Mark ``body`` and its ancestors with ``what`` in ``need``."""
    while body >= 0:
        need[body] |= what
        body = tree.parent[body]


class SensorKernelSpec:
    """A sensor suite described for K2's sensor stage: after every
    ``k_obs``-th substep, measure at the accepted state, add the
    pre-sampled eps and push the delay lines. Types imu, encoder, effort
    and contact; a ``force`` sensor raises ValueError (the env then takes
    the chunked path, as the reference does). The corruption is sampled
    outside the kernel (:meth:`SensorSuite.sample_eps`): (B, n_upd·n_eps)
    with n_upd = n_sub / k_obs updates per launch."""

    def __init__(self, tree: KinematicTree, suite: SensorSuite, k_obs: int):
        self.suite = suite
        self.k_obs = int(k_obs)
        if self.k_obs < 1:
            raise ValueError(f"k_obs must be ≥ 1, got {k_obs}")
        for g in suite.groups:
            if g.type not in _SENSOR_CODES:
                raise ValueError(f"sensor type {g.type!r} is not supported by the kernel")
            if g.type == "imu" and any(tree.frame_body[f] < 0 for f in g.target):
                raise ValueError("an IMU on a world frame")
        self.n_groups = len(suite.groups)
        self.n_buf = suite.n_buf
        self.n_eps = suite.n_eps
        # one update's readings, the rows the warp body writes before the push
        self.n_rows = sum(g.ns * g.dim for g in suite.groups)
        self._tree = tree
        self._packed: dict = {}

    def check_kernel_caps(self, who: str):
        if not (1 <= self.n_groups <= MAX_SENS_GROUPS and self.n_buf <= MAX_SENS_BUF
                and self.n_eps <= MAX_SENS_EPS):
            raise ValueError(
                f"{who}: {self.n_groups} sensor groups, n_buf={self.n_buf}, "
                f"n_eps={self.n_eps} outside the sensor stage's caps (1–{MAX_SENS_GROUPS} "
                f"groups, n_buf ≤ {MAX_SENS_BUF}, n_eps ≤ {MAX_SENS_EPS})"
            )

    def packed(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(int32, float32) buffers on ``device`` as ``csrc/substep.cuh``
        `jt_sensor_stage` reads them; built once per device:

        - ints: per body what the readings need of it (1: its world
          rotation, for the IMUs' and contacts' bodies and their
          ancestors; 3: its velocity and proper acceleration too, for the
          IMUs' bodies and their ancestors; 0: nothing), per group [type,
          ns, buf_len, first sensor], then per sensor two ints: imu (body,
          offset of its 12 floats), encoder and effort (q offset, v
          offset), contact (contact, body);
        - floats: per IMU, its frame's rotation in the body (9, row-major)
          and position (3)."""
        key = str(device)
        if key not in self._packed:
            t = self._tree
            need, groups, sensors, floats = [0] * t.nb, [], [], []
            for g in self.suite.groups:
                groups += [_SENSOR_CODES[g.type], g.ns, g.buf_len, len(sensors) // 2]
                for k in g.target:
                    if g.type == "imu":
                        sensors += [t.frame_body[k], len(floats)]
                        floats += t.fp_rot[k].reshape(-1).tolist() + t.fp_pos[k].tolist()
                        _mark_chain(t, need, t.frame_body[k], _NEED_MOTION)
                    elif g.type == "contact":
                        sensors += [k, t.contact_body[k]]
                        _mark_chain(t, need, t.contact_body[k], _NEED_ROTATION)
                    else:
                        sensors += [t.q_off[k], t.v_off[k]]
            self._packed[key] = (
                torch.as_tensor(need + groups + sensors, dtype=torch.int32, device=device),
                torch.as_tensor(floats or [0.0], dtype=torch.float32, device=device),
            )
        return self._packed[key]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def with_springs(tree: KinematicTree, q, tau):
    """τ (B, nv) with the joint springs added (the reference's
    ``_spring_torques``): −k·q on the sprung 1-DoF joints, −k·log(quat)
    on the 3 dofs of each sprung SPHERICAL joint (the flexibility
    joints); τ itself when the tree has none."""
    vo, qo = tree.sprung_joints
    svo, sqo = tree.sprung_spherical
    if not (vo or svo):
        return tau
    tau = tau.clone()
    if vo:
        tau[:, vo] = tau[:, vo] - tree.stiffness[vo] * q[:, qo]
    for v0, q0 in zip(svo, sqo):
        sl = slice(v0, v0 + 3)
        tau[:, sl] = tau[:, sl] - tree.stiffness[sl] * so3.quat_log(q[:, q0:q0 + 4])
    return tau


def torque_reference(spec: SubstepSpec, q, v, cmd, mscale=None):
    """Actuation torque (B, nv) of the declarative path ``spec.torque``
    at (q, v) for the held command ``cmd`` (B, nm): the motors, joint
    damping and the 1-DoF springs' −k·q. ``mscale``: optional per-env
    (gain, friction scale), (B, nm) each (``Motors.compute_effort``)."""
    ts = spec.torque
    if ts.mode == "pd":
        kw = dict(dtype=q.dtype, device=q.device)
        qm, vm = spec.motors.joint_state(q, v)
        cmd = torch.as_tensor(ts.kp, **kw) * (cmd - qm) - torch.as_tensor(ts.kd, **kw) * vm
    return with_springs(spec.tree, q, spec.motors.compute_effort(cmd, v, mscale)
                        - spec.tree.damping * v)


def unpack_model_params(spec: SubstepSpec, mp):
    """Each env's packed model parameters (B, n_mp) → (Inertials, the
    motor (gain, friction scale) (B, nm) each, or None without a torque
    path), as the reference's ``_unpack_mp`` reads the row: the inertia
    rebuilt symmetric from its xx, yy, zz, xy, xz, yz."""
    t = spec.tree
    nb, B = t.nb, mp.shape[0]
    mass, h, i6, arm, tail = torch.split(
        mp, (nb, 3 * nb, 6 * nb, t.nv, mp.shape[1] - 10 * nb - t.nv), dim=1)
    xx, yy, zz, xy, xz, yz = i6.reshape(B, nb, 6).unbind(-1)
    inertia = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], -1).reshape(B, nb, 3, 3)
    inertials = Inertials(mass=mass, h=h.reshape(B, nb, 3), inertia=inertia, armature=arm)
    if spec.torque is None:
        return inertials, None
    gain, fric = tail.split(spec.torque.nm, dim=1)
    return inertials, (gain, fric)


def _check_mp(name, spec: SubstepSpec, mp, B):
    """``mp`` is None or each env's packed model parameters (B, n_mp)."""
    if mp is not None and tuple(mp.shape) != (B, spec.n_mp):
        raise ValueError(f"{name}: model parameters mp of shape {tuple(mp.shape)}, expected "
                         f"({B}, {spec.n_mp})")


def _check_gc(name, spec: SubstepSpec, gc, B):
    """``gc`` goes with an analytic ground: (B, n_gc), else None."""
    if spec.n_gc == 0:
        if gc is not None:
            raise ValueError(f"{name}: ground coefficients given for a {spec.ground_mode} ground")
    elif gc is None or tuple(gc.shape) != (B, spec.n_gc):
        got = None if gc is None else tuple(gc.shape)
        raise ValueError(f"{name}: a {spec.ground_mode} ground needs its coefficients gc "
                         f"({B}, {spec.n_gc}), got {got}")


def substep_reference(spec: SubstepSpec, q, v, tau, lam0, wrench=None, solve=None, gc=None,
                      mp=None, fext=None, friction=None, t=None, contacts=None, m_eff=None):
    """One semi-implicit Euler substep with velocity-level PGS impulses
    for kinematic constraints, joint bounds, ground contacts and collision
    pairs, joint damping and springs implicit: q (B, nq), v and τ (B, nv),
    λ0 (B, nc), ``wrench`` None or (B, 6) local [ang; lin] on the root
    body → (q⁺, v⁺, λ, residual (B,), world contact impulses (B, ncp,
    3) in the original contact order). ``solve`` runs the chain:
    the plain chain (``None``, the default) or a wrapper of the chain
    kernel, called as ``solve(cfg, M, p, v, J, target, mu, active, λ0)``.
    ``gc`` (B, n_gc): each env's analytic ground (None: the spec's
    own ground), which the sphere and wheel constraints roll on too.
    ``mp`` (B, n_mp): each env's packed model parameters (None: the
    tree's inertials); the motor tail is not read here. ``fext`` (B, nb,
    6) or (nb, 6): each body's local [ang; lin] wrench, the root's added
    to ``wrench``. ``friction`` (B,) or a float: each env's friction on
    the ground-contact rows (None: the spec's); the pair rows keep their
    pair's. ``t`` (B,): each env's time, which the spec's registered
    forces read. With penalty contacts (``spec.penalty``) their wrenches
    join ``fext`` (``contacts``: a ContactParams, each field a float or
    (B,), None for the options'; ``m_eff`` (ncp,): the sites' tangential
    effective masses for the friction clamp, or None), and the impulses
    returned are their forces × dt. With no row (nc = 0) no solve runs."""
    solve = solve if solve is not None else chain.solve_reference
    tree, opts = spec.tree, spec.options
    dt = spec.dt
    B = q.shape[0]
    inertials = unpack_model_params(spec, mp)[0] if mp is not None else None
    xl = algos.local_transforms(tree, q)
    xw, vel = algos.kinematics(tree, q, v, xl=xl)
    ground = spec.ground_of(gc)
    # implicit joint damping and springs (τ holds −K·q already):
    # (M + dt·C + dt²·K)·Δv = dt·(τ − C·v − dt·K·v − bias)
    M = algos.crba(tree, q, xl=xl, inertials=inertials)
    if spec.springs:
        M = M + torch.diag(dt * tree.damping + dt * dt * tree.stiffness)
        tau = tau - dt * tree.stiffness * v
    else:
        M = M + torch.diag(dt * tree.damping)
    if fext is not None:
        fext = fext.expand(B, tree.nb, 6)
    if wrench is not None:
        fext = q.new_zeros(B, tree.nb, 6) if fext is None else fext.clone()
        fext[:, 0] = fext[:, 0] + wrench
    if spec.forces:
        f_reg = registered.compute_forces(tree, spec.forces, t, xw, vel)
        fext = f_reg if fext is None else fext + f_reg
    if spec.penalty:
        f_pen, f_sd = compute_contact_fext(
            tree, xw, vel, ground, contacts if contacts is not None else opts.contacts, dt=dt,
            m_eff=m_eff, spheres=spec.spheres)
        fext = f_pen if fext is None else fext + f_pen
    bias = algos.rnea(tree, q, v, torch.zeros_like(v), fext=fext, xl=xl, inertials=inertials)
    p_free = tau - bias

    ncp = tree.ncp
    if spec.nc == 0:  # nothing to solve: the free motion
        v_next = v + dt * linalg.solve_psd(M, p_free)
        impulse = f_sd * dt if spec.penalty else q.new_zeros(B, ncp, 3)
        return (algos.integrate(tree, q, v_next, dt), v_next, q.new_zeros(B, 0),
                q.new_zeros(B), impulse)
    Js, targets, actives, mus = [], [], [], []
    if spec.constraints:
        Jd, td, _ = cstr.assemble(tree, spec.constraints, q, xw, dt, ground)
        Js.append(Jd)
        targets.append(td)
        actives.append(torch.ones_like(td))
        mus.append(torch.zeros_like(td))
    if spec.bounded_joints:
        Jb, tb = cstr.bound_rows(tree, spec.bounded_joints, q, dt, spec.alpha_bounds)
        Js.append(Jb)
        targets.append(tb)
        actives.append(torch.ones_like(tb))
        mus.append(torch.zeros_like(tb))
    rows = ncp and spec.contact_rows
    if rows:
        pts, _, depth, n = surface_contacts(tree, xw, vel, ground, spec.spheres)
        t1, t2 = cstr.tangent_basis(n)
        # penetrating: Baumgarte push-back; hovering within the margin:
        # may approach the surface but not cross it
        v_corr = torch.where(
            depth > 0.0,
            torch.clamp(
                spec.alpha_c_over_dt * (depth - opts.contact_slop),
                0.0, opts.contact_max_correction_vel,
            ),
            depth / dt,
        )
        order = spec.color_order
        Jp = torch.stack(
            [algos.point_jacobian(tree, xw, tree.contact_body[k], pts[:, k]) for k in order],
            dim=1,
        )  # (B, ncp, 3, nv)
        basis = torch.stack([t1, t2, n], dim=-2)[:, order]  # (B, ncp, 3, 3)
        Js.append((basis @ Jp).reshape(B, 3 * ncp, tree.nv))
        tgt = torch.zeros_like(basis[..., 0])
        tgt[..., 2] = v_corr[:, order]
        targets.append(tgt.reshape(B, 3 * ncp))
        act = (depth > -opts.contact_margin)[:, order].to(q.dtype)
        actives.append(act[:, :, None].expand(-1, -1, 3).reshape(B, 3 * ncp))
        mu_g = spec.friction if friction is None else friction
        if torch.is_tensor(mu_g):
            mus.append(mu_g.to(q.dtype).reshape(-1, 1).expand(B, 3 * ncp))
        else:
            mus.append(torch.full_like(targets[-1], mu_g))
    if spec.pairs is not None:
        for acc, x in zip((Js, targets, actives, mus), collision.pair_rows(
                spec.pairs, tree, xw, dt, spec.alpha_c_over_dt, opts.contact_margin,
                opts.contact_slop, opts.contact_max_correction_vel)):
            acc.append(x)

    J = torch.cat(Js, dim=1)
    target = torch.cat(targets, dim=1)
    active = torch.cat(actives, dim=1)
    mu = torch.cat(mus, dim=1)
    v_next, lam, residual = solve(spec.cfg, M, p_free, v, J, target, mu, active, lam0)
    q_next = algos.integrate(tree, q, v_next, dt)

    if rows:
        off = spec.contact_off
        lam_c = lam[:, off:off + 3 * ncp].reshape(B, ncp, 3)[:, spec.color_inverse]
        impulse = t1 * lam_c[..., 0:1] + t2 * lam_c[..., 1:2] + n * lam_c[..., 2:3]
    elif spec.penalty:
        impulse = f_sd * dt
    else:
        impulse = q.new_zeros(B, ncp, 3)
    return q_next, v_next, lam, residual, impulse


def sensor_stage_reference(sensors: SensorKernelSpec, q, v, a, f_contact, tau, eps, bufs):
    """One sensor update at an accepted state (q⁺, v⁺, a = Δv/dt, contact
    forces = impulses/dt (B, ncp, 3), τ) with one update's eps (B,
    n_eps): the suite's own ``update`` on the flattened buffers (B,
    n_buf) → the new flattened buffers."""
    suite = sensors.suite
    return suite.flatten_buffers(
        suite.update(suite.unflatten_buffers(bufs), eps, q, v, a, f_contact, tau)
    )


def _check_sensor_args(sensors, n_sub, B, bufs, eps):
    if (sensors is None) != (bufs is None) or (sensors is None) != (eps is None):
        raise ValueError("bufs and eps go with sensors, all three or none")
    if sensors is None:
        return
    if n_sub % sensors.k_obs:
        raise ValueError(f"n_sub={n_sub} is not a multiple of k_obs={sensors.k_obs}")
    n_eps = n_sub // sensors.k_obs * sensors.n_eps
    if tuple(bufs.shape) != (B, sensors.n_buf) or tuple(eps.shape) != (B, n_eps):
        raise ValueError(
            f"bufs {tuple(bufs.shape)} and eps {tuple(eps.shape)}: expected "
            f"({B}, {sensors.n_buf}) and ({B}, {n_eps})"
        )


def substep_multi_reference(
    spec: SubstepSpec, n_sub: int, q, v, cmd, lam0, wrench=None,
    sensors: SensorKernelSpec | None = None, bufs=None, eps=None, gc=None, mp=None,
):
    """``n_sub`` chained substeps with τ recomputed from the held command
    ``cmd`` (B, nm) before each → (q⁺, v⁺, λ, residual, impulses (B, ncp,
    3), a, τ), the last three of the last substep; a = (v⁺ − v)/dt. With
    ``sensors``, after each substep i with (i + 1) % k_obs == 0 the
    sensor update u = (i + 1)/k_obs − 1 runs at that substep's accepted
    state with eps[:, u·n_eps:(u + 1)·n_eps], and the new buffers (B,
    n_buf) are returned last. ``gc`` as in :func:`substep_reference`;
    ``mp`` (B, n_mp) each env's packed model parameters, the motor tail
    scaling τ."""
    if spec.torque is None:
        raise ValueError("the multi-substep path needs spec.torque")
    if n_sub < 1:
        raise ValueError(f"n_sub must be ≥ 1, got {n_sub}")
    _check_sensor_args(sensors, n_sub, q.shape[0], bufs, eps)
    _check_mp("substep_multi_reference", spec, mp, q.shape[0])
    mscale = unpack_model_params(spec, mp)[1] if mp is not None else None
    lam = lam0
    for i in range(n_sub):
        tau = torque_reference(spec, q, v, cmd, mscale)
        q_next, v_next, lam, res, impulse = substep_reference(spec, q, v, tau, lam, wrench, gc=gc,
                                                              mp=mp)
        a = (v_next - v) / spec.dt
        if sensors is not None and (i + 1) % sensors.k_obs == 0:
            u = (i + 1) // sensors.k_obs - 1
            e = eps[:, u * sensors.n_eps:(u + 1) * sensors.n_eps]
            bufs = sensor_stage_reference(
                sensors, q_next, v_next, a, impulse / spec.dt, tau, e, bufs
            )
        q, v = q_next, v_next
    out = (q, v, lam, res, impulse, a, tau)
    return out if sensors is None else out + (bufs,)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


@functools.cache
def _kernel(randomized: bool):
    """The library of the nominal instantiations (``csrc/substep.cu``) or
    of the randomized ones (``csrc/substep_rand.cu``); both export the
    same entry points, the second requiring the model parameters."""
    from jiminy_tpu_torch.ops import _build

    return bind(_build.load("substep_rand" if randomized else "substep"))


def bind(lib):
    """``lib``, a library built from ``csrc/substep.cuh``, with its entry
    points' ctypes signatures set."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [vp, ci, ci, cf, cf, cf, ci, vp]  # layout, len, iters, dt, relax, reg, resid, stream
    gc = [vp, ci, vp, ci]  # ground coefficients, their width; model parameters, their width
    wl = [vp, ci]  # the warp body's workspace layout, its length
    lib.jt_substep.argtypes = [vp] * 12 + [ci] * 6 + gc + wl + tail
    lib.jt_substep.restype = ci
    lib.jt_substep_multi.argtypes = [vp] * 14 + [ci] * 8 + gc + wl + tail
    lib.jt_substep_multi.restype = ci
    lib.jt_substep_multi_sensors.argtypes = [vp] * 19 + [ci] * 12 + gc + wl + tail
    lib.jt_substep_multi_sensors.restype = ci
    lib.jt_warp_occupancy.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
    lib.jt_warp_occupancy.restype = ci
    lib.jt_substep_error_string.argtypes = [ci]
    lib.jt_substep_error_string.restype = ctypes.c_char_p
    return lib


def _device_of(name, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_inputs(name, items):
    for arg, (t, shape) in items.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.jt_substep_error_string(err).decode()} (cudaError {err})"
        )


def _tail(spec: SubstepSpec, device):
    cfg = spec.cfg
    layout = chain._layout(cfg)
    c_layout = (ctypes.c_int * len(layout))(*layout)
    stream = torch.cuda.current_stream(device).cuda_stream
    return [
        ctypes.cast(c_layout, ctypes.c_void_p), len(layout), cfg.iters, cfg.dt,
        cfg.relax, cfg.reg, int(cfg.compute_residual), stream,
    ], c_layout


def _warp_ints(ws: WarpWorkspace):
    """The kernels' (pointer, length) of the layout's ints, and the int
    array the pointer names (kept alive by the caller)."""
    c_wl = (ctypes.c_int * len(ws.ints))(*ws.ints)
    return [ctypes.cast(c_wl, ctypes.c_void_p), len(ws.ints)], c_wl


def _outputs(spec: SubstepSpec, B, device, extra=0):
    t = spec.tree
    shapes = [(B, t.nq), (B, t.nv), (B, spec.nc), (B,), (B, t.ncp, 3)] + [(B, t.nv)] * extra
    return [torch.empty(s, dtype=torch.float32, device=device) for s in shapes]


def _gc_args(spec: SubstepSpec, gc, mp):
    """The kernels' (pointer, width) of the ground coefficients and of the
    model parameters."""
    return ([gc.data_ptr(), spec.n_gc] if gc is not None else [None, 0]) + (
        [mp.data_ptr(), spec.n_mp] if mp is not None else [None, 0])


def _count(fn, sensors, gc, mp):
    """Add one to the launch counter of the instantiation that ran:
    ``[rand_][sensor_][ground_]launches``."""
    name = (("rand_" if mp is not None else "") + ("sensor_" if sensors is not None else "")
            + ("ground_" if gc is not None else "") + "launches")
    setattr(fn, name, getattr(fn, name) + 1)


def substep_batched(spec: SubstepSpec, q, v, tau, lam0, wrench, gc=None, mp=None):
    """K3, one substep with τ given: q (B, nq), v and τ (B, nv), λ0
    (B, nc), wrench (B, 6), for an analytic ground each env's
    coefficients gc (B, n_gc), and for a randomized model each env's
    packed model parameters mp (B, n_mp), all on one device → (q⁺, v⁺, λ,
    residual (B,), impulses (B, ncp, 3)). On CUDA tensors this launches
    the kernel (float32, contiguous; the warp body in K2's workspace
    without the sensor stage, :meth:`SubstepSpec.warp_workspace`) and
    raises on anything else; on CPU tensors it runs
    :func:`substep_reference`. Each instantiation counts its launches:
    ``.launches`` (flat, nominal), ``.ground_launches``, ``.rand_launches``
    and ``.rand_ground_launches``; ``.warp_launches`` counts those that
    ran the warp body, which every launch does."""
    _check_gc("substep_batched", spec, gc, q.shape[0])
    _check_mp("substep_batched", spec, mp, q.shape[0])
    extra = tuple(x for x in (gc, mp) if x is not None)
    dev = _device_of("substep_batched", q, v, tau, lam0, wrench, *extra)
    if dev.type == "cpu":
        return substep_reference(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
    t, B = spec.tree, q.shape[0]
    _check_inputs("substep_batched", {
        "q": (q, (B, t.nq)), "v": (v, (B, t.nv)), "tau": (tau, (B, t.nv)),
        "lam0": (lam0, (B, spec.nc)), "wrench": (wrench, (B, 6)),
        **({"gc": (gc, (B, spec.n_gc))} if gc is not None else {}),
        **({"mp": (mp, (B, spec.n_mp))} if mp is not None else {}),
    })
    spec.check_kernel_caps("substep_batched")
    lib = _kernel(mp is not None)
    si, sf = spec.packed(dev)
    outs = _outputs(spec, B, dev)
    tail, _layout_alive = _tail(spec, dev)  # the int array the pointer in tail names
    wl, _wl_alive = _warp_ints(spec.warp_workspace())
    err = lib.jt_substep(
        si.data_ptr(), sf.data_ptr(), q.data_ptr(), v.data_ptr(), tau.data_ptr(),
        lam0.data_ptr(), wrench.data_ptr(), *(o.data_ptr() for o in outs),
        B, t.nb, t.nq, t.nv, spec.nc, spec.n_dist, *_gc_args(spec, gc, mp), *wl, *tail,
    )
    _raise_on(lib, err, "substep")
    _count(substep_batched, None, gc, mp)
    substep_batched.warp_launches += 1
    return tuple(outs)


for _name in ("launches", "ground_launches", "rand_launches", "rand_ground_launches"):
    setattr(substep_batched, _name, 0)
substep_batched.warp_launches = 0  # of the above, those of the warp body: all


def warp_blocks_per_sm(ws: WarpWorkspace, sensors: bool, ground: bool, randomized: bool,
                       multi: bool = True) -> int:
    """Blocks of the warp body (W warps of ``ws``) one SM of the card holds
    at once, its registers and shared memory both counted, for K2's
    instantiation (``multi``) with or without the sensor stage, or K3's,
    with or without the ground query and the model parameters
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if sensors and not multi:
        raise ValueError("K3 has no sensor stage")
    lib = _kernel(randomized)
    blocks = ctypes.c_int(0)
    err = lib.jt_warp_occupancy(int(multi), int(sensors), int(ground), ws.W, ws.bytes_per_env,
                                ctypes.byref(blocks))
    _raise_on(lib, err, "warp occupancy")
    return blocks.value


def substep_batched_multi(
    spec: SubstepSpec, n_sub: int, q, v, cmd, lam0, wrench,
    sensors: SensorKernelSpec | None = None, bufs=None, eps=None, gc=None, mp=None,
):
    """K2, ``n_sub`` substeps in one launch with τ recomputed in-kernel
    from the held command: q (B, nq), v (B, nv), cmd (B, nm), λ0 (B, nc),
    wrench (B, 6) → (q⁺, v⁺, λ, residual (B,), impulses (B, ncp, 3),
    a (B, nv), τ (B, nv)), the last three of the last substep. With
    ``sensors`` (a :class:`SensorKernelSpec`), ``bufs`` (B, n_buf) and
    ``eps`` (B, n_sub/k_obs·n_eps), the kernel's sensor stage runs after
    every k_obs-th substep and the new buffers are returned last. For an
    analytic ground, ``gc`` (B, n_gc) holds each env's coefficients; for
    a randomized model, ``mp`` (B, n_mp) each env's packed model
    parameters (inertials, armature, motor gain and friction scale). Needs
    ``spec.torque``. On CUDA tensors this launches the kernel (float32,
    contiguous) and raises on anything else; on CPU tensors it runs
    :func:`substep_multi_reference`. Each instantiation counts its own
    launches: ``.launches`` (flat, no sensors, nominal),
    ``.sensor_launches``, ``.ground_launches``,
    ``.sensor_ground_launches``, and the randomized ones under the same
    names with ``rand_`` in front; ``.warp_launches`` counts those that ran
    the warp body, which every launch does (its layout
    :meth:`SubstepSpec.warp_workspace`)."""
    if spec.torque is None:
        raise ValueError("substep_batched_multi needs spec.torque")
    if n_sub < 1:
        raise ValueError(f"n_sub must be ≥ 1, got {n_sub}")
    _check_sensor_args(sensors, n_sub, q.shape[0], bufs, eps)
    _check_gc("substep_batched_multi", spec, gc, q.shape[0])
    _check_mp("substep_batched_multi", spec, mp, q.shape[0])
    extra = (() if sensors is None else (bufs, eps)) + tuple(x for x in (gc, mp) if x is not None)
    dev = _device_of("substep_batched_multi", q, v, cmd, lam0, wrench, *extra)
    if dev.type == "cpu":
        return substep_multi_reference(
            spec, n_sub, q, v, cmd, lam0, wrench, sensors=sensors, bufs=bufs, eps=eps, gc=gc,
            mp=mp,
        )
    t, B, nm = spec.tree, q.shape[0], spec.torque.nm
    items = {
        "q": (q, (B, t.nq)), "v": (v, (B, t.nv)), "cmd": (cmd, (B, nm)),
        "lam0": (lam0, (B, spec.nc)), "wrench": (wrench, (B, 6)),
    }
    if sensors is not None:
        items.update({"bufs": (bufs, tuple(bufs.shape)), "eps": (eps, tuple(eps.shape))})
    if gc is not None:
        items["gc"] = (gc, (B, spec.n_gc))
    if mp is not None:
        items["mp"] = (mp, (B, spec.n_mp))
    _check_inputs("substep_batched_multi", items)
    spec.check_kernel_caps("substep_batched_multi")
    lib = _kernel(mp is not None)
    si, sf = spec.packed(dev)
    outs = _outputs(spec, B, dev, extra=2)
    tail, _layout_alive = _tail(spec, dev)
    wl, _wl_alive = _warp_ints(spec.warp_workspace(sensors))
    head = [
        si.data_ptr(), sf.data_ptr(), q.data_ptr(), v.data_ptr(), cmd.data_ptr(),
        lam0.data_ptr(), wrench.data_ptr(), *(o.data_ptr() for o in outs),
    ]
    dims = [B, n_sub, t.nb, t.nq, t.nv, spec.nc, spec.n_dist, nm]
    if sensors is None:
        err = lib.jt_substep_multi(*head, *dims, *_gc_args(spec, gc, mp), *wl, *tail)
    else:
        sensors.check_kernel_caps("substep_batched_multi")
        gi, gf = sensors.packed(dev)
        outs.append(torch.empty(B, sensors.n_buf, dtype=torch.float32, device=dev))
        err = lib.jt_substep_multi_sensors(
            *head, gi.data_ptr(), gf.data_ptr(), bufs.data_ptr(), eps.data_ptr(),
            outs[-1].data_ptr(), *dims, sensors.n_groups, sensors.n_buf,
            sensors.n_eps, sensors.k_obs, *_gc_args(spec, gc, mp), *wl, *tail,
        )
    _raise_on(lib, err, "substep_multi")
    _count(substep_batched_multi, sensors, gc, mp)
    substep_batched_multi.warp_launches += 1
    return tuple(outs)


for _name in ("launches", "sensor_launches", "ground_launches", "sensor_ground_launches"):
    setattr(substep_batched_multi, _name, 0)
    setattr(substep_batched_multi, "rand_" + _name, 0)
substep_batched_multi.warp_launches = 0  # of the above, those of the warp body
