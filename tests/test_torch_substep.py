"""The port's whole-substep path against jiminy_tpu's engine.

Inputs are made with numpy from a seed: perturbed ANYmal stand poses
(feet penetrating, hovering within the contact margin and clear of it),
random velocities, warm-start impulses, PD targets and a nonzero root
wrench. The port's model comes from the reference's arrays
(``tree_from_arrays``, ``motors_from_arrays``), so both sides hold the
same constants.

- The plain single substep (what every backend of the port runs on the
  CPU: ``substep_reference``) with a base wrench matches the reference
  ``constraint_solver="xla"`` substep in float64 (jax x64 on, as
  tests/test_x64_parity.py runs it): τ to 1e-12, q to 1e-9, v, λ and the
  residual to 1e-7, contact forces and a (both ÷ dt) to 1e-7/dt. The
  floor is the reference's, not f64 rounding: its CRBA adds the composite
  masses of its float32 model constants in float32 even with x64 on
  (M[0, 0] = 28.39999771 against 28.3999992609), so its M·a misses its
  own RNEA by ~3e-6 and its v by ~4e-8 per substep; the port's float64
  CRBA agrees with its RNEA to 1e-13 (tests/test_torch_model.py).
- ``Engine.step`` with ``constraint_solver="substep"`` over 4 substeps
  with ``PDController`` (fused: ``substep_multi_reference``; unfused:
  ``substep_reference`` per substep) matches the reference ``"xla"`` step
  within tests/test_substep_multi.py's own tolerances.
- ``SubstepSpec`` and ``TorqueSpec`` hold the reference's
  ``Engine._substep_spec`` layout: bounded joints, color order, rows and
  the torque path.
- On CPU tensors the kernel wrappers run the plain versions and launch
  nothing.
- ``constraint_solver="auto"`` (the default) picks the whole-substep
  kernels within their caps, the chain kernel beyond them where it takes
  the system, and the plain physics beyond both (nv > 32, nc > 48); the
  PD law as an opaque controller and as ``PDController`` give the same
  step.

The fused Pallas kernel itself (interpret mode) is held against the plain
version in tests/test_torch_substep_interpret.py; the CUDA kernels on the
card in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.envs import ANYmalEnv
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.ops.constraint_solve import solve_batched
from jiminy_tpu_torch.ops.substep_kernel import (
    MAX_NV,
    SubstepSpec,
    substep_batched,
    substep_batched_multi,
    substep_multi_reference,
    substep_reference,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
DT = 5e-3
KP, KD = 80.0, 2.0
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")


@pytest.fixture(scope="module")
def robot():
    """The reference ANYmal (float32 constants) and the port's model made
    from its arrays."""
    jrobot = j_make_anymal()
    tree = tree_from_arrays(
        {k: np.asarray(getattr(jrobot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS},
        device="cpu",
    )
    motors = motors_from_arrays(
        {k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS}, device="cpu"
    )
    return jrobot, tree, motors


def _inputs(jrobot, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (B, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    q[:, 2] += rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    u = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate(
        [5.0 * rng.standard_normal((B, 3)), 20.0 * rng.standard_normal((B, 3))], 1
    )
    return q, v, lam, u, wrench


def _jax_step(jrobot, arrays, n_substeps, dtype):
    """The reference engine (``constraint_solver="xla"``) from the given
    state, vmapped: the SimState fields as numpy arrays."""
    q, v, lam, u, wrench = (jnp.asarray(a, dtype) for a in arrays)
    eng = JEngine(
        jrobot.tree,
        JEngineOptions(
            contact_model="constraint", constraint_solver="xla", dt=DT,
            pgs_iters=8, compute_solver_residual=True,
        ),
        motors=jrobot.motors,
        controller=JPDController(KP, KD),
    )
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q)
    states = states.replace(v=v, lam=lam)
    step = jax.jit(jax.vmap(
        lambda s, uu, w: eng.step(s, uu, n_substeps=n_substeps, base_wrench=w)
    ))
    out = step(states, u, wrench)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _port_engine(tree, motors, solver, dtype, fusion=True):
    opts = EngineOptions(
        contact_model="constraint",
        dt=DT, pgs_iters=8, compute_solver_residual=True,
        constraint_solver=solver, substep_fusion=fusion,
    )
    return Engine(
        tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
        controller=PDController(KP, KD), device="cpu",
    )


def _port_step(engine, arrays, n_substeps, dtype):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    state = engine.reset(q, v)
    state.lam = lam
    out = engine.step(state, u, n_substeps=n_substeps, base_wrench=wrench)
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


@pytest.mark.parametrize("solver", ["substep", "kernel", "inline"])
def test_plain_substep_matches_reference_in_f64(robot, solver):
    jrobot, tree, motors = robot
    arrays = _inputs(jrobot, seed=0)
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    ref = _jax_step(jrobot, arrays, 1, jnp.float64)
    assert ref["q"].dtype == np.float64
    out = _port_step(_port_engine(tree, motors, solver, torch.float64), arrays, 1, torch.float64)
    assert np.abs(ref["lam"]).max() > 0.1  # contacts and bounds engaged
    atol = {"t": 1e-12, "tau": 1e-12, "q": 1e-9, "v": 1e-7, "lam": 1e-7,
            "solver_residual": 1e-7, "contact_forces": 1e-7 / DT, "a": 1e-7 / DT}
    for k, tol in atol.items():
        np.testing.assert_allclose(out[k], ref[k], atol=tol, rtol=0, err_msg=k)


def _assert_close_multi(a, b):
    """tests/test_substep_multi.py ``_assert_close``: a the reference, b
    the port."""
    np.testing.assert_allclose(b["q"], a["q"], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(b["v"], a["v"], atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(b["a"], a["a"], atol=2.0, rtol=1e-2)
    np.testing.assert_allclose(b["tau"], a["tau"], atol=1e-2, rtol=1e-3)
    scale = max(1.0, float(np.max(np.abs(a["contact_forces"]))))
    np.testing.assert_allclose(
        b["contact_forces"] / scale, a["contact_forces"] / scale, atol=5e-3
    )


@pytest.mark.parametrize("fusion", [True, False])
def test_substep_step_matches_reference(robot, fusion):
    """Four substeps with PD and a root wrench, float32 on both sides."""
    jrobot, tree, motors = robot
    arrays = _inputs(jrobot, seed=1)
    ref = _jax_step(jrobot, arrays, 4, jnp.float32)
    eng = _port_engine(tree, motors, "substep", torch.float32, fusion=fusion)
    out = _port_step(eng, arrays, 4, torch.float32)
    _assert_close_multi(ref, out)
    np.testing.assert_allclose(out["t"], ref["t"], atol=1e-6, rtol=0)


def test_base_wrench_moves_the_base(robot):
    """A pure force along +x on the root changes v_x by about F·dt/m_eff
    against the same step without it: the wrench reaches the dynamics."""
    jrobot, tree, motors = robot
    q, v, lam, u, _ = _inputs(jrobot, seed=2)
    q[:, 2] += 0.5  # airborne: no contact impulse absorbs the push
    eng = _port_engine(tree, motors, "substep", torch.float64)
    push = np.zeros((B, 6))
    push[:, 3] = 100.0
    free = _port_step(eng, (q, v, lam, u, np.zeros((B, 6))), 1, torch.float64)
    pushed = _port_step(eng, (q, v, lam, u, push), 1, torch.float64)
    dv = pushed["v"][:, 0] - free["v"][:, 0]
    mass = float(tree.inertia_mass.sum())
    assert np.all(dv > 0.2 * 100.0 * DT / mass)


@pytest.fixture(scope="module")
def specs(robot):
    """The reference's ``_substep_spec`` (PD engine) and the port's."""
    jrobot, tree, motors = robot
    jeng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="pallas_substep",
                       dt=DT, pgs_iters=8),
        motors=jrobot.motors,
        controller=JPDController(KP, KD),
    )
    eng = _port_engine(tree, motors, "substep", torch.float32)
    return jeng._substep_spec, eng.substep_spec


SPEC_FIELDS = [
    "bounded_joints", "color_order", "cfg.nc", "cfg.n", "cfg.dt",
    "cfg.bounds_span", "cfg.contact_colors", "cfg.iters", "cfg.relax",
    "cfg.reg", "friction", "ground_height", "torque.mode", "torque.q_idx",
    "torque.v_idx", "torque.kp", "torque.kd", "torque.reduction",
    "torque.effort_limit", "torque.velocity_limit", "torque.friction_dry",
    "torque.friction_viscous", "torque.friction_vel_eps",
]


def _get(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


@pytest.mark.parametrize("field", SPEC_FIELDS)
def test_spec_matches_reference(specs, field):
    ref, port = (_get(s, field) for s in specs)
    if isinstance(ref, (list, tuple)) and ref and isinstance(ref[0], float):
        np.testing.assert_allclose(port, ref, rtol=1e-7, atol=0)
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=1e-7)
    else:
        assert tuple(port) == tuple(ref) if isinstance(ref, (list, tuple)) else port == ref


def test_direct_command_spec_matches_reference(robot):
    """No controller: the command goes to the motors (mode "direct")."""
    jrobot, tree, motors = robot
    jeng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="pallas_substep", dt=DT),
        motors=jrobot.motors,
    )
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT), motors=motors,
                 device="cpu")
    ref, port = jeng._substep_spec.torque, eng.substep_spec.torque
    assert port.mode == ref.mode == "direct"
    assert port.kp is None and ref.kp is None
    assert tuple(port.v_idx) == tuple(ref.v_idx)


def test_auto_picks_the_whole_substep_kernel(robot):
    """The default ``constraint_solver="auto"`` runs the whole-substep
    kernels for a model within their caps, as the reference's ``"auto"``
    does on the accelerator; the env inherits the choice."""
    _, tree, motors = robot
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT), motors=motors,
                 controller=PDController(KP, KD), device="cpu")
    assert eng.options.constraint_solver == "auto"
    assert eng.backend == "substep"
    assert ANYmalEnv(observe="state", device="cpu").engine.backend == "substep"
    assert ANYmalEnv(observe="state", constraint_solver="kernel",
                     device="cpu").engine.backend == "kernel"


def _chain_tree(nb):
    """A chain of ``nb`` bounded revolute links under a free base, one
    contact point at its tip."""
    b = TreeBuilder()
    b.add_body("base", -1, JointType.FREE, mass=5.0, inertia=(0.1, 0.1, 0.1))
    for i in range(1, nb):
        b.add_body(f"link{i}", i - 1, JointType.REVOLUTE, axis=(0, 1, 0),
                   placement=TreeBuilder.make_placement((0.0, 0.0, -0.1)),
                   mass=0.5, com=(0, 0, -0.05), inertia=(1e-3, 1e-3, 1e-3),
                   q_limits=(-1.0, 1.0))
    b.add_frame("tip", nb - 1)
    b.add_contact_point("tip", nb - 1, np.array([0.0, 0.0, -0.1], np.float32))
    return b.build(device="cpu")


def test_auto_falls_back_beyond_the_kernel_caps():
    """Beyond the whole-substep kernels' caps, ``"auto"`` takes the chain
    kernel where it takes the system (a forest of five free bodies: nq =
    nv + 5 is beyond the whole-substep kernels' nq ≤ nv + 4, within the
    chain kernel's n ≤ 32) and the plain physics where the chain kernel
    does not either (nv 33 > 32); an explicit ``"substep"`` raises at
    construction."""
    nb = MAX_NV - 5  # nv = 6 + (nb − 1)
    small = Engine(_chain_tree(nb), EngineOptions(contact_model="constraint", dt=DT), device="cpu")
    assert small.tree.nv == MAX_NV and small.backend == "substep"
    big = _chain_tree(nb + 1)
    assert Engine(big, EngineOptions(contact_model="constraint", dt=DT),
                  device="cpu").backend == "inline"
    with pytest.raises(ValueError, match="caps"):
        Engine(big, EngineOptions(contact_model="constraint", dt=DT, constraint_solver="substep"),
               device="cpu")
    b = TreeBuilder()
    for i in range(5):
        b.add_frame(f"ball{i}", b.add_body(f"ball{i}", -1, JointType.FREE, mass=1.0,
                                           inertia=(1e-2, 1e-2, 1e-2)))
    forest = Engine(b.build(device="cpu"), EngineOptions(contact_model="constraint", dt=DT),
                    device="cpu")
    assert (forest.tree.nv, forest.tree.nq) == (30, 35) and forest.backend == "kernel"


def test_auto_takes_the_plain_physics_beyond_48_rows():
    """A model whose rows exceed the chains' cap (96 since the Atlas slice;
    48 before): Cassie's 28 and two box-box pairs' 32 contacts, nc 124;
    more than 24 pair contacts is beyond the whole-substep kernels too, as
    the reference gates them. It runs the plain physics under ``"auto"``
    on the CPU: the chain kernel's nc ≤ 96 would refuse it at the first
    step. On CUDA ``"auto"`` refuses it, naming the caps and
    ``"inline"``, rather than run the plain physics on the card."""
    from jiminy_tpu_torch.engine.collision import Box, CollisionPair
    from jiminy_tpu_torch.models import make_cassie
    from jiminy_tpu_torch.ops import constraint_solve as chain

    tree, motors, _, rods, stand = make_cassie(device="cpu")
    boxes = tuple(CollisionPair(Box(f"L_{b}", (0, 0, -h), (0.04, 0.04, h)),
                                Box(f"R_{b}", (0, 0, -h), (0.04, 0.04, h)))
                  for b, h in (("thigh", 0.17), ("shin", 0.15)))
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=2e-3, pgs_iters=8),
                 motors=motors,
                 controller=PDController(150.0, 6.0), constraints=rods, collision_pairs=boxes,
                 device="cpu")
    assert eng.substep_spec.n_pc == 32 and eng.nc == 28 + 96 and eng.backend == "inline"
    assert eng.nc > chain.MAX_NC == 96
    q = torch.as_tensor(stand)[None].repeat(2, 1)
    out = eng.step(eng.reset(q), torch.as_tensor(stand)[list(motors.q_idx)].repeat(2, 1))
    assert bool(torch.isfinite(out.q).all()) and out.lam.shape == (2, 124)
    with pytest.raises(ValueError, match=r"nc ≤ 96.*constraint_solver='inline'"):
        Engine.auto_backend(eng.substep_spec, torch.device("cuda"))
    assert Engine.auto_backend(eng.substep_spec, torch.device("cpu")) == "inline"


def test_opaque_controller_matches_declarative_pd(robot):
    """The same PD law as an opaque controller (outside the kernels,
    through the motor bank) and as ``PDController`` (``torque_reference``)
    gives the same torque and the same unfused step."""
    jrobot, tree, motors = robot
    q, v, lam, u, w = (torch.as_tensor(a) for a in _inputs(jrobot, seed=4))
    m64 = motors.to(dtype=torch.float64)

    def pd(cmd, qq, vv):
        qm, vm = m64.joint_state(qq, vv)
        return KP * (cmd - qm) - KD * vm

    opts = EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8, substep_fusion=False)
    declarative = _port_engine(tree, motors, "auto", torch.float64)
    opaque = Engine(tree.to(dtype=torch.float64), opts, motors=m64, controller=pd, device="cpu")
    assert opaque.substep_spec.torque is None and declarative.substep_spec.torque is not None
    torch.testing.assert_close(opaque._joint_torque(u, q, v),
                               declarative._joint_torque(u, q, v), atol=1e-12, rtol=0)
    a = _port_step(opaque, (q, v, lam, u, w), 4, torch.float64)
    b = _port_step(declarative, (q, v, lam, u, w), 4, torch.float64)
    for k in SIM_FIELDS:
        np.testing.assert_allclose(a[k], b[k], atol=1e-9, rtol=0, err_msg=k)


def test_packed_spec_layout(robot):
    """The packed buffers have the lengths csrc/substep.cu walks."""
    _, tree, motors = robot
    spec = _port_engine(tree, motors, "substep", torch.float32).substep_spec
    si, sf = spec.packed("cpu")
    nb, nv, ncp, nbj, nm = tree.nb, tree.nv, tree.ncp, len(spec.bounded_joints), 12
    assert si.dtype == torch.int32 and sf.dtype == torch.float32
    assert si[:9].tolist() == [nb, tree.nq, nv, ncp, nbj, nm, 1, 0, 0]  # PD, flat ground
    assert si.numel() == 10 + 4 * nb + 2 * ncp + nbj + 2 * nm
    assert sf.numel() == 16 + 28 * nb + 2 * nv + 3 * ncp + 2 * nbj + 8 * nm
    assert sf[0].item() == pytest.approx(DT)
    assert spec.packed("cpu")[0] is si  # built once per device


def test_cpu_tensors_run_the_plain_versions(robot):
    jrobot, tree, motors = robot
    eng = _port_engine(tree, motors, "substep", torch.float32)
    spec = eng.substep_spec
    q, v, lam, u, w = (torch.as_tensor(a, dtype=torch.float32) for a in _inputs(jrobot, seed=3))
    counts = (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches)
    tau = eng._joint_torque(u, q, v)
    for o, r in zip(substep_batched(spec, q, v, tau, lam, w),
                    substep_reference(spec, q, v, tau, lam, w)):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
    for o, r in zip(substep_batched_multi(spec, 4, q, v, u, lam, w),
                    substep_multi_reference(spec, 4, q, v, u, lam, w)):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
    assert counts == (solve_batched.launches, substep_batched.launches,
                      substep_batched_multi.launches)


def test_out_of_scope_raises(robot):
    _, tree, motors = robot

    class Stairs:  # not a ground of engine/ground.py
        height = 0.0

    with pytest.raises(TypeError, match="unknown ground"):
        SubstepSpec(tree, EngineOptions(contact_model="constraint"), Stairs())
    with pytest.raises(NotImplementedError, match="A.16"):
        SubstepSpec(tree, EngineOptions(contact_model="constraint", solver="runge_kutta_4"),
                    FlatGround())
    with pytest.raises(ValueError, match="unknown constraint_solver"):
        Engine(tree, EngineOptions(contact_model="constraint", constraint_solver="pallas"),
               device="cpu")
    spec = SubstepSpec(tree, EngineOptions(contact_model="constraint"),
                       FlatGround())  # no torque path
    with pytest.raises(ValueError, match="torque"):
        substep_batched_multi(spec, 4, *[torch.zeros(1, 1)] * 5)
