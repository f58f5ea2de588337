"""The port's distance constraint and joint springs against jiminy_tpu's.

The scene is tests/test_constraints.py's closed loop: two pendulums hung
side by side 0.5 m apart, their tips tied by a rod of 0.5 m; and the same
loop with the second tip replaced by a frame of the world (body −1), the
reference's trap case (``xw[-1]`` would alias the last body). Each tree
is built by both packages' ``TreeBuilder`` and held field for field.

- ``DistanceConstraint.rows`` and ``assemble`` against the reference's on
  random configurations in float64 (jax x64 on): J and the target within
  1e-12, the blocks equal.
- The reference's own property on the port's engine: the loop closes to
  2e-3 after 1 s and swings (tests/test_constraints.py
  ``test_closed_loop_distance_maintained``), with the second tip tied to
  the body and to the world.
- One substep of the loop from the same states matches the reference
  ``"xla"`` engine in float64 within 1e-9.
- 1-DoF joint springs: ``TreeBuilder(stiffness=)``, the actuation torque
  −k·q on Cassie against the reference engine's ``_joint_torque``, and a
  sprung pendulum's period.
- The engine refuses the other kinematic constraints (ROADMAP A.22);
  ``SubstepSpec`` takes springs on spherical joints (A.14, held in
  tests/test_torch_flex.py) and a tree with a sprung prismatic joint,
  whose type it packs as 2 for the kernels (A.15, held in
  tests/test_torch_prismatic.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.engine.constraints import DistanceConstraint as JDistance
from jiminy_tpu.engine.constraints import assemble as jassemble
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.constraints import (
    DistanceConstraint,
    assemble,
    distance_constraint_from_arrays,
)
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.ops.substep_kernel import SubstepSpec

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 6
DT = 1e-3


def _loop(tree_builder, joint_type, world_anchor):
    """The two-pendulum loop; with ``world_anchor`` the second tip is a
    frame of the world at (0.5, 0, −1), where the second pendulum's tip
    hangs at rest."""
    b = tree_builder()
    j1 = b.add_body("l1", -1, joint_type.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1))
    j2 = b.add_body("l2", -1, joint_type.REVOLUTE,
                    placement=tree_builder.make_placement(pos=(0.5, 0, 0)), axis=(0, 1, 0),
                    mass=1.0, com=(0, 0, -1))
    f1 = b.add_frame("tip1", j1, tree_builder.make_placement(pos=(0, 0, -1)))
    if world_anchor:
        f2 = b.add_frame("anchor", -1, tree_builder.make_placement(pos=(0.5, 0, -1)))
    else:
        f2 = b.add_frame("tip2", j2, tree_builder.make_placement(pos=(0, 0, -1)))
    return b, f1, f2


def _trees(world_anchor):
    """(reference tree, port tree from the port's own builder, f1, f2)."""
    jb, f1, f2 = _loop(JTreeBuilder, JJointType, world_anchor)
    pb, g1, g2 = _loop(TreeBuilder, JointType, world_anchor)
    assert (f1, f2) == (g1, g2)
    return jb.build(), pb.build(device="cpu", dtype=torch.float64), f1, f2


@pytest.mark.parametrize("world_anchor", [False, True], ids=["tip", "world"])
def test_loop_tree_matches_reference(world_anchor):
    jtree, tree, _, f2 = _trees(world_anchor)
    assert tree.frame_body[f2] == (-1 if world_anchor else 1)
    for k in STATIC_FIELDS:
        ref, got = getattr(jtree, k), getattr(tree, k)
        assert np.asarray(got).reshape(-1).tolist() == np.asarray(ref).reshape(-1).tolist(), k
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tree, k).numpy(), np.asarray(getattr(jtree, k)),
                                      err_msg=k)


@pytest.mark.parametrize("world_anchor", [False, True], ids=["tip", "world"])
def test_rows_and_assemble_match_reference(world_anchor):
    jtree, tree, f1, f2 = _trees(world_anchor)
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    jc = JDistance(frame1=f1, frame2=f2, distance=jnp.float32(0.45), baumgarte_freq=jnp.float32(20.0))
    pc = distance_constraint_from_arrays(
        {k: np.asarray(getattr(jc, k)) for k in ("frame1", "frame2", "distance", "baumgarte_freq")})
    assert pc == DistanceConstraint(f1, f2, float(np.float32(0.45)), 20.0)
    rng = np.random.default_rng(0)
    q = rng.uniform(-0.6, 0.6, (B, 2))

    def ref_rows(qq):
        xw, vel = jalgos.kinematics(jtree, qq, jnp.zeros(2))
        r = jc.rows(jtree, qq, jnp.zeros(2), xw, vel, DT)
        J, t, act, blocks = jassemble(jtree, (jc, jc), qq, jnp.zeros(2), xw, vel, DT)
        return r.J, r.target, J, t

    rJ, rt, aJ, at = (np.asarray(x) for x in jax.vmap(ref_rows)(jnp.asarray(q)))
    qt = torch.as_tensor(q)
    xw = algos.forward_kinematics(tree, qt)
    J, t = pc.rows(tree, qt, xw, DT)
    np.testing.assert_allclose(J.numpy(), rJ, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t.numpy(), rt, atol=1e-12, rtol=0)
    if world_anchor:  # the anchor adds nothing: only the first pendulum moves the row
        assert np.all(J[:, 0, 1].numpy() == 0) and np.all(np.abs(J[:, 0, 0].numpy()) > 0.1)
    J2, t2, blocks = assemble(tree, (pc, pc), qt, xw, DT)
    np.testing.assert_allclose(J2.numpy(), aJ, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t2.numpy(), at, atol=1e-12, rtol=0)
    assert [tuple(b) for b in blocks] == [("equality", 0, 1), ("equality", 1, 1)]
    J0, t0, b0 = assemble(tree, (), qt, xw, DT)
    assert J0.shape == (B, 0, 2) and t0.shape == (B, 0) and b0 == []


def _tip_distance(tree, c, q):
    xw = algos.forward_kinematics(tree, q)
    p1, p2 = c.points(tree, xw, q)
    return torch.linalg.vector_norm(p1 - p2, dim=-1)


@pytest.mark.parametrize("world_anchor", [False, True], ids=["tip", "world"])
def test_closed_loop_distance_maintained(world_anchor):
    """tests/test_constraints.py's property on the port's engine: from
    q = (0.3, 0.3) (the rod at its length) the loop holds to 2e-3 over
    1 s and swings. Tied to the world (the rod at its length at q = 0.3),
    the first pendulum is held where it is, the second swings free."""
    _, tree, f1, f2 = _trees(world_anchor)
    tree = tree.to(dtype=torch.float32)
    q0 = torch.tensor([[0.3, 0.3]])
    d0 = float(_tip_distance(tree, DistanceConstraint(f1, f2), q0)[0])
    c = DistanceConstraint(f1, f2, distance=d0 if world_anchor else 0.5, baumgarte_freq=20.0)
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT), constraints=(c,),
                 device="cpu")
    assert eng.backend == "substep" and eng.nc == 1
    st = eng.reset(q0)
    st = eng.step(st, torch.zeros(1, 2), n_substeps=1000)  # no motors: u is the joint torque
    assert abs(float(_tip_distance(tree, c, st.q)[0]) - c.distance) < 2e-3
    assert abs(float(st.q[0, 1]) - 0.3) > 0.05
    if world_anchor:
        assert abs(float(st.q[0, 0]) - 0.3) < 1e-2
    else:
        assert abs(float(st.q[0, 0]) - 0.3) > 0.05


@pytest.mark.parametrize("world_anchor", [False, True], ids=["tip", "world"])
def test_loop_substep_matches_reference_in_f64(world_anchor):
    """One substep of the loop (no contacts: nc = 1, the PGS with one
    equality row) from random states, the port's plain substep on every
    backend against the reference ``"xla"`` engine, float64 on both sides
    and the reference's model in float64."""
    jtree, tree, f1, f2 = _trees(world_anchor)
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.5, 0.5, (B, 2))
    v = rng.standard_normal((B, 2))
    lam = 0.1 * rng.standard_normal((B, 1))
    jt64 = jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                             for k in ARRAY_FIELDS})
    jc = JDistance(frame1=f1, frame2=f2, distance=jnp.float32(0.5), baumgarte_freq=jnp.float32(20.0))
    jeng = JEngine(jt64, JEngineOptions(dt=DT, contact_model="constraint", constraint_solver="xla",
                                        compute_solver_residual=True), constraints=(jc,))
    states = jax.vmap(lambda qq: jeng.reset(q=qq))(jnp.asarray(q)).replace(
        v=jnp.asarray(v), lam=jnp.asarray(lam))
    ref = jax.jit(jax.vmap(lambda s: jeng.step(s, jnp.zeros(2))))(states)
    pc = DistanceConstraint(f1, f2, float(np.float32(0.5)), 20.0)
    for solver in ("substep", "kernel", "inline"):
        eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT,
                                         constraint_solver=solver,
                                         compute_solver_residual=True),
                     constraints=(pc,), device="cpu")
        st = eng.reset(torch.as_tensor(q), torch.as_tensor(v))
        st.lam = torch.as_tensor(lam)
        out = eng.step(st, torch.zeros(B, 2, dtype=torch.float64))
        for k in ("q", "v", "lam", "solver_residual"):
            np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                       atol=1e-9, rtol=0, err_msg=f"{solver} {k}")
    assert np.abs(np.asarray(ref.lam)).max() > 0.1  # the row carries load


def test_builder_takes_armature_damping_stiffness():
    b = TreeBuilder()
    b.add_body("base", -1, JointType.FREE, mass=1.0, inertia=(0.1, 0.1, 0.1))
    b.add_body("j", 0, JointType.REVOLUTE, mass=1.0, com=(0, 0, -0.5), armature=0.01,
               damping=0.5, stiffness=40.0)
    b.add_frame("tip", 1)
    tree = b.build(device="cpu")
    np.testing.assert_array_equal(tree.armature.numpy(), np.float32([0] * 6 + [0.01]))
    np.testing.assert_array_equal(tree.damping.numpy(), np.float32([0] * 6 + [0.5]))
    np.testing.assert_array_equal(tree.stiffness.numpy(), np.float32([0] * 6 + [40.0]))


def test_spring_torque_matches_reference():
    """The actuation torque on Cassie (PD through the motors, damping and
    the shin springs' −k·q) against the reference engine's
    ``_joint_torque``, through the declarative controller and through an
    opaque one; and the springs' part alone: −1500·q on the two shin
    joints, nothing elsewhere."""
    from jiminy_tpu_torch.engine import PDController
    from jiminy_tpu_torch.hardware.motors import motors_from_arrays

    robot, _, stand = j_make_cassie()
    jeng = JEngine(robot.tree, JEngineOptions(dt=2e-3, contact_model="constraint"),
                   motors=robot.motors, controller=JPDController(150.0, 6.0))
    tree = tree_from_arrays({k: np.asarray(getattr(robot.tree, k))
                             for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    fields = ("v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
              "friction_dry", "friction_viscous", "friction_vel_eps")
    motors = motors_from_arrays({k: np.asarray(getattr(robot.motors, k)) for k in fields},
                                device="cpu")
    rng = np.random.default_rng(2)
    q = np.tile(np.asarray(stand), (B, 1)) + rng.uniform(-0.1, 0.1, (B, tree.nq))
    v = rng.standard_normal((B, tree.nv))
    u = rng.uniform(-0.5, 0.5, (B, 10))
    ref = np.asarray(jax.vmap(lambda a, b, c: jeng._joint_torque(c, a, b, 0.0))(
        jnp.asarray(q, jnp.float32), jnp.asarray(v, jnp.float32), jnp.asarray(u, jnp.float32)))
    ut, qt, vt = (torch.as_tensor(x, dtype=torch.float32) for x in (u, q, v))

    def pd(cmd, qq, vv):
        qm, vm = motors.joint_state(qq, vv)
        return 150.0 * (cmd - qm) - 6.0 * vm

    taus = []
    for ctrl in (PDController(150.0, 6.0), pd):
        eng = Engine(tree, EngineOptions(contact_model="constraint", dt=2e-3), motors=motors,
                     controller=ctrl, device="cpu")
        taus.append(eng._joint_torque(ut, qt, vt))
        np.testing.assert_allclose(taus[-1].numpy(), ref, atol=2e-4, rtol=1e-6)
    unsprung = dataclasses.replace(tree, stiffness=torch.zeros_like(tree.stiffness))
    eng0 = Engine(unsprung, EngineOptions(contact_model="constraint", dt=2e-3), motors=motors,
                  controller=PDController(150.0, 6.0), device="cpu")
    d = taus[0] - eng0._joint_torque(ut, qt, vt)
    names = ("L_shin_spring", "R_shin_spring")
    shins = [tree.v_off[tree.joint_index(n)] for n in names]
    q_shin = qt[:, [tree.q_off[tree.joint_index(n)] for n in names]]
    torch.testing.assert_close(d[:, shins], -1500.0 * q_shin, atol=1e-4, rtol=1e-6)
    assert not eng0.substep_spec.springs and eng.substep_spec.springs
    assert float(d[:, [i for i in range(tree.nv) if i not in shins]].abs().max()) == 0.0


def test_sprung_pendulum_period():
    """A horizontal rotor of inertia I on a 1-DoF spring of stiffness k
    (no gravity about its axis) oscillates at ω = √(k/I): from q = 0.1 it
    reaches −0.1 near half a period; the implicit spring damps a little
    (amplitude within 10 % after one period at dt = 1 ms)."""
    b = TreeBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("rotor", -1, JointType.REVOLUTE, axis=(0, 0, 1), inertia=(0.0, 0.0, 0.02),
               stiffness=2.0, q_limits=(-3.0, 3.0))  # a bounds row: the solve has one row
    b.add_frame("rotor_frame", 0)
    tree = b.build(device="cpu", dtype=torch.float64)
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT), device="cpu")
    st = eng.reset(torch.tensor([[0.1]], dtype=torch.float64))
    period = 2 * np.pi * np.sqrt(0.02 / 2.0)
    u = torch.zeros(1, 1, dtype=torch.float64)
    half = eng.step(st, u, n_substeps=round(period / 2 / DT))
    full = eng.step(half, u, n_substeps=round(period / 2 / DT))
    assert -0.1 < float(half.q[0, 0]) < -0.09
    assert 0.09 < float(full.q[0, 0]) < 0.1


def test_other_constraints_and_spherical_springs_raise():
    tree = _trees(False)[1]
    with pytest.raises(NotImplementedError, match="A.22"):
        Engine(tree, EngineOptions(contact_model="constraint", dt=DT), constraints=(object(),),
               device="cpu")
    # springs on spherical joints (A.14, B.8) and prismatic joints (A.15,
    # B.10) are ported: the spec takes them, the stiffness and the joint
    # types packed for the kernels
    b = TreeBuilder()
    b.add_body("ball", -1, JointType.SPHERICAL, mass=1.0, inertia=(0.1, 0.1, 0.1),
               stiffness=10.0)
    b.add_frame("ball_frame", 0)
    spec = SubstepSpec(b.build(device="cpu"), EngineOptions(contact_model="constraint"),
                       FlatGround())
    assert spec.springs and spec.tree.sprung_spherical == ([0], [0])
    assert spec.packed("cpu")[1][-3:].tolist() == [10.0] * 3
    b.add_body("slider", 0, JointType.PRISMATIC, axis=(0.6, 0.0, 0.8), mass=1.0, stiffness=5.0,
               q_limits=(-0.1, 0.1))
    spec = SubstepSpec(b.build(device="cpu"), EngineOptions(contact_model="constraint"),
                       FlatGround())
    si, sf = spec.packed("cpu")
    nb = spec.tree.nb
    assert si[10 + nb:10 + 2 * nb].tolist() == [int(JointType.SPHERICAL), 2]
    assert spec.bounded_joints == [1] and spec.nc == 1
    assert spec.tree.sprung_joints == ([3], [4]) and sf[-4:].tolist() == [10.0] * 3 + [5.0]
