"""The port's kinematic constraints (frame, joint, sphere, wheel) against
jiminy_tpu's.

- ``so3.log_matrix`` on seeded rotations, angles below 1e-7 and near π
  included, and ``algos.frame_jacobian6`` on ANYmal's tree, float64 on
  both sides (jax x64 on, the reference's model in float64), within
  1e-9.
- Each constraint's ``rows`` on ANYmal's frames within 1e-9 in float64:
  the weld, the lock, the distance between two feet, and the sphere and
  wheel rows over flat, Fourier, Perlin, Stairs and heightmap grounds
  (the analytic ones one per env).
- One float64 substep on ``"kernel"`` and ``"inline"`` against the
  reference ``"xla"`` engine, ``contact_model="constraint"`` on both
  sides, within 1e-9: the gantry ANYmal (its weld near the stand pose, so
  that the feet touch, a locked knee, per-body wrenches with a base wrench
  and per-env friction: one reference program), the two-pendulum loop
  with a distance constraint and a lock (the row order across kinds),
  and the wheel on a Fourier ground per env.
- tests/test_constraints.py's analytic cases on the port's engine: the
  weld holds and recovers, the pendulum lock (as the reference runs it:
  default options, a penalty tip contact beside the lock), rolling
  without slip and slip removed.
- The refusals: ``"substep"`` with a frame constraint and a lock on a
  FREE joint raise ValueError at ``Engine(...)``, an object that is no
  constraint TypeError; ``"auto"`` picks ``"kernel"``.
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
from jiminy_tpu.engine import constraints as jc
from jiminy_tpu.engine import ground as jg
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.constraints import (
    DistanceConstraint,
    FrameConstraint,
    JointConstraint,
    SphereConstraint,
    WheelConstraint,
    assemble,
    constraint_from_arrays,
)
from jiminy_tpu_torch.engine.contact import ContactParams
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.models.toys import make_pendulum

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 6
DT = 5e-3
F64 = dict(device="cpu", dtype=torch.float64)
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
KIND = {jc.FrameConstraint: "frame", jc.JointConstraint: "joint",
        jc.DistanceConstraint: "distance", jc.SphereConstraint: "sphere",
        jc.WheelConstraint: "wheel"}


def _port(c):
    """The port's constraint with the reference constraint ``c``'s fields."""
    kind = KIND[type(c)]
    names = [f.name for f in dataclasses.fields(c)]
    return constraint_from_arrays(
        kind, {k: (None if getattr(c, k) is None else np.asarray(getattr(c, k))) for k in names})


def _f64(jtree):
    """The reference tree with its arrays in float64 (x64 must be on)."""
    return jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})


def _port_tree(jtree, **kw):
    fields = {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    return tree_from_arrays(fields, **(kw or F64))


@pytest.fixture(scope="module")
def anymal():
    """The reference ANYmal and the port's tree and motors from its arrays."""
    jrobot = j_make_anymal()
    motors = motors_from_arrays({k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS},
                                **F64)
    return jrobot, _port_tree(jrobot.tree), motors


def _anymal_q(jrobot, rng, n=B, lift=0.0):
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (n, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.15, 0.15, (n, 12))
    q[:, 2] += lift + rng.uniform(-0.02, 0.01, n)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (n, 3)), np.ones((n, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    return q


def _rotation(axis, angle):
    """Rodrigues, numpy float64."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_log_matrix_matches_reference():
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    rng = np.random.default_rng(0)
    angles = [0.0, 1e-9, 5e-8, 3e-4, 0.3, 1.0, 2.5, np.pi - 1e-3, np.pi - 1e-6]
    angles += list(rng.uniform(0, np.pi, 8))
    R = np.stack([_rotation(rng.standard_normal(3), a) for a in angles])
    want = np.asarray(jax.jit(jax.vmap(jso3.log_matrix))(jnp.asarray(R)))
    got = so3.log_matrix(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), angles, atol=1e-7)


def _jacobian_points(tree):
    """The bodies (the base, a foot's, the last) and the offsets from their
    origins of the points whose 6-D Jacobians the tests compare."""
    bodies = [0, tree.frame_body[tree.frame_index("LF_FOOT")], tree.nb - 1]
    return bodies, np.random.default_rng(2).uniform(-0.2, 0.2, (len(bodies), 3))


def test_frame_jacobian6_matches_reference(anymal, reference_rows):
    """At ``reference_rows``' states; the linear half equals
    ``point_jacobian`` to the bit."""
    _, tree, _ = anymal
    q, _, want = reference_rows
    bodies, offs = _jacobian_points(tree)
    qt = torch.as_tensor(q)
    xw = algos.forward_kinematics(tree, qt)
    for k, (b, o) in enumerate(zip(bodies, offs)):
        J = algos.frame_jacobian6(tree, xw, b, xw[b].pos + torch.as_tensor(o))
        np.testing.assert_allclose(J.numpy(), want[:, k], atol=1e-9, rtol=0)
        np.testing.assert_array_equal(J[:, 3:].numpy(), algos.point_jacobian(
            tree, xw, b, xw[b].pos + torch.as_tensor(o)).numpy())


GROUNDS = ("flat", "fourier", "perlin", "stairs", "heightmap")


def _grounds(kind):
    """(reference ground, port ground), float64: one per env for the
    analytic kinds, one shared for flat and the heightmap (x64 on)."""
    rng = np.random.default_rng(GROUNDS.index(kind))
    if kind == "flat":
        return jg.FlatGround(height=jnp.float64(0.03)), pg.FlatGround(height=0.03)
    if kind == "heightmap":
        # heights on a 2⁻¹² grid: the reference takes their differences in
        # float32 (its grid's dtype), exact for these
        z = rng.integers(-200, 200, (40, 40)) / 4096.0
        g = jg.HeightmapGround.create(z, -2.0, -2.0, 0.1, 0.1)
        return g, pg.HeightmapGround.create(*(np.array(getattr(g, k)) for k in (
            "z", "x0", "y0", "dx", "dy")), **F64)  # the reference's float32 grid
    if kind == "fourier":
        K = 8
        p = [rng.uniform(0.005, 0.03, (B, K)), rng.uniform(-4, 4, (B, K)),
             rng.uniform(-4, 4, (B, K)), rng.uniform(0, 2 * np.pi, (B, K))]
        return (jg.FourierGround(*(jnp.asarray(x) for x in p)),
                pg.FourierGround(torch.as_tensor(np.concatenate(p, -1))))
    if kind == "perlin":
        p = [rng.integers(0, 2 ** 20, B).astype(np.float64), rng.uniform(0.5, 1.0, B),
             rng.uniform(0.03, 0.08, B)]
        return (jg.PerlinGround(*(jnp.asarray(x) for x in p), octaves=3),
                pg.PerlinGround(torch.as_tensor(np.stack(p, -1)), 3))
    p = [rng.uniform(0.3, 0.5, B), rng.uniform(0.05, 0.1, B), np.full(B, 10.0),
         rng.uniform(0.03, 0.06, B), rng.uniform(-1.0, 1.0, B)]
    return (jg.StairsGround(*(jnp.asarray(x) for x in p)),
            pg.StairsGround(torch.as_tensor(np.stack(p, -1))))


def _anymal_constraints(tree):
    """Reference constraints on ANYmal's frames, float32 fields as the
    reference's defaults."""
    f = tree.frame_index
    rot = _rotation([0.3, -0.2, 0.9], 0.2)
    return [
        jc.FrameConstraint(frame=f("base_frame"), ref_rot=jnp.asarray(rot),
                           ref_pos=jnp.asarray([0.02, -0.01, 0.55])),
        jc.FrameConstraint(frame=f("LH_SHANK_frame")),
        jc.JointConstraint(joint=tree.joint_index("LF_KFE"), ref_q=jnp.float32(-0.7)),
        jc.DistanceConstraint(frame1=f("LF_FOOT"), frame2=f("RH_FOOT"),
                              distance=jnp.float32(0.9)),
        jc.SphereConstraint(frame=f("LF_FOOT"), radius=jnp.float32(0.03)),
        jc.WheelConstraint(frame=f("RF_FOOT"), radius=jnp.float32(0.05),
                           axis=jnp.asarray([0.0, 0.6, 0.8])),
        jc.WheelConstraint(frame=f("RH_SHANK_frame"), radius=jnp.float32(0.2),
                           baumgarte_freq=jnp.float32(35.0)),
    ]


def _rolling(cons):
    return [c for c in cons if isinstance(c, (jc.SphereConstraint, jc.WheelConstraint))]


@pytest.fixture(scope="module")
def reference_rows(anymal):
    """At random ANYmal states (the feet near the ground), float64: every
    constraint's rows and ``assemble``'s stack on flat ground, the sphere's
    and the wheels' on each other ground, and the 6-D Jacobians of
    ``_jacobian_points``; one reference program. Returns (q, {kind: (port
    ground, rows' J, their targets, stacked J, target)}, the Jacobians (B,
    3, 6, nv))."""
    jrobot, tree, _ = anymal
    # x64 on for this program alone: a module fixture outlives the
    # per-test restore of conftest.py
    jax.config.update("jax_enable_x64", True)
    try:
        jt = _f64(jrobot.tree)
        cons = _anymal_constraints(tree)
        grounds = {kind: _grounds(kind) for kind in GROUNDS}
        q = _anymal_q(jrobot, np.random.default_rng(3), lift=-0.02)
        bodies, offs = _jacobian_points(tree)

        def ref(qq, gs):
            xw, vel = jalgos.kinematics(jt, qq, jnp.zeros(18))
            out = {"jac": jnp.stack([jalgos.frame_jacobian6(jt, xw, b, xw[b].pos + o)
                                     for b, o in zip(bodies, offs)])}
            for kind, g in zip(GROUNDS, gs):
                cs = cons if kind == "flat" else _rolling(cons)
                rows = [c.rows(jt, qq, None, xw, vel, DT, g)
                        if isinstance(c, (jc.SphereConstraint, jc.WheelConstraint))
                        else c.rows(jt, qq, None, xw, vel, DT) for c in cs]
                J, t, _, _ = jc.assemble(jt, cs, qq, None, xw, vel, DT, g)
                out[kind] = ([r.J for r in rows], [r.target for r in rows], J, t)
            return out

        axes = tuple(0 if kind in ("fourier", "perlin", "stairs") else None for kind in GROUNDS)
        run = jax.jit(jax.vmap(ref, in_axes=(0, axes)))
        res = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(q), tuple(
            grounds[kind][0] for kind in GROUNDS)))
    finally:
        jax.config.update("jax_enable_x64", False)
    return q, {kind: (grounds[kind][1], *res[kind]) for kind in GROUNDS}, res["jac"]


@pytest.mark.parametrize("kind", GROUNDS)
def test_rows_match_reference(anymal, reference_rows, kind):
    """Every constraint's rows (and ``assemble``'s stack and blocks) at
    random ANYmal states, float64, on flat ground; the sphere's and the
    wheels' on each other ground; the feet near it."""
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    _, tree, _ = anymal
    q, res, _ = reference_rows
    ground, rJ, rt, aJ, at = res[kind]
    cons = _anymal_constraints(tree)
    ports = [_port(c) for c in (cons if kind == "flat" else _rolling(cons))]
    qt = torch.as_tensor(q)
    xw = algos.forward_kinematics(tree, qt)
    for k, c in enumerate(ports):
        J, t = c.rows(tree, qt, xw, DT, ground)
        assert J.shape == (B, c.size, tree.nv) and t.shape == (B, c.size)
        np.testing.assert_allclose(J.numpy(), rJ[k], atol=1e-9, rtol=0, err_msg=str(c))
        np.testing.assert_allclose(t.numpy(), rt[k], atol=1e-9, rtol=0, err_msg=str(c))
    J, t, blocks = assemble(tree, ports, qt, xw, DT, ground)
    np.testing.assert_allclose(J.numpy(), aJ, atol=1e-9, rtol=0)
    np.testing.assert_allclose(t.numpy(), at, atol=1e-9, rtol=0)
    sizes = [c.size for c in ports]
    assert [tuple(b) for b in blocks] == [
        ("equality", int(np.sum(sizes[:i])), s) for i, s in enumerate(sizes)]
    assert np.abs(at).max() > 1e-2  # the targets carry errors


def test_constraint_from_arrays_defaults():
    assert constraint_from_arrays("frame", {"frame": np.int32(3)}) == FrameConstraint(3)
    w = constraint_from_arrays("wheel", {"frame": 2, "radius": np.float32(0.2)})
    assert w == WheelConstraint(2, radius=float(np.float32(0.2)), axis=(0.0, 1.0, 0.0),
                                baumgarte_freq=20.0)
    assert constraint_from_arrays("joint", {"joint": 4, "ref_q": 0.5}) == JointConstraint(4, 0.5)
    assert constraint_from_arrays("sphere", {"frame": 1}) == SphereConstraint(1, 0.1, 20.0)
    with pytest.raises(KeyError):
        constraint_from_arrays("cone", {})


# ---- one substep against the reference "xla" engine, float64


def _gantry(jrobot, tree):
    """The gantry test's constraints: the base welded near the stand pose
    (the feet touch) and the LF knee locked; reference and port."""
    f = tree.frame_index("base_frame")
    stand = np.asarray(j_stand_q(jrobot.tree), np.float64)
    knee = tree.joint_index("LF_KFE")
    ref = (jc.FrameConstraint(frame=f, ref_rot=jnp.asarray(_rotation([0, 1, 0.2], 0.03)),
                              ref_pos=jnp.asarray([0.01, 0.0, stand[2] - 0.004])),
           jc.JointConstraint(joint=knee, ref_q=jnp.float32(stand[tree.q_off[knee]] + 0.05)))
    return ref, tuple(_port(c) for c in ref)


def _gantry_inputs(jrobot, tree, seed):
    rng = np.random.default_rng(seed)
    q = _anymal_q(jrobot, rng)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 31)))
    u = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    fext = np.zeros((B, tree.nb, 6))
    shanks = [tree.frame_body[tree.frame_index(f"{leg}_SHANK_frame")] for leg in ("LF", "RH")]
    for b in [0] + shanks:
        fext[:, b] = np.concatenate([2.0 * rng.standard_normal((B, 3)),
                                     30.0 * rng.standard_normal((B, 3))], 1)
    mu = rng.uniform(0.2, 1.2, B)
    return q, v, lam, u, wrench, fext, mu


SIM_FIELDS = ("q", "v", "lam", "solver_residual", "contact_forces", "a", "tau")


def test_gantry_substep_matches_reference_in_f64(anymal):
    """The gantry ANYmal with per-body wrenches, a base wrench and per-env
    friction: one substep on ``"kernel"`` (through ``"auto"``, which picks
    it) and ``"inline"`` against one reference program."""
    jrobot, tree, motors = anymal
    jax.config.update("jax_enable_x64", True)
    jcons, cons = _gantry(jrobot, tree)
    q, v, lam, u, wrench, fext, mu = _gantry_inputs(jrobot, tree, 4)
    jopts = JEngineOptions(dt=DT, contact_model="constraint", constraint_solver="xla",
                           pgs_iters=8, compute_solver_residual=True)
    jeng = JEngine(_f64(jrobot.tree), jopts, motors=jrobot.motors,
                   controller=JPDController(80.0, 2.0), constraints=jcons)
    states = jax.vmap(lambda qq: jeng.reset(q=qq))(jnp.asarray(q)).replace(
        v=jnp.asarray(v), lam=jnp.asarray(lam))
    step = jax.jit(jax.vmap(lambda s, uu, w, f, m: jeng.step(
        s, uu, base_wrench=w, fext_user=f,
        contact_params=jopts.contacts.replace(friction=m))))
    ref = step(states, *(jnp.asarray(x) for x in (u, wrench, fext, mu)))
    ref = {k: np.asarray(getattr(ref, k)) for k in SIM_FIELDS}
    assert np.abs(ref["lam"][:, :7]).max() > 0.1  # the weld and the lock carry load
    assert np.abs(ref["lam"][:, 19:]).max() > 0.1  # and the contacts
    for solver in ("auto", "inline"):  # "auto" resolves to "kernel"
        eng = Engine(tree, EngineOptions(dt=DT, contact_model="constraint", pgs_iters=8,
                                         compute_solver_residual=True, constraint_solver=solver),
                     motors=motors, controller=PDController(80.0, 2.0), constraints=cons,
                     device="cpu")
        assert eng.backend == ("kernel" if solver == "auto" else solver) and eng.nc == 31
        st = eng.reset(torch.as_tensor(q), torch.as_tensor(v))
        st.lam = torch.as_tensor(lam)
        out = eng.step(st, torch.as_tensor(u), base_wrench=torch.as_tensor(wrench),
                       fext_user=torch.as_tensor(fext),
                       contact_params=ContactParams(friction=torch.as_tensor(mu)))
        for k in SIM_FIELDS:
            tol = 1e-9 / DT if k in ("a", "contact_forces") else 1e-9
            np.testing.assert_allclose(getattr(out, k).numpy(), ref[k], atol=tol, rtol=0,
                                       err_msg=f"{solver} {k}")


def _loop(tree_builder, joint_type):
    """tests/test_constraints.py's two-pendulum loop."""
    b = tree_builder()
    j1 = b.add_body("l1", -1, joint_type.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1))
    j2 = b.add_body("l2", -1, joint_type.REVOLUTE,
                    placement=tree_builder.make_placement(pos=(0.5, 0, 0)), axis=(0, 1, 0),
                    mass=1.0, com=(0, 0, -1))
    f1 = b.add_frame("tip1", j1, tree_builder.make_placement(pos=(0, 0, -1)))
    f2 = b.add_frame("tip2", j2, tree_builder.make_placement(pos=(0, 0, -1)))
    return b, f1, f2


def _wheel(tree_builder, joint_type, r=0.2):
    """tests/test_constraints.py's wheel (its hub a frame at the origin)."""
    b = tree_builder()
    w = b.add_body("wheel", parent=-1, joint_type=joint_type.FREE, mass=1.0,
                   inertia=np.diag([0.01, 0.02, 0.01]), joint_name="root")
    b.add_frame("hub", w)
    return b


def _one_substep(jtree, jcons, tree, cons, q, v, lam, dt, jground=None, ground=None):
    """One substep of a motorless model on the reference ``"xla"`` engine
    and on the port's ``"kernel"`` and ``"inline"``, float64; ``ground``
    one per env. Returns (reference, {solver: port})."""
    jeng = JEngine(_f64(jtree), JEngineOptions(dt=dt, contact_model="constraint",
                                               constraint_solver="xla",
                                               compute_solver_residual=True),
                   constraints=jcons)
    n = q.shape[0]
    states = jax.vmap(lambda qq: jeng.reset(q=qq))(jnp.asarray(q)).replace(
        v=jnp.asarray(v), lam=jnp.asarray(lam))
    u = jnp.zeros((n, tree.nv))
    if jground is None:
        ref = jax.jit(jax.vmap(lambda s, uu: jeng.step(s, uu)))(states, u)
    else:
        ref = jax.jit(jax.vmap(lambda s, uu, g: jeng.step(s, uu, ground=g)))(states, u, jground)
    out = {}
    for solver in ("kernel", "inline"):
        eng = Engine(tree, EngineOptions(dt=dt, contact_model="constraint",
                                         compute_solver_residual=True, constraint_solver=solver),
                     ground=None if ground is None else pg.FourierGround(ground.gc[0]),
                     constraints=cons, device="cpu")
        st = eng.reset(torch.as_tensor(q), torch.as_tensor(v))
        st.lam = torch.as_tensor(lam)
        out[solver] = eng.step(st, torch.zeros(n, tree.nv, dtype=torch.float64), ground=ground)
    return ref, out


def _assert_substeps(ref, out):
    for solver, st in out.items():
        for k in ("q", "v", "lam", "solver_residual"):
            np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(ref, k)),
                                       atol=1e-9, rtol=0, err_msg=f"{solver} {k}")


def test_loop_with_lock_matches_reference_in_f64():
    """The loop's distance row, then a lock on the second pendulum: two
    kinds of rows, in declaration order, one block each."""
    jax.config.update("jax_enable_x64", True)
    jb, f1, f2 = _loop(JTreeBuilder, JJointType)
    pb, _, _ = _loop(TreeBuilder, JointType)
    jtree, tree = jb.build(), pb.build(**F64)
    jcons = (jc.DistanceConstraint(frame1=f1, frame2=f2, distance=jnp.float32(0.5)),
             jc.JointConstraint(joint=1, ref_q=jnp.float32(0.3)))
    cons = tuple(_port(c) for c in jcons)
    rng = np.random.default_rng(5)
    q = rng.uniform(-0.5, 0.5, (B, 2))
    v = rng.standard_normal((B, 2))
    lam = 0.1 * rng.standard_normal((B, 2))
    ref, out = _one_substep(jtree, jcons, tree, cons, q, v, lam, 1e-3)
    _assert_substeps(ref, out)
    assert out["kernel"].lam.shape == (B, 2) and np.abs(np.asarray(ref.lam)).min() > 1e-3


def test_wheel_on_fourier_ground_matches_reference_in_f64():
    """The wheel rolling on a Fourier ground per env, its hub at the
    ground's height under it plus r, a little off so that the Baumgarte
    targets work."""
    jax.config.update("jax_enable_x64", True)
    r = 0.2
    jtree = _wheel(JTreeBuilder, JJointType).build()
    tree = _wheel(TreeBuilder, JointType).build(**F64)
    jcons = (jc.WheelConstraint(frame=0, radius=jnp.float32(r)),)
    cons = tuple(_port(c) for c in jcons)
    jground, ground = _grounds("fourier")
    rng = np.random.default_rng(6)
    q = np.zeros((B, 7))
    q[:, :2] = rng.uniform(-1, 1, (B, 2))
    h, _ = ground.query(torch.as_tensor(q[:, :2]))
    q[:, 2] = h.numpy() + r + rng.uniform(-0.01, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.1, 0.1, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.standard_normal((B, 6))
    lam = 0.1 * rng.standard_normal((B, 3))
    ref, out = _one_substep(jtree, jcons, tree, cons, q, v, lam, 1e-3, jground, ground)
    _assert_substeps(ref, out)
    assert np.abs(np.asarray(ref.lam)).max() > 1e-3


# ---- tests/test_constraints.py's analytic cases on the port


def _box():
    b = TreeBuilder()
    box = b.add_body("box", parent=-1, joint_type=JointType.FREE, mass=1.0,
                     inertia=np.diag([0.01, 0.01, 0.01]), joint_name="root")
    b.add_frame("origin", box)
    return b.build(device="cpu")


def _run(engine, q0, t_end, v0=None):
    st = engine.reset(torch.as_tensor(q0, dtype=torch.float32)[None],
                      None if v0 is None else torch.as_tensor(v0, dtype=torch.float32)[None])
    u = torch.zeros(1, engine.tree.nv)
    return engine.step(st, u, n_substeps=round(t_end / engine.options.dt))


def _engine(tree, *cons):
    return Engine(tree, EngineOptions(dt=1e-3, contact_model="constraint"), constraints=cons,
                  device="cpu")


@pytest.mark.parametrize("z0, freq, atol", [(1.0, 20.0, 2e-3), (0.95, 50.0, 5e-3)],
                         ids=["holds", "recovers"])
def test_weld(z0, freq, atol):
    """The weld holds a box against gravity, and pulls it back from 5 cm
    below its target."""
    tree = _box()
    eng = _engine(tree, FrameConstraint(0, ref_rot=np.eye(3), ref_pos=(0.0, 0.0, 1.0),
                                        baumgarte_freq=freq))
    q0 = tree.neutral_q()
    q0[2] = z0
    st = _run(eng, q0, 1.0)
    np.testing.assert_allclose(st.q[0, :3].numpy(), [0, 0, 1.0], atol=atol)
    if z0 == 1.0:
        assert float(st.v.abs().max()) < 1e-2


def test_lock_pendulum_off_vertical():
    """The reference's case as it is: default options, so the tip's
    contact is a penalty one on the default ground (the tip 0.88 m deep)
    beside the lock's row, the lock holding."""
    tree = make_pendulum(device="cpu")
    eng = Engine(tree, EngineOptions(dt=1e-3),
                 constraints=(JointConstraint(0, ref_q=0.5, baumgarte_freq=20.0),), device="cpu")
    assert eng.impulse and eng.substep_spec.penalty and eng.nc == 1 and eng.backend == "kernel"
    st = _run(eng, [0.5], 1.0)
    assert abs(float(st.q[0, 0]) - 0.5) < 1e-3
    assert abs(float(st.v[0, 0])) < 1e-3


def _contact_speed(st, r):
    R = so3.quat_to_matrix(st.q[0, 3:7])
    v_w, w_w = R @ st.v[0, :3], R @ st.v[0, 3:6]
    return v_w, torch.linalg.vector_norm(v_w + so3.cross(w_w, torch.tensor([0.0, 0.0, -r])))


@pytest.mark.parametrize("spin", [True, False], ids=["rolling", "slip_removed"])
def test_wheel_rolls_without_slip(spin):
    """Rolling at v = ω·r stays rolling (the speed, the height and the
    distance kept); a sliding wheel is brought to rolling."""
    r = 0.2
    tree = _wheel(TreeBuilder, JointType).build(device="cpu")
    eng = _engine(tree, WheelConstraint(0, radius=r, axis=(0.0, 1.0, 0.0)))
    q0 = tree.neutral_q()
    q0[2] = r
    w_y = 5.0
    v0 = np.zeros(6)
    v0[0] = w_y * r if spin else 1.0
    v0[4] = w_y if spin else 0.0
    st = _run(eng, q0, 0.5, v0)
    v_w, vc = _contact_speed(st, r)
    assert float(vc) < 1e-2
    if spin:
        assert abs(float(v_w[0]) - w_y * r) < 5e-2
        assert abs(float(st.q[0, 2]) - r) < 2e-3
        assert abs(float(st.q[0, 0]) - w_y * r * 0.5) < 0.05


# ---- the refusals and the backend choice


def test_refusals_and_auto():
    tree = _box()
    weld = FrameConstraint(0)
    opts = EngineOptions(dt=1e-3, contact_model="constraint")
    with pytest.raises(ValueError, match="FrameConstraint outside the whole-substep kernels"):
        Engine(tree, dataclasses.replace(opts, constraint_solver="substep"), constraints=(weld,),
               device="cpu")
    with pytest.raises(ValueError, match="only REVOLUTE and PRISMATIC"):
        Engine(tree, opts, constraints=(JointConstraint(0),), device="cpu")
    with pytest.raises(TypeError, match="not a kinematic constraint"):
        Engine(tree, opts, constraints=(object(),), device="cpu")
    eng = Engine(tree, opts, constraints=(weld, SphereConstraint(0, radius=0.1)), device="cpu")
    assert eng.backend == "kernel" and eng.nc == 9
    assert [tuple(b) for b in eng.substep_spec.cfg.eq_blocks] == [
        ("equality", 0, 6), ("equality", 6, 3)]
    assert eng.substep_spec.dist_constraints == [] and eng.substep_spec.n_dist == 0
    # distance constraints alone stay on the whole-substep kernels
    loop, f1, f2 = _loop(TreeBuilder, JointType)
    eng = Engine(loop.build(device="cpu"), opts, constraints=(DistanceConstraint(f1, f2, 0.5),),
                 device="cpu")
    assert eng.backend == "substep" and eng.substep_spec.n_dist == 1
