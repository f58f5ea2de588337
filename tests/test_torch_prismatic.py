"""The port's PRISMATIC joints (ROADMAP A.15, B.10) against jiminy_tpu's.

- The toy models (``make_pendulum``, ``make_double_pendulum``,
  ``make_cartpole`` with its PRISMATIC cart, ``make_acrobot``,
  ``make_ball``, ``make_free_box``) field for field against
  ``tree_from_arrays`` of the reference's trees (integers exact, floats
  atol 1e-7); the reference's PRISMATIC kernel scene
  (tests/test_box_pairs.py ``_slab_and_free_body``) crosses as arrays
  and equals the port's own builder's tree.
- FK, body velocities, point Jacobians, CRBA, RNEA and integrate on
  ``make_cartpole()`` and on a slider whose axis is oblique, against
  ``jiminy_tpu.core.algos`` in float64 within 1e-9.
- The slab scene (the PRISMATIC slab on its 1e7 N/m spring, the free cube,
  their ptbox pair of 16 contacts, friction 0.8; a frictionless direct
  motor on the slider so that the reference's fused kernel takes the
  step) at B = 3 over 6 substeps: the port's plain
  ``substep_multi_reference`` against the reference's
  ``substep_batched_pallas_multi`` in interpret mode, at
  tests/test_box_pairs.py:233-234's own tolerances (q atol 1e-5, rtol
  1e-4; v atol 1e-3, rtol 1e-3); and in float64 through ``Engine.step``
  on every backend against the reference's ``"xla"`` engine on a float64
  copy of its model (ROADMAP C.3) within 1e-9, with the slider's axis
  along z and oblique.
- ``make_cartpole()`` under ``EngineOptions(contact_model="constraint")``
  with a direct motor on the cart, the carts driven past their ±2.4 m
  limits: the bound row binds, and 20 substeps match the reference in
  float64 within 1e-9 on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_box_pairs import _slab_and_free_body

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.engine import Box as JBox
from jiminy_tpu.engine import CollisionPair as JCollisionPair
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.hardware.motors import Motors as JMotors
from jiminy_tpu.models import toys as jtoys
from jiminy_tpu.ops.substep_kernel import substep_batched_pallas_multi
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.collision import Box, CollisionPair
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.models import toys

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

TOYS = ("make_pendulum", "make_double_pendulum", "make_cartpole", "make_acrobot", "make_ball",
        "make_free_box")
SIM_FIELDS = ("q", "v", "lam", "contact_forces", "solver_residual", "a", "tau")
F64_ATOL = 1e-9
B = 3
N_SLAB, N_CART = 6, 20


def _arrays(jtree) -> dict:
    return {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}


def _assert_same_tree(got, want, atol=1e-7):
    for k in STATIC_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", TOYS)
def test_toy_matches_reference(name):
    _assert_same_tree(getattr(toys, name)(device="cpu"),
                      tree_from_arrays(_arrays(getattr(jtoys, name)()), device="cpu"))


def test_cartpole_is_prismatic():
    tree = toys.make_cartpole(device="cpu")
    assert tree.joint_type == (JointType.PRISMATIC, JointType.REVOLUTE)
    S = tree.motion_subspaces[0]
    torch.testing.assert_close(S[:, 0], torch.tensor([0.0, 0, 0, 1, 0, 0]), atol=0, rtol=0)
    assert tree.q_min[0].item() == pytest.approx(-2.4) and tree.q_max[0].item() == \
        pytest.approx(2.4)


def _slab_builders(axis):
    """The slab scene from both packages' builders, the slider along
    ``axis`` (tests/test_box_pairs.py's `_slab_and_free_body` at
    (0, 0, 1))."""
    trees = []
    for TB, JT in ((JTreeBuilder, JJointType), (TreeBuilder, JointType)):
        b = TB()
        b.add_body("slab", parent=-1, joint_type=JT.PRISMATIC, axis=axis, mass=100.0,
                   com=(0, 0, 0.05), inertia=np.diag([10.0] * 3).astype(np.float32),
                   joint_name="slab_z", stiffness=1e7, damping=1e4)
        b.add_body("cube", parent=-1, joint_type=JT.FREE, mass=1.0, com=(0, 0, 0),
                   inertia=np.diag([0.004] * 3).astype(np.float32), joint_name="cube_root")
        trees.append(b.build() if TB is JTreeBuilder else b.build(device="cpu"))
    return trees


def test_slab_scene_crosses_as_arrays():
    """The reference's own scene, crossed as arrays, is the port builder's
    tree; the spring and damping sit on the PRISMATIC dof."""
    jtree, slab, cube = _slab_and_free_body()
    tree = tree_from_arrays(_arrays(jtree), device="cpu")
    _assert_same_tree(_slab_builders((0, 0, 1))[1], tree)
    assert (slab, cube) == (0, 1) and tree.joint_type[0] == JointType.PRISMATIC
    assert tree.sprung_joints == ([0], [0]) and tree.damping[0].item() == 1e4


def _oblique_trees():
    """A free base carrying a slider along the oblique (0.6, 0, 0.8) and a
    pole on it, from both packages' builders (float64 copies later)."""
    trees = []
    for TB, JT in ((JTreeBuilder, JJointType), (TreeBuilder, JointType)):
        b = TB()
        base = b.add_body("base", -1, JT.FREE, mass=3.0, inertia=np.diag([0.1, 0.2, 0.3]))
        sl = b.add_body("slider", base, JT.PRISMATIC, placement=TB.make_placement(
            pos=(0.1, -0.2, 0.05)), axis=(0.6, 0.0, 0.8), mass=1.5, com=(0.02, 0.01, -0.03),
                        inertia=np.diag([0.01, 0.02, 0.015]), q_limits=(-0.3, 0.3))
        b.add_body("pole", sl, JT.REVOLUTE, placement=TB.make_placement(pos=(0.0, 0.1, 0.2)),
                   axis=(0, 1, 0), mass=0.5, com=(0, 0, 0.25), inertia=np.diag([0.01] * 3))
        b.add_contact_point("tip", 2, (0.0, 0.0, 0.5))
        b.add_contact_point("slider_corner", 1, (0.05, 0.05, -0.05))
        trees.append(b.build() if TB is JTreeBuilder else b.build(device="cpu"))
    return trees


@pytest.fixture(scope="module")
def algo_cases():
    cart = toys.make_cartpole(device="cpu")
    jt_obl, t_obl = _oblique_trees()
    _assert_same_tree(t_obl, tree_from_arrays(_arrays(jt_obl), device="cpu"))
    return {"cartpole": (jtoys.make_cartpole(), cart), "oblique": (jt_obl, t_obl)}


def _f64(jtree):
    return jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})


def _algo_states(tree, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (8, tree.nq))
    if tree.joint_type[0] == JointType.FREE:
        quat = rng.standard_normal((8, 4))
        q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    return q, rng.standard_normal((8, tree.nv)), rng.standard_normal((8, tree.nv))


@pytest.mark.parametrize("case", ["cartpole", "oblique"])
def test_algorithms_match_reference_f64(algo_cases, case):
    """FK, body velocities, point Jacobians of the contact sites (and of a
    point on each body), CRBA, RNEA and integrate in float64 within
    1e-9."""
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    jtree, tree = algo_cases[case]
    jt, t = _f64(jtree), tree.to(dtype=torch.float64)
    q, v, a = _algo_states(tree, 3)
    pts = [(body, np.array([0.03, -0.02, 0.1])) for body in range(tree.nb)]

    def jfn(q, v, a):
        xw, vel = jalgos.kinematics(jt, q, v)
        jac = [jalgos.point_jacobian(jt, xw, body, xw[body].apply(jnp.asarray(p)))
               for body, p in pts]
        return ([x.pos for x in xw], [x.rot for x in xw], vel, jac, jalgos.crba(jt, q),
                jalgos.rnea(jt, q, v, a), jalgos.integrate(jt, q, v, 1e-2))

    ref = jax.jit(jax.vmap(jfn))(q, v, a)
    qt, vt, at = (torch.as_tensor(x) for x in (q, v, a))
    xw, vel = algos.kinematics(t, qt, vt)
    jac = [algos.point_jacobian(t, xw, body, xw[body].apply(torch.as_tensor(p)))
           for body, p in pts]
    got = ([x.pos for x in xw], [x.rot for x in xw], vel, jac, algos.crba(t, qt),
           algos.rnea(t, qt, vt, at), algos.integrate(t, qt, vt, 1e-2))
    for name, g, r in zip(("pos", "rot", "vel", "jac", "crba", "rnea", "integrate"), got, ref):
        for gi, ri in zip(g, r) if isinstance(g, list) else ((g, r),):
            np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=F64_ATOL, rtol=0,
                                       err_msg=f"{case} {name}")
    # a unit slide along the oblique axis moves the slider's origin along
    # its world axis and turns nothing
    if case == "oblique":
        q2 = qt.clone()
        q2[:, 7] += 1.0
        d = algos.forward_kinematics(t, q2)[1].pos - xw[1].pos
        axis_w = xw[0].rot @ (t.jp_rot[1] @ t.axis[1])  # the float32 (0.6, 0, 0.8)
        torch.testing.assert_close(d, axis_w, atol=1e-12, rtol=0)


def _slab_engines(axis):
    """(the reference's slab-scene engine on "xla" in float64, on a float64
    copy of its model; the port's tree and motor arrays): the direct motor
    on the slider, no friction."""
    jtree = _slab_builders(axis)[0]
    jmotors = JMotors.create([0])
    pair = JCollisionPair(JBox("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                          JBox("cube", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8)
    return jtree, jmotors, (pair,)


def _port_pair():
    return (CollisionPair(Box("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                          Box("cube", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8),)


def _slab_states(seed, n=B):
    """Around the reference test's landing: the cube at z 0.197–0.207 and
    x, y ±0.1 m, tilted up to ~0.06 rad, lateral speed (−0.3, 0.2) scaled
    0.5–1.5 (the test's linspace), falling and turning; the slab sagging
    0–2e-4 m; λ0 ≥ 0; a motor command (zero: the reference test's torque-free
    step)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 8))
    q[:, 0] = rng.uniform(-2e-4, 0.0, n)
    q[:, 1:3] = rng.uniform(-0.1, 0.1, (n, 2))
    q[:, 3] = rng.uniform(0.197, 0.207, n)
    quat = np.concatenate([rng.uniform(-0.03, 0.03, (n, 3)), np.ones((n, 1))], 1)
    q[:, 4:8] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = np.zeros((n, 7))
    s = np.linspace(0.5, 1.5, n)
    v[:, 0], v[:, 1], v[:, 2] = 0.01 * rng.standard_normal(n), -0.3 * s, 0.2 * s
    v[:, 3], v[:, 4:7] = rng.uniform(-0.3, 0.0, n), 0.5 * rng.standard_normal((n, 3))
    lam = np.abs(0.05 * rng.standard_normal((n, 48)))
    return q, v, lam, np.zeros((n, 1))


def test_slab_substep_matches_pallas_kernel_interpreted():
    """The port's plain K2 against the reference's fused Pallas kernel
    (interpret mode) over the reference test's 6 substeps, from the same
    float32 states."""
    jtree, jmotors, pairs = _slab_engines((0, 0, 1))
    jeng = JEngine(jtree, JEngineOptions(dt=1e-3, contact_model="constraint", pgs_iters=8,
                                         constraint_solver="pallas_substep",
                                         compute_solver_residual=True),
                   motors=jmotors, collision_pairs=pairs)
    assert jeng._substep_spec.torque is not None and jeng._substep_spec.pair_contacts == [16]
    eng = Engine(tree_from_arrays(_arrays(jtree), device="cpu"),
                 EngineOptions(dt=1e-3, contact_model="constraint", pgs_iters=8),
                 motors=Motors.create([0], device="cpu"), collision_pairs=_port_pair(),
                 device="cpu")
    assert eng.backend == "substep" and eng.nc == 48
    # the reference test's landing (tests/test_box_pairs.py:211-223: the
    # cube at x 0.05 m, lateral speed (−0.3, 0.2) scaled 0.5–1.5, a fresh
    # λ) with the cube 0.5–1.5 mm into the slab's face instead of 3 mm
    # above it, so that the pair rows push within the 6 ms
    q = np.tile(np.asarray(jtree.neutral_q()), (B, 1)).astype(np.float32)
    q[:, 1], q[:, 3] = 0.05, np.linspace(0.1985, 0.1995, B)
    v = np.zeros((B, 7), np.float32)
    v[:, 1], v[:, 2] = -0.3, 0.2
    v *= np.linspace(0.5, 1.5, B, dtype=np.float32)[:, None]
    lam, u = np.zeros((B, 48), np.float32), np.zeros((B, 1), np.float32)
    wrench = np.zeros((B, 6), np.float32)
    ref = substep_batched_pallas_multi(
        jeng._substep_spec, N_SLAB, *(jnp.asarray(x) for x in (q, v, u, lam)),
        wrench=jnp.asarray(wrench), interpret=True)
    from jiminy_tpu_torch.ops.substep_kernel import substep_multi_reference

    out = substep_multi_reference(eng.substep_spec, N_SLAB,
                                  *(torch.as_tensor(x) for x in (q, v, u, lam, wrench)))
    rq, rv, rlam = (np.asarray(x) for x in ref[:3])
    assert (np.abs(rlam) > 0).any(1).all() and np.abs(rlam).max() > 1e-4  # the pair carries the cube
    np.testing.assert_allclose(out[0].numpy(), rq, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), rv, atol=1e-3, rtol=1e-3)


def _jax_f64_steps(jtree, jmotors, pairs, arrays, n_sub, opts):
    """The reference "xla" engine's step in float64 (x64 on, on a float64
    copy of its model) → numpy fields. Module fixtures call it before the
    conftest's per-test x64 guard records the setting, so x64 is restored
    here."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return _jax_f64_run(jtree, jmotors, pairs, arrays, n_sub, opts)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _jax_f64_run(jtree, jmotors, pairs, arrays, n_sub, opts):
    jm = jmotors.replace(**{k: jnp.asarray(np.asarray(getattr(jmotors, k)), jnp.float64)
                            for k in ("reduction", "effort_limit", "velocity_limit",
                                      "friction_dry", "friction_viscous", "friction_vel_eps")})
    eng = JEngine(_f64(jtree), JEngineOptions(constraint_solver="xla", **opts), motors=jm,
                  collision_pairs=pairs)
    q, v, lam, u = (jnp.asarray(a, jnp.float64) for a in arrays)
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    out = jax.jit(jax.vmap(lambda s, uu: eng.step(s, uu, n_substeps=n_sub)))(states, u)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _port_f64_steps(tree, motors, pairs, arrays, n_sub, opts, solver):
    eng = Engine(tree.to(dtype=torch.float64), EngineOptions(constraint_solver=solver, **opts),
                 motors=motors.to(dtype=torch.float64), collision_pairs=pairs, device="cpu")
    q, v, lam, u = (torch.as_tensor(a) for a in arrays)
    sim = eng.reset(q, v)
    sim.lam = lam
    out = eng.step(sim, u, n_substeps=n_sub)
    return eng, {k: getattr(out, k).numpy() for k in SIM_FIELDS}


SLAB_OPTS = dict(dt=1e-3, contact_model="constraint", pgs_iters=8, compute_solver_residual=True)


@pytest.fixture(scope="module")
def slab_refs():
    """The reference's 6 substeps in float64 for both axes (one program
    each)."""
    out = {}
    for name, axis in (("z", (0, 0, 1)), ("oblique", (0.6, 0.0, 0.8))):
        jtree, jmotors, pairs = _slab_engines(axis)
        arrays = _slab_states(22)
        out[name] = (jtree, arrays, _jax_f64_steps(jtree, jmotors, pairs, arrays, N_SLAB,
                                                   SLAB_OPTS))
    return out


@pytest.mark.parametrize("solver", ["substep", "kernel", "inline"])
@pytest.mark.parametrize("axis", ["z", "oblique"])
def test_slab_steps_match_reference_f64(slab_refs, axis, solver):
    jtree, arrays, ref = slab_refs[axis]
    tree = tree_from_arrays(_arrays(jtree), device="cpu")
    eng, got = _port_f64_steps(tree, Motors.create([0], device="cpu"), _port_pair(), arrays,
                               N_SLAB, SLAB_OPTS, solver)
    assert eng.backend == solver
    assert (np.abs(ref["lam"]) > 0).any(1).all() and np.abs(ref["q"][:, 0]).max() > 0
    for k in SIM_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], atol=F64_ATOL, rtol=0, err_msg=k)


CART_OPTS = dict(contact_model="constraint")  # 1 ms, 16 sweeps: EngineOptions' defaults


def _cart_states(seed, n=6):
    """Carts within 2 mm of a limit (both sides) moving outward at
    0.5–2.5 m/s, the motor pushing outward at 30 N (past its 30 N effort
    limit in half), the pole ±0.5 rad."""
    rng = np.random.default_rng(seed)
    side = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    q = np.stack([side * (2.4 + rng.uniform(-0.002, 0.002, n)), rng.uniform(-0.5, 0.5, n)], 1)
    v = np.stack([side * rng.uniform(0.5, 2.5, n), rng.standard_normal(n)], 1)
    u = (side * rng.uniform(20.0, 40.0, n))[:, None]
    return q, v, np.abs(0.05 * rng.standard_normal((n, 1))), u


@pytest.fixture(scope="module")
def cart_ref():
    jtree, jmotors = jtoys.make_cartpole(), JMotors.create([0], effort_limit=30.0)
    arrays = _cart_states(23)
    return jtree, arrays, _jax_f64_steps(jtree, jmotors, (), arrays, N_CART, CART_OPTS)


@pytest.mark.parametrize("solver", ["substep", "kernel", "inline"])
def test_cartpole_bound_row_matches_reference_f64(cart_ref, solver):
    jtree, arrays, ref = cart_ref
    tree = tree_from_arrays(_arrays(jtree), device="cpu")
    eng, got = _port_f64_steps(tree, Motors.create([0], effort_limit=30.0, device="cpu"), (),
                               arrays, N_CART, CART_OPTS, solver)
    assert eng.nc == 1 and eng.substep_spec.bounded_joints == [0]
    # the bound row binds in every env and holds each cart within 1 mm of its limit
    assert (ref["lam"][:, 0] > 0).all()
    assert np.abs(ref["q"][:, 0]).max() < 2.401
    for k in SIM_FIELDS:
        np.testing.assert_allclose(got[k], ref[k], atol=F64_ATOL, rtol=0, err_msg=k)
