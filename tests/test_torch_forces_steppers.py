"""The port's ABA, forest merge, registered forces, steppers and the
impulse substep off the kernels against jiminy_tpu's.

A small scene built with both packages' builders (a FREE base with two
bounded legs, one ending in a bounded PRISMATIC slider, and a SPHERICAL
neck; feet and base corners as contact points) carries most cases:

- ``algos.aba`` within 1e-9 of the reference's (float64, x64 on, the
  reference's model in float64), and of the port's own CRBA solve on
  ANYmal;
- ``merge_trees`` of two pendulums field for field against
  ``tree_from_arrays`` of the reference's merged tree;
- the three registered forces (``compute_forces``: an impulse in its
  window in some envs and out of it in others, a profile of time, a
  coupling of two frames) within 1e-9, and the reference's momentum tests
  (tests/test_forces_multirobot.py) on the port's engine;
- one step of symplectic Euler, RK4 and DOPRI-5 on the double pendulum
  within 1e-9, and ``integrate_adaptive``'s counters equal to the
  reference's on the pendulum (float64), through
  ``Engine.simulate_adaptive``, which refuses the impulse path and a
  batch of more than one;
- one impulse substep of the scene with a locked joint, penalty contacts
  (the reference's ``m_eff`` carried in), registered forces and the
  bounds as rows or as penalty torques, on ``"kernel"`` (the plain chain
  on the CPU) and ``"inline"`` against the reference's ``"xla"`` engine
  within 1e-9 (one reference program per bounds model);
- the route: ``"auto"`` takes the chain kernel for each of these impulse
  models (disabled bounds too), an explicit ``"substep"`` raises at
  ``Engine(...)``, and the impulse path with RK4 raises.
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
from jiminy_tpu.core.tree import merge_trees as j_merge_trees
from jiminy_tpu.engine import constraints as jc
from jiminy_tpu.engine import forces as jf
from jiminy_tpu.engine import steppers as jst
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.ground import FlatGround as JFlatGround
from jiminy_tpu.models import toys as jtoys
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    merge_trees,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine import forces as pf
from jiminy_tpu_torch.engine import steppers
from jiminy_tpu_torch.engine.constraints import JointConstraint
from jiminy_tpu_torch.engine.forces import (
    CouplingForce,
    ImpulseForce,
    ProfileForce,
    compute_forces,
)
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.math import linalg
from jiminy_tpu_torch.models import toys

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 6
DT = 1e-3
F64 = dict(device="cpu", dtype=torch.float64)


def _f64(jtree):
    """The reference tree with its arrays in float64 (x64 must be on)."""
    return jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})


def _port_tree(jtree):
    fields = {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    return tree_from_arrays(fields, **F64)


def _scene(TB, JT):
    """A FREE base, two bounded legs about y (the second ending in a
    bounded slider), a SPHERICAL neck; frames at the tips and the base
    centre; contact points at the feet and four base corners."""
    diag = np.diag
    b = TB()
    base = b.add_body("base", -1, JT.FREE, mass=2.0, com=(0.01, 0.0, 0.02),
                      inertia=diag([0.05, 0.06, 0.07]), joint_name="root")
    l1 = b.add_body("leg1", base, JT.REVOLUTE, placement=TB.make_placement(pos=(0.2, 0.1, 0.0)),
                    axis=(0, 1, 0), mass=0.5, com=(0, 0, -0.15),
                    inertia=diag([0.004, 0.004, 0.001]), joint_name="hip1",
                    q_limits=(-0.6, 0.6), damping=0.1)
    l2 = b.add_body("leg2", base, JT.REVOLUTE, placement=TB.make_placement(pos=(-0.2, -0.1, 0.0)),
                    axis=(0, 1, 0), mass=0.5, com=(0, 0, -0.15),
                    inertia=diag([0.004, 0.004, 0.001]), joint_name="hip2", q_limits=(-0.6, 0.6))
    sl = b.add_body("slider", l2, JT.PRISMATIC, placement=TB.make_placement(pos=(0, 0, -0.3)),
                    axis=(0, 0, 1), mass=0.2, inertia=diag([1e-3] * 3), joint_name="knee2",
                    q_limits=(-0.05, 0.05))
    b.add_body("head", base, JT.SPHERICAL, placement=TB.make_placement(pos=(0.25, 0, 0.1)),
               mass=0.3, com=(0, 0, 0.1), inertia=diag([2e-3, 2e-3, 1e-3]), joint_name="neck")
    b.add_frame("tip1", l1, TB.make_placement(pos=(0, 0, -0.3)))
    b.add_frame("tip2", sl, TB.make_placement(pos=(0, 0, -0.05)))
    b.add_frame("center", base)
    b.add_contact_point("foot1", l1, (0.0, 0.0, -0.3))
    b.add_contact_point("foot2", sl, (0.0, 0.0, -0.05))
    for k, (x, y) in enumerate(((0.25, 0.15), (0.25, -0.15), (-0.25, 0.15), (-0.25, -0.15))):
        b.add_contact_point(f"corner{k}", base, (x, y, -0.05))
    return b


def _scene_state(rng, n=B):
    """Bases low enough that some feet and corners penetrate, legs and
    the slider spread over their limits (some past them), tumbling."""
    q = np.zeros((n, 7 + 1 + 1 + 1 + 4))
    q[:, 2] = 0.29 + rng.uniform(-0.03, 0.01, n)
    quat = np.concatenate([rng.uniform(-0.1, 0.1, (n, 3)), np.ones((n, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7] = 0.25 + rng.uniform(-0.01, 0.01, n)  # near the lock's 0.25
    q[:, 8] = rng.uniform(-0.7, 0.7, n)
    q[:, 9] = rng.uniform(-0.07, 0.07, n)
    q[0, 8], q[1, 9] = 0.65, -0.06  # past their bounds
    neck = np.concatenate([rng.uniform(-0.3, 0.3, (n, 3)), np.ones((n, 1))], 1)
    q[:, 10:14] = neck / np.linalg.norm(neck, axis=1, keepdims=True)
    v = rng.normal(0.0, 0.5, (n, 6 + 3 + 3))
    return q, v


def _jt_lin(t):
    return jnp.array([3.0 * jnp.cos(5.0 * t), 1.5, -2.0 * jnp.sin(3.0 * t)])


def _pt_lin(t):
    return torch.stack([3.0 * torch.cos(5.0 * t), torch.full_like(t, 1.5),
                        -2.0 * torch.sin(3.0 * t)], dim=-1)


def _forces(mod, tree, lin):
    """An impulse (a wrench) at tip 1 in [0.002, 0.006), a profile force at
    the base centre, a coupling of the two tips (all gains per axis or
    scalar), in ``mod``'s classes."""
    f = tree.frame_name.index
    if mod is jf:
        imp = jf.ImpulseForce(frame=f("tip1"), t_start=jnp.float32(0.002),
                              duration=jnp.float32(0.004),
                              force=jnp.array([0.5, -0.2, 0.1, 8.0, -3.0, 5.0]))
    else:
        imp = ImpulseForce(f("tip1"), float(np.float32(0.002)), float(np.float32(0.004)),
                           torch.tensor([0.5, -0.2, 0.1, 8.0, -3.0, 5.0], dtype=torch.float64))
    prof = mod.ProfileForce(frame=f("center"), fn=lin)
    coup = mod.CouplingForce.create(f("tip1"), f("tip2"), k_lin=40.0, c_lin=2.5,
                                    k_ang=(3.0, 1.0, 2.0), c_ang=0.25)
    return imp, prof, coup


@pytest.fixture(scope="module")
def scene():
    """The reference's scene (float32 build) and the port's from its arrays."""
    jtree = _scene(JTreeBuilder, JJointType).build()
    return jtree, _port_tree(jtree)


def test_scene_builders_agree(scene):
    jtree, tree = scene
    ours = _scene(TreeBuilder, JointType).build(**F64)
    for k in ARRAY_FIELDS:
        torch.testing.assert_close(getattr(ours, k), getattr(tree, k), atol=0, rtol=0)


def test_aba_matches_reference_and_crba_solve(scene):
    jtree, tree = scene
    rng = np.random.default_rng(0)
    q, v = _scene_state(rng)
    tau = rng.normal(0.0, 2.0, v.shape)
    fext = rng.normal(0.0, 1.0, (B, tree.nb, 6))
    with jax.enable_x64(True):
        jt = _f64(jtree)
        want = np.asarray(jax.jit(jax.vmap(lambda *a: jalgos.aba(jt, *a)))(
            jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau), jnp.asarray(fext)))
    qt, vt, taut, ft = (torch.as_tensor(x) for x in (q, v, tau, fext))
    got = algos.aba(tree, qt, vt, taut, ft)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    # the port's own mass-matrix solve, on the scene and on ANYmal
    M = algos.crba(tree, qt)
    bias = algos.rnea(tree, qt, vt, torch.zeros_like(vt), fext=ft)
    torch.testing.assert_close(got, linalg.solve_psd(M, taut - bias), atol=1e-9, rtol=0)
    from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

    an = make_anymal(**F64)[0]
    qa = torch.as_tensor(np.tile(np.asarray(stand_q(an), np.float64), (B, 1)))
    qa[:, 7:] += torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)))
    va = torch.as_tensor(rng.normal(0.0, 1.0, (B, an.nv)))
    ta = torch.as_tensor(rng.normal(0.0, 10.0, (B, an.nv)))
    a_crba = linalg.solve_psd(algos.crba(an, qa),
                              ta - algos.rnea(an, qa, va, torch.zeros_like(va)))
    torch.testing.assert_close(algos.aba(an, qa, va, ta), a_crba, atol=1e-9, rtol=0)


def test_merge_trees_field_for_field():
    jp = jtoys.make_pendulum()
    jm = j_merge_trees([jp, jtoys.make_double_pendulum()], prefixes=["a/", "b/"])
    want = _port_tree(jm)
    p = toys.make_pendulum(**F64)
    got = merge_trees([p, toys.make_double_pendulum(**F64)], prefixes=["a/", "b/"])
    for k in STATIC_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(want, k), atol=0, rtol=0)
    two = merge_trees([p, p])
    assert two.frame_body == (0, 1) and two.contact_body == (0, 1)
    assert two.frame_name[1] == "robot1/tip" and two.parent == (-1, -1)


def test_compute_forces_matches_reference(scene):
    jtree, tree = scene
    rng = np.random.default_rng(1)
    q, v = _scene_state(rng)
    t = np.array([0.0, 0.002, 0.004, 0.0059, 0.006, 0.1])  # the window's edges
    with jax.enable_x64(True):
        jt = _f64(jtree)
        jforces = _forces(jf, jt, _jt_lin)

        def one(q_, v_, t_):
            xw, vel = jalgos.kinematics(jt, q_, v_)
            return jf.compute_forces(jt, jforces, t_, xw, vel, q_.dtype)

        want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t)))
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    xw, vel = algos.kinematics(tree, qt, vt)
    got = compute_forces(tree, _forces(pf, tree, _pt_lin), torch.as_tensor(t), xw, vel)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    # the impulse acts in its window only: tip 1's body has it at 0.002 and
    # 0.004, not at 0 or 0.006
    assert np.abs(want[1] - want[0]).max() > 1.0 and np.abs(want[4] - want[5]).max() < 20.0


def _box(mass, inertia, **kw):
    b = TreeBuilder(**kw)
    box = b.add_body("box", -1, JointType.FREE, mass=mass, inertia=np.diag([inertia] * 3),
                     joint_name="root")
    b.add_frame("center", box)
    return b.build(**F64)


def _run(eng, q0, n, u=None):
    st = eng.reset(torch.as_tensor(np.asarray(q0, np.float64))[None])
    nu = eng.tree.nv
    return eng.step(st, torch.zeros(1, nu, dtype=torch.float64) if u is None else u, n_substeps=n)


def test_registered_forces_momentum():
    """tests/test_forces_multirobot.py's cases on the port's engine (the
    hover, the period and the coupling on coarser substeps than there:
    the same physics in fewer plain substeps)."""
    low = FlatGround(height=-100.0)
    box = _box(2.0, 0.02, gravity=(0, 0, 0))
    q0 = box.neutral_q()
    imp = ImpulseForce(0, 0.05, 0.1, torch.tensor([4.0, 0.0, 0.0]))
    eng = Engine(box, EngineOptions(dt=1e-3), ground=low, forces=(imp,), device="cpu")
    assert eng.backend == "inline" and not eng.impulse
    st = _run(eng, q0, 300)
    # Δv = F·Δt/m = 4·0.1/2
    assert abs(float(st.v[0, 0]) - 0.2) < 5e-3 and abs(float(st.v[0, 1])) < 1e-6
    late = Engine(box, EngineOptions(dt=1e-3), ground=low, device="cpu",
                  forces=(ImpulseForce(0, 1.0, 0.1, torch.tensor([4.0, 0.0, 0.0])),))
    assert abs(float(_run(late, q0, 100).v[0, 0])) < 1e-8  # before the window
    heavy = _box(1.5, 0.01)
    hover = Engine(heavy, EngineOptions(dt=5e-3), ground=low, device="cpu",
                   forces=(ProfileForce(0, lambda t: torch.tensor([0.0, 0.0, 1.5 * 9.81],
                                                                  dtype=t.dtype)),))
    q1 = heavy.neutral_q()
    q1[2] = 1.0
    assert abs(float(_run(hover, q1, 100).q[0, 2]) - 1.0) < 1e-4
    unit = _box(1.0, 0.01, gravity=(0, 0, 0))
    periodic = Engine(unit, EngineOptions(dt=5e-3), ground=low, device="cpu", forces=(
        ProfileForce(0, lambda t: torch.stack([torch.cos(2 * torch.pi * t), 0 * t, 0 * t], -1)),))
    assert abs(float(_run(periodic, q0, 200).v[0, 0])) < 5e-3  # one period: no net impulse
    merged = merge_trees([unit, unit])
    coup = CouplingForce.create(0, 1, k_lin=20.0, c_lin=4.0)
    eng = Engine(merged, EngineOptions(dt=1e-2), ground=low, forces=(coup,), device="cpu")
    q2 = merged.neutral_q()
    q2[7] = 1.0
    st = _run(eng, q2, 300)
    assert float(st.q[0, 7] - st.q[0, 0]) < 0.25  # pulled together
    assert abs(float(st.v[0, 0] + st.v[0, 6])) < 1e-4  # no net momentum
    assert abs(float(st.q[0, 0]) - 0.5) < 0.3  # toward the common centre


@pytest.mark.parametrize("name", ["euler_symplectic", "runge_kutta_4", "dopri5"])
def test_one_step_of_each_stepper(name):
    """The double pendulum under a torque command, each env at its own
    time: the reference's stepper around its compiled ``Engine.dynamics``
    and the port's around its own, within 1e-9."""
    rng = np.random.default_rng(2)
    q = rng.uniform(-1.5, 1.5, (B, 2))
    v = rng.normal(0.0, 1.0, (B, 2))
    t = rng.uniform(0.0, 1.0, B)
    u = np.array([0.3, -0.2])
    dt = 5e-3
    with jax.enable_x64(True):
        jtree = _f64(jtoys.make_double_pendulum())
        je = JEngine(jtree, JEngineOptions(dt=DT))
        jdyn = jax.jit(lambda q_, v_, t_: je.dynamics(q_, v_, t_, jnp.asarray(u), je.ground)[0])
        jfn = jst.runge_kutta_dopri5 if name == "dopri5" else jst.STEPPERS[name]
        want = jax.vmap(lambda q_, v_, t_: jfn(jtree, jdyn, q_, v_, t_, dt))(
            jnp.asarray(q), jnp.asarray(v), jnp.asarray(t))
    tree = _port_tree(jtoys.make_double_pendulum())
    pe = Engine(tree, EngineOptions(dt=DT), device="cpu")
    ut = torch.as_tensor(u)[None].expand(B, 2)

    def pdyn(q_, v_, t_):
        return pe.dynamics(q_, v_, t_, ut)[0]

    fn = steppers.runge_kutta_dopri5 if name == "dopri5" else steppers.STEPPERS[name]
    got = fn(tree, pdyn, torch.as_tensor(q), torch.as_tensor(v), torch.as_tensor(t), dt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9, rtol=0)


def test_integrate_adaptive_counters_match_reference():
    """The pendulum from 1.2 rad for 1 s: the reference's
    ``simulate_adaptive`` (its while loop) and the port's, float64; equal
    counters, the states within 1e-9."""
    with jax.enable_x64(True):
        jtree = _f64(jtoys.make_pendulum())
        je = JEngine(jtree, JEngineOptions(dt=1e-3), ground=JFlatGround(height=jnp.float64(-100.0)))
        jst0 = je.reset(q=jnp.asarray([1.2]))
        jfin, jstats = jax.jit(lambda s: je.simulate_adaptive(s, 1.0))(jst0)
        want = {k: int(x) for k, x in jstats.items()}
        jq, jv = np.asarray(jfin.q), np.asarray(jfin.v)
    tree = _port_tree(jtoys.make_pendulum())
    eng = Engine(tree, EngineOptions(dt=1e-3), ground=FlatGround(height=-100.0), device="cpu")
    eng.contact_m_eff = torch.as_tensor(np.asarray(je._contact_m_eff, np.float64))
    st = eng.reset(torch.tensor([[1.2]], dtype=torch.float64))
    fin, stats = eng.simulate_adaptive(st, 1.0)
    assert stats == want and want["rejected"] + want["accepted"] == want["iters"]
    assert want["accepted"] > 10
    np.testing.assert_allclose(fin.q[0].numpy(), jq, atol=1e-9, rtol=0)
    np.testing.assert_allclose(fin.v[0].numpy(), jv, atol=1e-9, rtol=0)
    assert abs(float(fin.t[0]) - 1.0) < 1e-12
    with pytest.raises(ValueError, match="one trajectory"):
        eng.simulate_adaptive(eng.reset(torch.zeros(2, 1, dtype=torch.float64)), 0.1)
    imp = Engine(tree, EngineOptions(contact_model="constraint"), device="cpu")
    with pytest.raises(ValueError, match="spring-damper"):
        imp.simulate_adaptive(imp.reset(torch.zeros(1, 1)), 0.1)


def _scene_engines(jtree, tree, bounds_model):
    jopts = JEngineOptions(dt=DT, constraint_solver="xla", bounds_model=bounds_model,
                           pgs_iters=12)
    je = JEngine(jtree, jopts, constraints=(jc.JointConstraint(joint=1, ref_q=jnp.float32(0.25),
                                                              baumgarte_freq=20.0),),
                 forces=_forces(jf, jtree, _jt_lin))
    ports = {}
    for solver in ("kernel", "inline"):
        opts = EngineOptions(dt=DT, constraint_solver=solver, bounds_model=bounds_model,
                             pgs_iters=12)
        pe = Engine(tree, opts, constraints=(JointConstraint(1, ref_q=0.25),),
                    forces=_forces(pf, tree, _pt_lin), device="cpu")
        pe.contact_m_eff = torch.as_tensor(np.asarray(je._contact_m_eff, np.float64))
        ports[solver] = pe
    return je, ports


@pytest.mark.parametrize("bounds_model, nc", [("auto", 4), ("penalty", 1)],
                         ids=["bound_rows", "penalty_bounds"])
def test_impulse_substep_off_the_kernels(scene, bounds_model, nc):
    """A lock, penalty contacts, registered forces (each env at its own
    time) and the bounds as rows or as penalty torques: one substep on
    "kernel" and "inline" within 1e-9 of the reference's "xla"."""
    jtree, tree = scene
    rng = np.random.default_rng(3)
    q, v = _scene_state(rng)
    t = np.array([0.0, 0.002, 0.004, 0.0059, 0.006, 0.1])
    u = rng.normal(0.0, 1.0, (B, tree.nv))
    with jax.enable_x64(True):
        jt = _f64(jtree)
        je, ports = _scene_engines(jt, tree, bounds_model)
        assert je.n_constraint_rows == nc

        def one(q_, v_, t_, u_):
            s = je.reset(q_, v_).replace(t=t_)
            return je.step(s, u_, n_substeps=1)

        out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (q, v, t, u)))
    for solver, pe in ports.items():
        assert pe.backend == solver and pe.nc == nc and pe.substep_spec.penalty
        st = pe.reset(torch.as_tensor(q), torch.as_tensor(v))
        st = dataclasses.replace(st, t=torch.as_tensor(t))
        got = pe.step(st, torch.as_tensor(u), n_substeps=1)
        for f in ("q", "v", "lam", "a", "tau", "contact_forces"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(out, f)),
                                       atol=1e-9 * max(1.0, float(np.abs(getattr(out, f)).max())),
                                       rtol=0, err_msg=f"{solver} {f}")
    # contacts in the ground in most envs, a joint past its bound in some
    assert (np.abs(np.asarray(out.contact_forces)).sum(axis=(1, 2)) > 0).sum() >= B // 2
    assert (np.abs(q[:, 8]) > 0.6).any() and (np.abs(q[:, 9]) > 0.05).any()


def test_joint_torque_order_matches_reference(scene):
    """The actuation torque in the reference's order: the command, joint
    damping, penalty bounds (joints past their limits), then
    ``internal_dynamics(q, v, t)`` at each env's time; the hook keeps the
    torque off the fused kernel."""
    jtree, tree = scene
    rng = np.random.default_rng(4)
    q, v = _scene_state(rng)
    t = rng.uniform(0.0, 1.0, B)
    u = rng.normal(0.0, 1.0, (B, tree.nv))

    def hook(mod):
        sin, cos = (jnp.sin, jnp.cos) if mod is jnp else (torch.sin, torch.cos)
        return lambda q_, v_, t_: -3.0 * sin(q_[..., 7:8]) * cos(2.0 * t_)[..., None] * (
            v_[..., 6:7] + 1.0)

    with jax.enable_x64(True):
        jt = _f64(jtree)
        je = JEngine(jt, JEngineOptions(dt=DT, bounds_model="penalty"),
                     internal_dynamics=hook(jnp))
        want = np.asarray(jax.jit(jax.vmap(je._joint_torque))(
            *(jnp.asarray(x) for x in (u, q, v, t))))
    eng = Engine(tree, EngineOptions(dt=DT, bounds_model="penalty"),
                 internal_dynamics=hook(torch), device="cpu")
    got = eng._joint_torque(*(torch.as_tensor(x) for x in (u, q, v)), t=torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    assert float(eng._bound_torques(torch.as_tensor(q), torch.as_tensor(v)).abs().max()) > 10.0
    from jiminy_tpu_torch.engine import PDController
    from jiminy_tpu_torch.hardware.motors import Motors

    kw = dict(motors=Motors.create([6, 7], [7, 8], device="cpu"), controller=PDController(5.0, 0.5),
              device="cpu")
    plain = Engine(tree, EngineOptions(dt=DT, contact_model="constraint"), **kw)
    hooked = Engine(tree, EngineOptions(dt=DT, contact_model="constraint"),
                    internal_dynamics=hook(torch), **kw)
    assert plain._fusable and not hooked._fusable and hooked.backend == "substep"


def test_routes_off_the_kernels(scene):
    """Each impulse model off the whole-substep kernels goes to the chain
    kernel through "auto"; "substep" raises at Engine(...); the impulse
    path needs symplectic Euler."""
    _, tree = scene
    lock = (JointConstraint(1, ref_q=0.25),)
    base = dict(dt=DT, contact_model="constraint")
    cases = [
        ("contact_model must be 'constraint'", dict(opts=dict(dt=DT), constraints=lock)),
        ("registered forces unsupported", dict(opts=base, forces=(
            ImpulseForce(0, 0.0, 1.0, torch.tensor([1.0, 0.0, 0.0])),))),
        ("bounds must run as constraints", dict(opts=dict(base, bounds_model="penalty"))),
        ("bounds must run as constraints", dict(opts=dict(base, enable_bounds=False))),
        ("bounds must run as constraints", dict(opts=dict(dt=DT, enable_bounds=False),
                                                constraints=lock)),
    ]
    for msg, c in cases:
        kw = {k: c[k] for k in ("constraints", "forces") if k in c}
        eng = Engine(tree, EngineOptions(**c["opts"]), device="cpu", **kw)
        assert eng.backend == "kernel" and eng.impulse, msg
        with pytest.raises(ValueError, match=msg):
            Engine(tree, EngineOptions(**c["opts"], constraint_solver="substep"), device="cpu",
                   **kw)
    assert Engine(tree, EngineOptions(**base), device="cpu").backend == "substep"
    with pytest.raises(ValueError, match="euler_symplectic"):
        Engine(tree, EngineOptions(**base, solver="runge_kutta_4"), device="cpu")
    explicit = Engine(tree, EngineOptions(**base, solver="euler_explicit"), device="cpu")
    assert explicit.backend == "substep"
    # the continuous path: no solve, "auto" is "inline", "substep" raises
    cont = Engine(tree, EngineOptions(dt=DT, solver="runge_kutta_4"), device="cpu")
    assert cont.backend == "inline" and cont.nc == 0 and not cont.impulse
    with pytest.raises(ValueError, match="stepper must be euler_symplectic"):
        Engine(tree, EngineOptions(dt=DT, solver="runge_kutta_4", constraint_solver="substep"),
               device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        Engine(tree, EngineOptions(solver="runge_kutta_dopri"), device="cpu")
    with pytest.raises(TypeError, match="not a registered force"):
        Engine(tree, EngineOptions(**base), forces=(object(),), device="cpu")
