"""The port's penalty (spring-damper) contact model and continuous path
against jiminy_tpu's, on ANYmal.

- ``contact_effective_mass`` within 1e-5 relative of the reference's
  (each builds its own from the float32 tree);
- ``penalty_forces`` (with the friction clamp and each env's contact
  parameters), ``forces_to_fext`` and ``compute_contact_fext`` on ANYmal
  states with feet in and out of the ground, for bare points and for the
  feet as 2 cm spheres, within 1e-9 (float64 on both sides, x64 scoped);
- ``Engine.dynamics`` and one continuous step at B = 8 (penalty contacts
  and bounds, a joint past its limit, the PD, a registered force, a root
  wrench and each env's contact parameters): a, the contact forces and τ
  within 1e-9 relative to their scale, q and v after the step within
  1e-9 (the reference's ``m_eff`` carried into the port's engine: the
  clamp is active, and one float32 ulp of m_eff moves it);
- the reference's ``test_spring_damper_override`` with each env's
  stiffness and damping in one batch: the soft ground sinks deeper;
- the gantry ANYmal on the reference's default contact model: penalty
  contacts beside its weld and lock, no contact rows (nc 19), through the
  chain kernel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.engine import contact as jcontact
from jiminy_tpu.engine import forces as jf
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.engine.ground import FlatGround as JFlatGround
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import contact
from jiminy_tpu_torch.engine.contact import ContactParams
from jiminy_tpu_torch.engine.forces import ImpulseForce
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models.toys import make_free_box

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
DT = 1e-3
F64 = dict(device="cpu", dtype=torch.float64)
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
CONTACT_FIELDS = ("stiffness", "damping", "friction", "transition_velocity", "transition_eps")


def _f64(jtree):
    """The reference tree with its arrays in float64 (x64 must be on)."""
    return jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})


def _port_tree(jtree):
    fields = {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    return tree_from_arrays(fields, **F64)


@pytest.fixture(scope="module")
def anymal():
    """The reference ANYmal (float32 build), the port's tree and motors
    from its arrays, and the reference's m_eff of the float32 tree."""
    jrobot = j_make_anymal()
    motors = motors_from_arrays({k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS},
                                **F64)
    return jrobot, _port_tree(jrobot.tree), motors, jcontact.contact_effective_mass(jrobot.tree)


def _states(jrobot, rng, n=B):
    """Stand poses with the base 0–6 cm low (feet in the ground) or up to
    3 cm high (feet out), tilted, legs spread, moving; env 0's LF knee past
    its limit."""
    q = np.tile(np.asarray(j_stand_q(jrobot.tree), np.float64), (n, 1))
    q[:, 7:] += rng.uniform(-0.2, 0.2, (n, 12))
    q[:, 2] += rng.uniform(-0.06, 0.03, n)
    quat = np.concatenate([rng.uniform(-0.08, 0.08, (n, 3)), np.ones((n, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[0, 7 + 2] = np.asarray(jrobot.tree.q_max)[7 + 2] + 0.05
    v = rng.normal(0.0, 0.4, (n, 18))
    return q, v


def _contact_params(rng, n=B):
    """Each env's contact parameters around the options' defaults."""
    d = ContactParams()
    return {k: getattr(d, k) * rng.uniform(0.5, 1.5, n) for k in CONTACT_FIELDS}


def test_contact_effective_mass_matches_reference(anymal):
    jrobot, tree, _, m_ref = anymal
    got = contact.contact_effective_mass(tree)
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got, m_ref, rtol=1e-5, atol=0)
    assert np.all(got > 0.1) and np.all(got < 3.0)  # a leg's inertia, not the weight it carries
    eng = Engine(tree, EngineOptions(dt=DT), device="cpu")
    torch.testing.assert_close(eng.contact_m_eff, torch.as_tensor(got, dtype=torch.float64))


@pytest.mark.parametrize("radius", [0.0, 0.02], ids=["points", "spheres"])
def test_contact_pipeline_matches_reference(anymal, radius):
    jrobot, tree, _, m_ref = anymal
    rng = np.random.default_rng(int(radius * 100))
    q, v = _states(jrobot, rng)
    cp = _contact_params(rng)
    r = np.full(tree.ncp, radius, np.float32)
    with jax.enable_x64(True):
        jt = _f64(jrobot.tree).replace(contact_radius=jnp.asarray(r, jnp.float64))
        ground = JFlatGround()

        def one(q_, v_, *p):
            params = jcontact.ContactParams(**dict(zip(CONTACT_FIELDS, p)))
            xw, vel = jalgos.kinematics(jt, q_, v_)
            pts, vels, depth, n = jcontact.surface_contacts(jt, xw, vel, ground)
            f_w = jcontact.penalty_forces(depth, n, vels, params, dt=DT, m_eff=m_ref)
            fext, f_c = jcontact.compute_contact_fext(jt, xw, vel, ground, params, dt=DT,
                                                      m_eff=m_ref)
            return dict(f_w=f_w, fext_w=jcontact.forces_to_fext(jt, xw, f_w, pts), fext=fext,
                        f_c=f_c, depth=depth,
                        free=jcontact.penalty_forces(depth, n, vels, params))

        want = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (q, v, *cp.values())))
        want = {k: np.asarray(x) for k, x in want.items()}
    t = dataclasses.replace(tree, contact_radius=torch.as_tensor(r, dtype=torch.float64))
    params = ContactParams(**{k: torch.as_tensor(x) for k, x in cp.items()})
    m_eff = torch.as_tensor(m_ref, dtype=torch.float64)
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    xw, vel = algos.kinematics(t, qt, vt)
    pts, vels, depth, n = contact.surface_contacts(t, xw, vel, FlatGround(), radius > 0)
    f_w = contact.penalty_forces(depth, n, vels, params, dt=DT, m_eff=m_eff)
    fext, f_c = contact.compute_contact_fext(t, xw, vel, FlatGround(), params, dt=DT, m_eff=m_eff)
    got = dict(f_w=f_w, fext_w=contact.forces_to_fext(t, xw, f_w, pts), fext=fext, f_c=f_c,
               depth=depth, free=contact.penalty_forces(depth, n, vels, params))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-9 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=k)
    # feet in and out of the ground, and the clamp active somewhere
    assert (want["depth"] > 0).any() and (want["depth"] < 0).any()
    assert np.abs(want["f_w"] - want["free"]).max() > 1.0


def test_dynamics_and_continuous_step_match_reference(anymal):
    """Penalty contacts and bounds, the PD, an impulse on the base and a
    root wrench, each env's contact parameters: ``dynamics`` at the state
    and after one continuous step, within 1e-9 of the reference's."""
    jrobot, tree, motors, m_ref = anymal
    rng = np.random.default_rng(5)
    q, v = _states(jrobot, rng)
    cp = _contact_params(rng)
    stand = np.asarray(j_stand_q(jrobot.tree), np.float64)[7:]
    u = stand + rng.uniform(-0.3, 0.3, (B, 12))
    t = np.full(B, 0.004)
    t[: B // 2] = 0.0  # half the envs inside the impulse's window
    wrench = rng.normal(0.0, 5.0, (B, 6))
    base = tree.frame_index("base_frame") if "base_frame" in tree.frame_name else 0
    f_imp = np.array([20.0, -10.0, 30.0])
    with jax.enable_x64(True):
        jt = _f64(jrobot.tree)
        je = JEngine(jt, JEngineOptions(dt=DT), motors=jrobot.motors,
                     controller=JPDController(80.0, 2.0), forces=(
                         jf.ImpulseForce(frame=base, t_start=jnp.float64(0.003),
                                         duration=jnp.float64(0.01), force=jnp.asarray(f_imp)),))
        je._contact_m_eff = m_ref  # the float32 tree's, as the port's engine carries

        def dyn(q_, v_, t_, u_, w_, *p):
            params = jcontact.ContactParams(**dict(zip(CONTACT_FIELDS, p)))
            fext = jnp.zeros((jt.nb, 6)).at[0].set(w_)
            a, f = je.dynamics(q_, v_, t_, u_, je.ground, fext, contact_params=params)
            return a, f, je._joint_torque(u_, q_, v_, t_)

        jdyn = jax.jit(jax.vmap(dyn))
        jint = jax.jit(jax.vmap(lambda q_, v_: jalgos.integrate(jt, q_, v_, DT)))
        args = [jnp.asarray(x) for x in (u, wrench, *cp.values())]
        a0, f0, tau0 = jdyn(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t), *args)
        v1 = jnp.asarray(v) + a0 * DT
        q1 = jint(jnp.asarray(q), v1)
        a1, f1, tau1 = jdyn(q1, v1, jnp.asarray(t) + DT, *args)
        want0 = [np.asarray(x) for x in (a0, f0, tau0)]
        want1 = {k: np.asarray(x) for k, x in dict(q=q1, v=v1, a=a1, contact_forces=f1,
                                                   tau=tau1).items()}
    eng = Engine(tree, EngineOptions(dt=DT), motors=motors, controller=PDController(80.0, 2.0),
                 forces=(ImpulseForce(base, 0.003, 0.01, torch.as_tensor(f_imp)),), device="cpu")
    assert eng.backend == "inline" and eng.nc == 0 and eng.substep_spec.bounds_mode == "penalty"
    eng.contact_m_eff = torch.as_tensor(m_ref, dtype=torch.float64)
    params = ContactParams(**{k: torch.as_tensor(x) for k, x in cp.items()})
    qt, vt, tt, ut, wt = (torch.as_tensor(x) for x in (q, v, t, u, wrench))
    fext = torch.zeros(B, tree.nb, 6, dtype=torch.float64)
    fext[:, 0] = wt
    a, f = eng.dynamics(qt, vt, tt, ut, fext_user=fext, contact_params=params)
    for g, w, name in zip((a, f, eng._joint_torque(ut, qt, vt, t=tt)), want0, ("a", "f", "tau")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=name)
    st = dataclasses.replace(eng.reset(qt, vt), t=tt)
    nxt = eng.step(st, ut, n_substeps=1, base_wrench=wt, contact_params=params)
    for k, w in want1.items():
        np.testing.assert_allclose(getattr(nxt, k).numpy(), w,
                                   atol=1e-9 * max(1.0, np.abs(w).max()), rtol=0, err_msg=k)
    assert nxt.lam.shape == (B, 0) and float(nxt.solver_residual.abs().max()) == 0.0
    # the penalty bound pushes env 0's knee back; the others are inside
    bt = eng._bound_torques(qt, vt)
    assert float(bt[0].abs().max()) > 100.0 and float(bt[1:].abs().max()) == 0.0


def test_spring_damper_override_per_env():
    """tests/test_domain_randomization.py's case, the soft and the default
    ground as two envs of one batch."""
    tree = make_free_box(**F64)
    eng = Engine(tree, EngineOptions(dt=DT), device="cpu")
    d = ContactParams()
    params = ContactParams(
        stiffness=torch.tensor([5e3, d.stiffness], dtype=torch.float64),
        damping=torch.tensor([100.0, d.damping], dtype=torch.float64),
        friction=1.0, transition_velocity=0.01, transition_eps=1e-3)
    q0 = torch.as_tensor(tree.neutral_q(), dtype=torch.float64).expand(2, -1).clone()
    q0[:, 2] = 0.12
    out = eng.step(eng.reset(q0), torch.zeros(2, tree.nv, dtype=torch.float64), n_substeps=1500,
                   contact_params=params)
    z_soft, z_stiff = out.q[:, 2].tolist()
    # soft ground sinks deeper at rest than the default stiff ground (which
    # the explicit step at 1 ms keeps bouncing, in the reference too)
    assert z_soft < z_stiff - 1e-4
    assert 0.09 < z_soft < 0.1 and bool(torch.isfinite(out.v).all())


def test_gantry_on_the_default_contact_model():
    """The gantry's weld and lock ahead of its 12 bound rows, its feet as
    penalty contacts (no contact rows): nc 19, through the chain kernel;
    one env step."""
    from jiminy_tpu_torch.envs import ANYmalGantryEnv

    opts = EngineOptions(dt=DT, pgs_iters=8, compute_solver_residual=False)
    env = ANYmalGantryEnv(observe="state", engine_options=opts, device="cpu")
    eng = env.engine
    cfg = eng.substep_spec.cfg
    assert eng.backend == "kernel" and eng.nc == 19 and eng.substep_spec.penalty
    assert [tuple(b)[1:] for b in cfg.eq_blocks] == [(0, 6), (6, 1)]
    assert cfg.bounds_span == (7, 12) and cfg.contact_colors == ()
    assert env.n_substeps == 20 and eng.options is opts
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 12))
    assert bool(torch.isfinite(st.sim.q).all()) and st.sim.lam.shape == (2, 19)
    assert float(st.sim.contact_forces[..., 2].max()) == 0.0  # the feet hang 0.25 m up
    with pytest.raises(ValueError, match="contact_model must be 'constraint'"):
        ANYmalGantryEnv(observe="state", device="cpu",
                        engine_options=dataclasses.replace(opts, constraint_solver="substep"))
