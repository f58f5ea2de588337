"""Per-body external forces and per-env friction on the port against
jiminy_tpu's.

- ``Engine.step(..., fext_user=, contact_params=)``: wrenches on both
  bodies of a box with an arm (four ground contacts, a bound row) on top
  of a base wrench, and each env's friction, one float64 substep on
  ``"substep"`` (which then runs the plain substep around the chain
  kernel), ``"kernel"`` and ``"inline"`` against the reference ``"xla"``
  engine within 1e-9 (one small reference program; ANYmal with its shanks
  pushed and per-env friction is held in
  tests/test_torch_kinematic_constraints.py's gantry case); a shared (nb,
  6) wrench and a float friction route the same way.
- tests/test_constraints.py's friction cone (a box pushed below μ·m·g
  holds, above it slides) and tests/test_domain_randomization.py's
  friction order (four boxes pushed alike, their slide ordered by their
  friction) on the port's engine.
- An env whose ``_external_forces`` returns a wrench: its step equals the
  engine's step with that ``fext_user``, and on ``"substep"`` it never
  launches the whole-substep kernels (on the state and sensor paths).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, JointType, TreeBuilder
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.contact import ContactParams
from jiminy_tpu_torch.envs import ANYmalEnv
from jiminy_tpu_torch.models.toys import make_free_box
from jiminy_tpu_torch.ops import substep_kernel

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 6
DT = 5e-3
F64 = dict(device="cpu", dtype=torch.float64)
SIM_FIELDS = ("q", "v", "lam", "solver_residual", "contact_forces", "a", "tau")


def _cart(tree_builder, joint_type):
    """A free box (1 kg, 0.2 m cube) on its four bottom corners with an arm
    on a revolute joint at its top (0.3 kg at 0.25 m): two bodies, four
    contacts, one bound row (the arm within ±1.2 rad)."""
    b = tree_builder()
    box = b.add_body("box", -1, joint_type.FREE, mass=1.0, inertia=np.diag([0.0067] * 3),
                     joint_name="root")
    arm = b.add_body("arm", box, joint_type.REVOLUTE, axis=(0, 1, 0), mass=0.3,
                     com=(0, 0, 0.25), inertia=np.diag([0.002, 0.002, 0.0005]),
                     placement=tree_builder.make_placement(pos=(0, 0, 0.1)),
                     q_limits=(-1.2, 1.2))
    b.add_frame("tip", arm, tree_builder.make_placement(pos=(0, 0, 0.4)))
    for x in (-0.1, 0.1):
        for y in (-0.1, 0.1):
            b.add_contact_point(f"c{x}{y}", box, (x, y, -0.1))
    return b


def _inputs(seed):
    """Boxes resting 1 mm into the ground (up to 2 mm above it), tilted a
    little, moving; a wrench on each body on top of a base wrench; each
    env's friction in [0.2, 1.2]."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 8))
    q[:, 2] = 0.0999 + rng.uniform(-0.001, 0.002, B)
    quat = np.concatenate([rng.uniform(-0.02, 0.02, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7] = rng.uniform(-1.3, 1.3, B)  # some arms past their bound
    v = 0.3 * rng.standard_normal((B, 7))
    lam = np.abs(0.05 * rng.standard_normal((B, 13)))
    u = rng.uniform(-1.0, 1.0, (B, 7))
    wrench = np.concatenate([0.5 * rng.standard_normal((B, 3)), 5.0 * rng.standard_normal((B, 3))], 1)
    fext = np.concatenate([0.5 * rng.standard_normal((B, 2, 3)),
                           8.0 * rng.standard_normal((B, 2, 3))], 2)
    mu = rng.uniform(0.2, 1.2, B)
    return q, v, lam, u, wrench, fext, mu


def test_fext_and_friction_match_reference_in_f64():
    """One substep with wrenches on both bodies, a base wrench and each
    env's friction: every backend against the reference ``"xla"`` engine,
    float64, within 1e-9; ``"substep"`` launches no whole-substep kernel."""
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    jtree = _cart(JTreeBuilder, JJointType).build()
    tree = _cart(TreeBuilder, JointType).build(**F64)
    q, v, lam, u, wrench, fext, mu = _inputs(0)
    jt64 = jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})
    jopts = JEngineOptions(dt=DT, contact_model="constraint", constraint_solver="xla",
                           pgs_iters=8, compute_solver_residual=True)
    jeng = JEngine(jt64, jopts)
    states = jax.vmap(lambda qq: jeng.reset(q=qq))(jnp.asarray(q)).replace(
        v=jnp.asarray(v), lam=jnp.asarray(lam))
    step = jax.jit(jax.vmap(lambda s, uu, w, f, m: jeng.step(
        s, uu, base_wrench=w, fext_user=f, contact_params=jopts.contacts.replace(friction=m))))
    ref = step(states, *(jnp.asarray(x) for x in (u, wrench, fext, mu)))
    ref = {k: np.asarray(getattr(ref, k)) for k in SIM_FIELDS}
    assert np.abs(ref["lam"][:, 1:]).max() > 0.1  # the contacts carry load
    assert np.abs(ref["lam"][:, 0]).max() > 1e-3  # and the bound
    launches = substep_kernel.substep_batched.launches
    for solver in ("substep", "kernel", "inline"):
        eng = Engine(tree, EngineOptions(dt=DT, contact_model="constraint", pgs_iters=8,
                                         compute_solver_residual=True, constraint_solver=solver),
                     device="cpu")
        st = eng.reset(torch.as_tensor(q), torch.as_tensor(v))
        st.lam = torch.as_tensor(lam)
        out = eng.step(st, torch.as_tensor(u), base_wrench=torch.as_tensor(wrench),
                       fext_user=torch.as_tensor(fext),
                       contact_params=ContactParams(friction=torch.as_tensor(mu)))
        for k in SIM_FIELDS:
            tol = 1e-9 / DT if k in ("a", "contact_forces") else 1e-9
            np.testing.assert_allclose(getattr(out, k).numpy(), ref[k], atol=tol, rtol=0,
                                       err_msg=f"{solver} {k}")
    assert substep_kernel.substep_batched.launches == launches


def test_shared_wrench_and_float_friction_route_to_the_plain_substep():
    """A (nb, 6) wrench for every env and a float friction: the same as
    the per-env forms broadcast, on ``"substep"`` as on ``"inline"``; a
    friction of the options' own value changes nothing."""
    tree = make_free_box(device="cpu", dtype=torch.float64)
    q = np.tile(tree.neutral_q(), (3, 1)).astype(np.float64)
    q[:, 2] = 0.0999
    f = torch.zeros(tree.nb, 6, dtype=torch.float64)
    f[0, 3] = 4.0
    outs = {}
    for solver in ("substep", "inline"):
        eng = Engine(tree, EngineOptions(dt=1e-3, contact_model="constraint", pgs_iters=24,
                                         constraint_solver=solver), device="cpu")
        st = eng.reset(torch.as_tensor(q))
        u = torch.zeros(3, 6, dtype=torch.float64)
        a = eng.step(st, u, n_substeps=5, fext_user=f, contact_params=ContactParams(friction=0.4))
        b = eng.step(st, u, n_substeps=5, fext_user=f.expand(3, -1, -1),
                     contact_params=ContactParams(friction=torch.full((3,), 0.4, **F64)))
        torch.testing.assert_close(a.q, b.q, atol=0, rtol=0)
        plain = eng.step(st, u, n_substeps=5)
        same = eng.step(st, u, n_substeps=5, contact_params=ContactParams())
        torch.testing.assert_close(plain.q, same.q, atol=1e-12, rtol=0)
        outs[solver] = a
        with pytest.raises(ValueError, match="fext_user of shape"):
            eng.step(st, u, fext_user=torch.zeros(3, 6, dtype=torch.float64))
        with pytest.raises(ValueError, match="friction of shape"):
            eng.step(st, u, contact_params=ContactParams(friction=torch.zeros(2, **F64)))
    torch.testing.assert_close(outs["substep"].q, outs["inline"].q, atol=1e-12, rtol=0)
    assert float(outs["substep"].v[0, 0]) > 0  # the push moves it


# ---- the reference's friction cases


PUSHES = (4.0, 20.0, 6.0, 6.0, 6.0, 6.0)  # N along +x on the box's centre, per env
FRICTIONS = (1.0, 1.0, 0.05, 0.3, 1.0, 2.0)


@pytest.fixture(scope="module")
def pushed_boxes():
    """tests/test_constraints.py's box resting on its corners (1 mm into
    the ground), one per env, pushed along +x at its centre for 500
    substeps of 1 ms with each env's force and friction (``PUSHES``,
    ``FRICTIONS``): the friction cone's two cases (μ = 1), then
    tests/test_domain_randomization.py's four frictions under 6 N."""
    tree = make_free_box(device="cpu")
    eng = Engine(tree, EngineOptions(dt=1e-3, contact_model="constraint", pgs_iters=24),
                 device="cpu")
    n = len(PUSHES)
    q0 = np.tile(tree.neutral_q(), (n, 1))
    q0[:, 2] = 0.0999
    fext = torch.zeros(n, tree.nb, 6)
    fext[:, 0, 3] = torch.tensor(PUSHES)
    return eng.step(eng.reset(torch.as_tensor(q0)), torch.zeros(n, 6), n_substeps=500,
                    fext_user=fext, contact_params=ContactParams(friction=torch.tensor(FRICTIONS)))


@pytest.mark.parametrize("env", [0, 1], ids=["holds", "slides"])
def test_friction_cone(pushed_boxes, env):
    """Below μ·m·g = 9.81 N static friction holds the box, above it the
    box slides."""
    x, vx = float(pushed_boxes.q[env, 0]), float(pushed_boxes.v[env, 0])
    if PUSHES[env] < 9.81:
        assert abs(x) < 2e-3 and abs(vx) < 1e-2
    else:
        assert x > 0.05


def test_batched_friction_orders_the_slide(pushed_boxes):
    """Four boxes pushed with 6 N, frictions 0.05, 0.3, 1.0, 2.0 (one per
    env): the near-frictionless one slides far, the stickiest stays, and
    the slide decreases with the friction."""
    x = pushed_boxes.q[2:, 0].numpy()
    assert x[0] > 0.2
    assert abs(x[3]) < 0.01
    assert x[0] > x[1] > x[2]


# ---- the env hook


class _ShankForceEnv(ANYmalEnv):
    """ANYmal with a lateral force of 30 N on each shank, every step."""

    def _external_forces(self, state):
        t = self.tree
        f = state.sim.q.new_zeros(state.sim.q.shape[0], t.nb, 6)
        for leg in ("LF", "RF", "LH", "RH"):
            f[:, t.frame_body[t.frame_index(f"{leg}_SHANK_frame")], 4] = 30.0
        return f


@pytest.mark.parametrize("observe", ["state", "sensors"])
def test_env_external_forces_hook(observe, monkeypatch):
    env = _ShankForceEnv(observe=observe, device="cpu")
    assert env.engine.backend == "substep"

    def refuse(*a, **k):
        raise AssertionError("the whole-substep kernels ran with external forces")

    monkeypatch.setattr(substep_kernel, "substep_batched_multi", refuse)
    monkeypatch.setattr(substep_kernel, "substep_batched", refuse)
    st = env.reset(torch.Generator().manual_seed(0), 3)
    act = torch.rand(3, 12, generator=torch.Generator().manual_seed(1)) * 2 - 1
    nxt = env.step_no_reset(st, act)
    u = env._action_to_command(act, st.sim)
    if observe == "state":
        want = env.engine.step(st.sim, u, n_substeps=env.n_substeps,
                               fext_user=env._external_forces(st))
        for k in ("q", "v", "lam"):
            torch.testing.assert_close(getattr(nxt.sim, k), getattr(want, k), atol=0, rtol=0)
    unpushed = env.engine.step(st.sim, u, n_substeps=env.n_substeps, contact_params=ContactParams())
    assert float((nxt.sim.v[:, 1] - unpushed.v[:, 1]).mean()) > 0  # pushed along +y
    assert nxt.sim.lam.shape == (3, env.engine.nc)
