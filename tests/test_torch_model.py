"""The port's ANYmal model and rigid-body algorithms against jiminy_tpu.

- ``tree_from_arrays`` on ``jiminy_tpu.models.make_anymal()``'s tree
  equals the port's own ANYmal builder field for field (integers exact,
  floats atol 1e-7); so do the motor banks and the stand pose.
- FK, kinematics, the RNEA bias, RNEA, CRBA, ``point_jacobian`` and
  ``integrate`` match ``jiminy_tpu.core.algos`` (vmapped) on ANYmal at
  B = 8, atol 1e-5 (RNEA in float64 on both sides, see its test).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu.engine.contact import ContactParams as JContactParams
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine.contact import ContactParams, contact_params_from_arrays
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q

B = 8
ATOL = 1e-5
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)


@pytest.fixture(scope="module")
def robots():
    jrobot = j_make_anymal()
    jt = jrobot.tree
    d = {k: np.asarray(getattr(jt, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    md = {k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS}
    tree, motors = make_anymal(device="cpu")
    return jrobot, tree_from_arrays(d, device="cpu"), tree, motors_from_arrays(md, device="cpu"), motors


@pytest.mark.parametrize("field", STATIC_FIELDS + ARRAY_FIELDS)
def test_anymal_tree_matches_reference(robots, field):
    _, converted, built, _, _ = robots
    a, b = getattr(converted, field), getattr(built, field)
    if field in STATIC_FIELDS:
        assert a == b
    else:
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("field", MOTOR_FIELDS)
def test_anymal_motors_match_reference(robots, field):
    _, _, _, converted, built = robots
    a, b = getattr(converted, field), getattr(built, field)
    if isinstance(a, tuple):
        assert a == b
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)


def test_contact_params_match_reference():
    """The reference's default ContactParams, crossed as numpy scalars,
    equal the port's defaults (float32 values, as the reference holds)."""
    jp = JContactParams()
    names = ("stiffness", "damping", "friction", "transition_velocity", "transition_eps")
    converted = contact_params_from_arrays({k: np.asarray(getattr(jp, k)) for k in names})
    for k in names:
        assert getattr(converted, k) == float(np.float32(getattr(ContactParams(), k))), k


def test_stand_pose_matches_reference(robots):
    jrobot, _, tree, _, _ = robots
    np.testing.assert_array_equal(stand_q(tree), np.asarray(j_stand_q(jrobot.tree)))


def _states(tree, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = np.tile(stand_q(tree), (B, 1)).astype(np.float64)
    quat = rng.standard_normal((B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 0:3] += rng.uniform(-0.2, 0.2, (B, 3))
    q[:, 7:] += rng.uniform(-0.5, 0.5, (B, 12))
    v = rng.standard_normal((B, tree.nv))
    a = rng.standard_normal((B, tree.nv))
    return q.astype(dtype), v.astype(dtype), a.astype(dtype)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def kin(robots):
    """World poses and body velocities of both packages (one jit)."""
    jrobot, _, tree, _, _ = robots
    q, v, _ = _states(tree)
    jxw, jvel = jax.jit(jax.vmap(lambda q, v: jalgos.kinematics(jrobot.tree, q, v)))(q, v)
    xw, vel = algos.kinematics(tree, _t(q), _t(v))
    return {
        "pos": ([x.pos for x in xw], [x.pos for x in jxw]),
        "rot": ([x.rot for x in xw], [x.rot for x in jxw]),
        "vel": (vel, jvel),
    }


@pytest.mark.parametrize("quantity", ["pos", "rot", "vel"])
def test_kinematics_matches_reference(kin, quantity):
    port, ref = kin[quantity]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_forward_kinematics_matches_kinematics(robots):
    _, _, tree, _, _ = robots
    q, v, _ = _states(tree, seed=1)
    xw = algos.forward_kinematics(tree, _t(q))
    xw2, _ = algos.kinematics(tree, _t(q), _t(v))
    for a, b in zip(xw, xw2):
        torch.testing.assert_close(a.rot, b.rot, atol=0, rtol=0)
        torch.testing.assert_close(a.pos, b.pos, atol=0, rtol=0)


@pytest.mark.parametrize("accel", ["bias", "random"])
def test_rnea_matches_reference(robots, accel):
    """In float64 on both sides: the torques reach ~260 N·m (the base's
    weight), where float32 rounding alone is ~3e-5, above atol 1e-5."""
    jrobot, _, tree, _, _ = robots
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    q, v, a = _states(tree, seed=2, dtype=np.float64)
    if accel == "bias":
        a = np.zeros_like(a)
    ref = jax.jit(jax.vmap(lambda q, v, a: jalgos.rnea(jrobot.tree, q, v, a)))(q, v, a)
    assert ref.dtype == jnp.float64
    out = algos.rnea(tree.to(dtype=torch.float64), _t(q), _t(v), _t(a))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_crba_matches_reference(robots):
    jrobot, _, tree, _, _ = robots
    q, _, _ = _states(tree, seed=3)
    ref = jax.jit(jax.vmap(lambda q: jalgos.crba(jrobot.tree, q)))(q)
    np.testing.assert_allclose(algos.crba(tree, _t(q)).numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def jacobians(robots):
    jrobot, _, tree, _, _ = robots
    q, _, _ = _states(tree, seed=4)

    def jfn(q):
        xw = jalgos.forward_kinematics(jrobot.tree, q)
        out = []
        for k, body in enumerate(tree.contact_body):
            p = xw[body].apply(jrobot.tree.contact_pos[k])
            out.append(jalgos.point_jacobian(jrobot.tree, xw, body, p))
        return out

    ref = jax.jit(jax.vmap(jfn))(q)
    xw = algos.forward_kinematics(tree, _t(q))
    port = [
        algos.point_jacobian(tree, xw, body, xw[body].apply(tree.contact_pos[k]))
        for k, body in enumerate(tree.contact_body)
    ]
    return port, ref


@pytest.mark.parametrize("contact", range(4))
def test_point_jacobian_matches_reference(jacobians, contact):
    port, ref = jacobians
    np.testing.assert_allclose(
        port[contact].numpy(), np.asarray(ref[contact]), atol=ATOL, rtol=0
    )


def test_integrate_matches_reference(robots):
    jrobot, _, tree, _, _ = robots
    q, v, _ = _states(tree, seed=5)
    ref = jax.jit(jax.vmap(lambda q, v: jalgos.integrate(jrobot.tree, q, v, 5e-3)))(q, v)
    out = algos.integrate(tree, _t(q), _t(v), 5e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
