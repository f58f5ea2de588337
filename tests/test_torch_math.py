"""The port's math layer (linalg, so3, spatial) against jiminy_tpu.math.

Inputs are made from a numpy seed and handed to both packages; the JAX
function runs vmapped on the CPU, the port's on batched CPU tensors.
Tolerance: atol 1e-5 (float32 reassociation); the spatial functions
that the API-coverage walk found unported (``Transform.identity``,
``from_quat_pos``, ``inverse``, ``apply_inv``,
``motion_child_to_parent``, ``force_parent_to_child``,
``SpatialInertia.from_params``, ``transform_matrix_motion``) 1e-6."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.math import linalg as jlinalg
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.math import spatial as jspatial
from jiminy_tpu_torch.math import linalg, so3, spatial

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5
B = 16


@functools.cache
def _ref(fn):
    """The JAX function, vmapped and jitted once (eager vmap of the
    unrolled Cholesky dispatches hundreds of ops)."""
    return jax.jit(jax.vmap(fn))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quat(rng, n=B):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vec(rng, n=B, d=3, scale=1.0):
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


def _rot(rng, n=B):
    return np.asarray(_ref(jso3.quat_to_matrix)(jnp.asarray(_quat(rng, n))))


def _spd(rng, n_dim):
    R = 0.3 * rng.standard_normal((B, n_dim, n_dim)).astype(np.float32)
    return (R @ R.transpose(0, 2, 1) + 2.0 * np.eye(n_dim, dtype=np.float32)).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0
    )


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- linalg ---------------------------------------------------------------
@pytest.mark.parametrize("n_dim", [6, 18])
def test_cholesky_matches_reference(n_dim):
    M = _spd(_rng(1), n_dim)
    _close(linalg.cholesky(_t(M)), _ref(jlinalg.cholesky)(jnp.asarray(M)))


@pytest.mark.parametrize("n_dim", [6, 18])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize(
    "fn", ["solve_lower", "solve_upper_t", "cho_solve", "solve_psd"]
)
def test_linalg_matches_reference(fn, rhs, n_dim):
    rng = _rng(1)
    M = _spd(rng, n_dim)
    b = _vec(rng, d=n_dim) if rhs == "vector" else _vec(rng, d=n_dim * 5).reshape(B, n_dim, 5)
    L = np.asarray(_ref(jlinalg.cholesky)(jnp.asarray(M)))
    a0 = M if fn == "solve_psd" else L
    ref = _ref(getattr(jlinalg, fn))(jnp.asarray(a0), jnp.asarray(b))
    _close(getattr(linalg, fn)(_t(a0), _t(b)), ref)


# ---- so3 --------------------------------------------------------------------
def _so3_cases():
    rng = _rng(2)
    q1, q2 = _quat(rng), _quat(rng)
    v = _vec(rng)
    w = _vec(rng, scale=0.7)
    w_small = _vec(rng, scale=1e-8)
    return {
        "quat_normalize": (so3.quat_normalize, jso3.quat_normalize, (3.0 * q1,)),
        "quat_mul": (so3.quat_mul, jso3.quat_mul, (q1, q2)),
        "quat_to_matrix": (so3.quat_to_matrix, jso3.quat_to_matrix, (q1,)),
        "quat_exp": (so3.quat_exp, jso3.quat_exp, (w,)),
        "quat_exp_small": (so3.quat_exp, jso3.quat_exp, (w_small,)),
        "quat_integrate": (
            lambda q, w: so3.quat_integrate(q, w, 5e-3),
            lambda q, w: jso3.quat_integrate(q, w, 5e-3),
            (q1, w),
        ),
        "hat": (so3.hat, jso3.hat, (v,)),
        "cross": (so3.cross, jnp.cross, (v, w)),
    }


@pytest.mark.parametrize("name", list(_so3_cases()))
def test_so3_matches_reference(name):
    port_fn, ref_fn, args = _so3_cases()[name]
    ref = jax.vmap(ref_fn)(*[jnp.asarray(a) for a in args])
    _close(port_fn(*[_t(a) for a in args]), ref)


# ---- spatial ----------------------------------------------------------------
def _spatial_cases():
    rng = _rng(3)
    R1, R2 = _rot(rng), _rot(rng)
    p1, p2 = _vec(rng), _vec(rng)
    m6, f6 = _vec(rng, d=6), _vec(rng, d=6)
    pt = _vec(rng)
    mass = np.abs(_vec(rng, d=1))[:, 0] + 0.5
    h = _vec(rng, scale=0.1)
    ic = np.abs(_vec(rng, d=3)) + 0.1
    ic = np.stack([np.diag(x) for x in ic]).astype(np.float32)

    def jx(R, p):
        return jspatial.Transform(rot=R, pos=p)

    def tx(R, p):
        return spatial.Transform(rot=R, pos=p)

    def ji(m, h, i):
        return jspatial.SpatialInertia(mass=m, h=h, inertia=i)

    def ti(m, h, i):
        return spatial.SpatialInertia(mass=m, h=h, inertia=i)

    return {
        "compose": (
            lambda R, p, S, q: (lambda x: (x.rot, x.pos))(tx(R, p).compose(tx(S, q))),
            lambda R, p, S, q: (lambda x: (x.rot, x.pos))(jx(R, p).compose(jx(S, q))),
            (R1, p1, R2, p2),
        ),
        "apply": (lambda R, p, x: tx(R, p).apply(x), lambda R, p, x: jx(R, p).apply(x), (R1, p1, pt)),
        "motion_parent_to_child": (
            lambda R, p, m: tx(R, p).motion_parent_to_child(m),
            lambda R, p, m: jx(R, p).motion_parent_to_child(m), (R1, p1, m6),
        ),
        "force_child_to_parent": (
            lambda R, p, f: tx(R, p).force_child_to_parent(f),
            lambda R, p, f: jx(R, p).force_child_to_parent(f), (R1, p1, f6),
        ),
        "motion_cross": (spatial.motion_cross, jspatial.motion_cross, (m6, f6)),
        "motion_cross_force": (spatial.motion_cross_force, jspatial.motion_cross_force, (m6, f6)),
        "inertia_mul_motion": (
            lambda m, h, i, x: ti(m, h, i).mul_motion(x),
            lambda m, h, i, x: ji(m, h, i).mul_motion(x),
            (mass, h, ic, m6),
        ),
        "inertia_add": (
            lambda m, h, i: (lambda s: (s.mass, s.h, s.inertia))(ti(m, h, i).add(ti(m, -h, i))),
            lambda m, h, i: (lambda s: (s.mass, s.h, s.inertia))(ji(m, h, i).add(ji(m, -h, i))),
            (mass, h, ic),
        ),
        "inertia_transform_by": (
            lambda m, h, i, R, p: (lambda s: (s.h, s.inertia))(ti(m, h, i).transform_by(tx(R, p))),
            lambda m, h, i, R, p: (lambda s: (s.h, s.inertia))(ji(m, h, i).transform_by(jx(R, p))),
            (mass, h, ic, R1, p1),
        ),
    }


@pytest.mark.parametrize("name", list(_spatial_cases()))
def test_spatial_matches_reference(name):
    port_fn, ref_fn, args = _spatial_cases()[name]
    ref = jax.vmap(ref_fn)(*[jnp.asarray(a) for a in args])
    out = port_fn(*[_t(a) for a in args])
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        _close(o, r)


def _spatial_extra_cases():
    rng = _rng(4)
    R, p, q = _rot(rng), _vec(rng), _quat(rng)
    m6, f6, pt = _vec(rng, d=6), _vec(rng, d=6), _vec(rng)
    mass = np.abs(_vec(rng, d=1))[:, 0] + 0.5
    com = _vec(rng, scale=0.1)
    ic = np.stack([np.diag(x) for x in np.abs(_vec(rng)) + 0.1]).astype(np.float32)

    def jx(R, p):
        return jspatial.Transform(rot=R, pos=p)

    def tx(R, p):
        return spatial.Transform(rot=R, pos=p)

    def pose(x):
        return x.rot, x.pos

    def inertia(s):
        return s.mass, s.h, s.inertia

    return {
        "from_quat_pos": (lambda q, p: pose(spatial.Transform.from_quat_pos(q, p)),
                          lambda q, p: pose(jspatial.Transform.from_quat_pos(q, p)), (q, p)),
        "inverse": (lambda R, p: pose(tx(R, p).inverse()),
                    lambda R, p: pose(jx(R, p).inverse()), (R, p)),
        "apply_inv": (lambda R, p, x: tx(R, p).apply_inv(x),
                      lambda R, p, x: jx(R, p).apply_inv(x), (R, p, pt)),
        "motion_child_to_parent": (lambda R, p, m: tx(R, p).motion_child_to_parent(m),
                                   lambda R, p, m: jx(R, p).motion_child_to_parent(m),
                                   (R, p, m6)),
        "force_parent_to_child": (lambda R, p, f: tx(R, p).force_parent_to_child(f),
                                  lambda R, p, f: jx(R, p).force_parent_to_child(f),
                                  (R, p, f6)),
        "inertia_from_params": (
            lambda m, c, i: inertia(spatial.SpatialInertia.from_params(m, c, i)),
            lambda m, c, i: inertia(jspatial.SpatialInertia.from_params(m, c, i)),
            (mass, com, ic)),
        "transform_matrix_motion": (lambda R, p: spatial.transform_matrix_motion(tx(R, p)),
                                    lambda R, p: jspatial.transform_matrix_motion(jx(R, p)),
                                    (R, p)),
    }


@pytest.mark.parametrize("name", list(_spatial_extra_cases()))
def test_spatial_extras_match_reference(name):
    port_fn, ref_fn, args = _spatial_extra_cases()[name]
    ref = jax.vmap(ref_fn)(*[jnp.asarray(a) for a in args])
    out = port_fn(*[_t(a) for a in args])
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        _close(o, r, atol=1e-6)


def test_transform_identity_matches_reference():
    ref, out = jspatial.Transform.identity(), spatial.Transform.identity()
    for o, r in ((out.rot, ref.rot), (out.pos, ref.pos)):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert spatial.Transform.identity(torch.float64).rot.dtype == torch.float64
