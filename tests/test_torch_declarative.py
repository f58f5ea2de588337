"""The port's declarative layer (quantities, compositions, blocks, the
declarative ANYmal MDP) against jiminy_tpu's.

- ``so3.quat_conj``, ``quat_identity`` and ``quat_to_rpy`` (pitch at and
  past ±90°, where the clamp acts); ``algos.com_position`` and ``energy``
  are held through the quantities ``com`` and ``energy``.
- Every ``QuantityContext`` quantity and every composition on one batch
  of seeded states (numpy, handed to both; the reference vmapped), on
  ``make_free_box`` (tests/test_gym_layer.py's fixture) and, in float64,
  on ANYmal (frames, 13 bodies), with random contact forces (some contacts
  unloaded, one env in flight: the ZMP's CoM fallback and the support
  margin's −inf), over a per-env Fourier ground for the height
  quantities: within 1e-9 in float64 (x64 on, a float64 copy of the
  reference's tree) and 1e-5 in float32.
- Each block on seeded inputs, the reference vmapped against the port's
  batch: ``MahonyFilter`` over 50 updates, ``PDControllerBlock``
  (absolute, integrated, target limits, effort clamp), ``MotorSafetyLimit``
  and ``DeformationEstimator`` (``quat_joint``, a nominal rotation):
  1e-5 in float32.
- The port's declarative ANYmal MDP against its hand-coded one over 30
  steps with terminations (the second half folds the legs under a
  termination height of 0.45 m), from one generator and the same
  actions: identical terminations, rewards within 1e-5
  (tests/test_compositions_dogfood.py, the reference's own).

Small trees and one program per tree and dtype: no reference ANYmal env
program is compiled here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine import ground as jg
from jiminy_tpu.engine.engine import SimState as JSimState
from jiminy_tpu.envs import blocks as jb
from jiminy_tpu.envs import compositions as jc
from jiminy_tpu.envs.quantities import QuantityContext as JQuantityContext
from jiminy_tpu.hardware import Motors as JMotors
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu.models.toys import make_free_box as j_make_free_box
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.engine.ground import FourierGround
from jiminy_tpu_torch.envs import ANYmalEnv, anymal_declarative_mdp
from jiminy_tpu_torch.envs import blocks as pb
from jiminy_tpu_torch.envs import compositions as pc
from jiminy_tpu_torch.envs.quantities import QuantityContext
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.math import so3

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 6
TOL = {"float32": 1e-5, "float64": 1e-9}
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=tol, rtol=tol)


def _jtree(name, jdt):
    tree = j_make_free_box() if name == "free_box" else j_make_anymal().tree
    return tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jdt)
                           for k in ARRAY_FIELDS})


def _port_tree(jtree, dtype):
    fields = {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    return tree_from_arrays(fields, device="cpu", dtype=dtype)


def _states(name, jtree, rng):
    """q, v, contact forces and actions (numpy float64): tilted bases
    spread over ±1.5 m (drift), heights 0.2–0.9 m; ANYmal's joints around
    its stand pose, env 1's first joint past its upper limit; env 0's
    contacts unloaded (in flight), a third of the others unloaded."""
    nq, nv, ncp = jtree.nq, jtree.nv, jtree.ncp
    q = np.zeros((B, nq))
    if name == "anymal":
        q[:] = np.asarray(j_stand_q(jtree), np.float64)
        q[:, 7:] += rng.uniform(-0.3, 0.3, (B, nq - 7))
        q[1, 7] = np.asarray(jtree.q_max)[7] + 0.05
    q[:, 0:2] = rng.uniform(-1.5, 1.5, (B, 2))
    q[:, 2] = rng.uniform(0.2, 0.9, B)
    quat = np.concatenate([rng.uniform(-0.6, 0.6, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.normal(0.0, 1.0, (B, nv))
    v[2, -1] = 30.0  # past ANYmal's 12 rad/s
    fc = rng.normal(0.0, 3.0, (B, ncp, 3))
    fc[..., 2] = np.abs(fc[..., 2]) + 1.0
    fc[rng.random((B, ncp)) < 0.33] = 0.0
    fc[0] = 0.0
    action = rng.uniform(-1.0, 1.0, (B, 5))
    return q, v, fc, action


def _fourier(rng):
    """B reference Fourier grounds (a vmapped pytree) and their
    coefficients (B, 64) in the port's layout."""
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), B)
    g = jax.vmap(lambda k: jg.sample_fourier_ground(k, n_terms=16, amplitude=0.2,
                                                    wavelength=1.0))(keys)
    return g, np.concatenate([np.asarray(x) for x in (g.amp, g.kx, g.ky, g.phase)], -1)


QUANTITIES = ("com", "com_velocity", "zmp", "capture_point", "odometry", "base_velocity_world",
              "base_angular_velocity", "base_height_above_ground", "base_tilt",
              "contact_points", "total_contact_force")


def _quantities(ctx, frame):
    out = {k: getattr(ctx, k) for k in QUANTITIES}
    out["base_pos"], out["base_quat"] = ctx.base_pose
    out["kinetic"], out["potential"] = ctx.energy
    if frame is not None:
        pose = ctx.frame_pose(frame)
        out["frame_rot"], out["frame_pos"] = pose.rot, pose.pos
    out["support_margin"] = ctx.support_polygon_margin()
    out["support_margin_at"] = ctx.support_polygon_margin(point=ctx.com[..., :2],
                                                          n_directions=8)
    return out


def _compositions(C, ctx, action, tree, np_mod):
    """Every reward and termination of the module ``C`` on ``ctx``."""
    track_com = C.tracking_reward(lambda c: c.com, np_mod.asarray([0.1, -0.2, 0.5]), 0.5)
    track_cp = C.tracking_reward(lambda c: c.zmp, lambda c: c.capture_point, 0.8)
    tilt = C.quantity_reward(lambda c: c.base_tilt)
    rewards = {
        "radial_basis": C.radial_basis(ctx.base_height_above_ground ** 2, 0.3),
        "track_com": track_com(ctx, action),
        "track_cp": track_cp(ctx, action),
        "tilt": tilt(ctx, action),
        "survival": C.survival_reward(0.7)(ctx, action),
        "action": C.action_penalty(0.3)(ctx, action),
        "additive": C.additive_mixture([(0.4, track_com), (0.5, tilt), (-0.2, C.action_penalty()),
                                        (1.0, C.survival_reward())])(ctx, action),
        "multiplicative": C.multiplicative_mixture([track_cp, C.survival_reward(0.5),
                                                    tilt])(ctx, action),
    }
    terminations = {
        "quantity": C.quantity_termination(lambda c: c.com[..., 2], low=0.3, high=0.8)(ctx),
        "height": C.base_height_termination(0.4)(ctx),
        "tilt": C.base_tilt_termination(0.8)(ctx),
        "drift": C.drift_termination(1.0)(ctx),
        "flying": C.flying_termination(0.5)(ctx),
        "safety": C.mechanical_safety_termination(tree, 0.01, 1.0)(ctx),
        "any": C.any_termination([C.base_tilt_termination(0.8), C.drift_termination(1.0)])(ctx),
    }
    return rewards, terminations


def _reference(name, dtype, seed):
    """The reference's quantities and compositions of the seeded states,
    and what the port needs to make its own."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    with jax.enable_x64(dtype == "float64"):
        jtree = _jtree(name, jdt)
        q, v, fc, action = _states(name, jtree, rng)
        ground, gc = _fourier(rng)
        ground = jax.tree.map(lambda x: jnp.asarray(x, jdt) if x.dtype.kind == "f" else x, ground)
        frame = None if name == "free_box" else len(jtree.frame_body) - 1

        def one(q, v, fc, action, ground):
            sim = JSimState(t=jnp.zeros((), jdt), q=q, v=v, contact_forces=fc)
            ctx = JQuantityContext(jtree, sim, ground=ground)
            return _quantities(ctx, frame), _compositions(jc, ctx, action, jtree, jnp)

        args = [jnp.asarray(x, jdt) for x in (q, v, fc, action)]
        out = jax.jit(jax.vmap(one))(*args, ground)
        out = jax.tree.map(np.asarray, out)
    return jtree, (q, v, fc, action, gc, frame), out


def _port_ctx(jtree, arrays, dtype):
    q, v, fc, action, gc, frame = arrays
    dt = DTYPES[dtype][1]
    tree = _port_tree(jtree, dt)
    t = lambda x: torch.as_tensor(x, dtype=dt)  # noqa: E731
    sim = SimState(t=t(np.zeros(B)), q=t(q), v=t(v), contact_forces=t(fc),
                   solver_residual=t(np.zeros(B)), lam=t(np.zeros((B, 1))), a=t(v), tau=t(v))
    ground = FourierGround.from_coef(t(gc))
    return tree, QuantityContext(tree, sim, ground=ground), t(action), frame


@pytest.mark.parametrize("name, dtype", [("free_box", "float32"), ("free_box", "float64"),
                                         ("anymal", "float64")])
def test_quantities_and_compositions_match_reference(name, dtype):
    jtree, arrays, (jq, (jr, jt)) = _reference(name, dtype, seed=3 + (name == "anymal"))
    tree, ctx, action, frame = _port_ctx(jtree, arrays, dtype)
    tol = TOL[dtype]
    got = _quantities(ctx, frame)
    assert set(got) == set(jq)
    for k, x in got.items():
        assert x.shape[0] == B, k
        _close(x, jq[k], tol)
    assert np.isinf(jq["support_margin"][0]) and not np.isinf(jq["support_margin"][1:]).all()
    # the ZMP falls back to the CoM in flight
    _close(got["zmp"][0], got["com"][0, :2], 0.0)
    rewards, terminations = _compositions(pc, ctx, action, tree, np)
    for k, x in rewards.items():
        assert x.shape == (B,), k
        _close(x, jr[k], tol)
    for k, x in terminations.items():
        assert x.shape == (B,) and x.dtype == torch.bool, k
        np.testing.assert_array_equal(x.numpy(), jt[k], err_msg=k)
    # the states reach both sides of every termination
    for k in ("height", "tilt", "drift"):
        assert 0 < jt[k].sum() < B, (k, jt[k])
    if name == "anymal":
        assert jt["safety"][1] and jt["safety"][2]
    # memoized: one value per step for every consumer
    assert ctx.com is ctx.com and ctx.zmp is ctx.zmp


def test_so3_additions():
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(64, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    # pitch at ±90° and a hair past it (the clamp), yaw and roll across ±π
    s = np.sqrt(0.5)
    quat[:4] = [[0, s, 0, s], [0, -s, 0, s], [0.0005, s, 0.0005, s], [0, s + 1e-7, 0, s]]
    quat = quat.astype(np.float32)
    want = np.asarray(jax.vmap(jso3.quat_to_rpy)(jnp.asarray(quat)))
    _close(so3.quat_to_rpy(torch.as_tensor(quat)), want, 1e-6)
    _close(so3.quat_conj(torch.as_tensor(quat)), jax.vmap(jso3.quat_conj)(jnp.asarray(quat)), 0.0)
    _close(so3.quat_identity((3,)), np.tile(np.asarray(jso3.quat_identity()), (3, 1)), 0.0)
    assert so3.quat_identity(dtype=torch.float64).shape == (4,)


def _imu_sequence(rng, n):
    gyro = rng.normal(0.0, 0.5, (n, B, 3)).astype(np.float32)
    accel = (np.array([0.0, 0.0, 9.81]) + rng.normal(0.0, 1.0, (n, B, 3))).astype(np.float32)
    accel[:, 0] = 0.0  # env 0: free fall (the norm's guard)
    return gyro, accel


def test_mahony_filter_matches_reference():
    rng = np.random.default_rng(1)
    gyro, accel = _imu_sequence(rng, 50)
    jf = jb.MahonyFilter(dt=0.02, kp=2.0, ki=0.3)
    pf = pb.MahonyFilter(dt=0.02, kp=2.0, ki=0.3)

    def run(gyro, accel):
        def body(st, x):
            st, quat = jf.apply(st, *x)
            return st, quat
        st = jax.vmap(jf.init)(jnp.arange(B))
        return jax.lax.scan(lambda s, x: jax.vmap(lambda s, g, a: body(s, (g, a)))(s, *x),
                            st, (gyro, accel))

    jst, jquats = jax.jit(run)(jnp.asarray(gyro), jnp.asarray(accel))
    st = pf.init(None, B)
    assert set(st) == {"quat", "bias"} and st["quat"].shape == (B, 4)
    for i in range(50):
        st, quat = pf.apply(st, torch.as_tensor(gyro[i]), torch.as_tensor(accel[i]))
        _close(quat, jquats[i], 1e-5)
    _close(st["bias"], jst.bias, 1e-5)
    _close(st["quat"], jst.quat, 1e-5)


def test_pd_safety_and_deformation_blocks_match_reference():
    rng = np.random.default_rng(2)
    nm = 3
    f32 = lambda *s: rng.uniform(-1.5, 1.5, s).astype(np.float32)  # noqa: E731
    limit = np.array([2.0, 5.0, 3.0], np.float32)
    jm = JMotors.create([0, 1, 2], q_idx=[0, 1, 2], effort_limit=limit)
    pm = Motors.create([0, 1, 2], q_idx=[0, 1, 2], effort_limit=limit, device="cpu")
    lims = (np.full(nm, -0.5, np.float32), np.full(nm, 0.6, np.float32))
    q0 = f32(B, 5)
    for kw in (dict(), dict(integrate_velocity=True), dict(target_limits=lims)):
        jblk = jb.PDControllerBlock(jm, kp=10.0, kd=1.0, dt=0.1, **kw)
        pblk = pb.PDControllerBlock(pm, kp=10.0, kd=1.0, dt=0.1, **kw)
        jst = jax.vmap(lambda q: jblk.init(None, q0=q))(jnp.asarray(q0))
        st = pblk.init(None, B, q0=torch.as_tensor(q0))
        for _ in range(3):
            a, qm, vm = f32(B, nm), f32(B, nm), f32(B, nm)
            jst, ju = jax.vmap(jblk.apply)(jst, a, qm, vm)
            st, u = pblk.apply(st, torch.as_tensor(a), torch.as_tensor(qm), torch.as_tensor(vm))
            _close(u, ju, 1e-5)
            _close(st["target"], jst.target, 1e-6)
        assert (np.abs(np.asarray(ju)) >= limit - 1e-6).any()  # the clamp acts
    assert pb.PDControllerBlock(pm, 1.0, 0.0, 0.1).init(None, B)["target"].shape == (B, nm)
    q_min, q_max = -np.ones(5, np.float32), np.ones(5, np.float32)
    jlim = jb.MotorSafetyLimit(jm, q_min, q_max, soft_margin=0.2, kd=1.5)
    plim = pb.MotorSafetyLimit(pm, q_min, q_max, soft_margin=0.2, kd=1.5)
    u, qm, vm = 4.0 * f32(B, nm), 1.1 * f32(B, nm), f32(B, nm)
    _, ju = jax.vmap(lambda u, q, v: jlim.apply((), u, q, v))(u, qm, vm)
    st, pu = plim.apply(plim.init(None, B), *(torch.as_tensor(x) for x in (u, qm, vm)))
    assert st == {}
    _close(pu, ju, 1e-6)
    quats = rng.normal(size=(3, B, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    nominal = np.array([0.0, 0.1, 0.0, 1.0], np.float32) / np.sqrt(1.01)
    for est_kw, jt in ((dict(), False), (dict(nominal_rel_quat=nominal), True)):
        jest, pest = jb.DeformationEstimator(**est_kw), pb.DeformationEstimator(**est_kw)
        _, jd = jax.vmap(lambda a, b, c: jest.apply((), a, b, c if jt else None))(*quats)
        _, pd = pest.apply(pest.init(None, B), *(torch.as_tensor(x) for x in quats[:2]),
                           quat_joint=torch.as_tensor(quats[2]) if jt else None)
        _close(pd, jd, 1e-5)


def _rollout(env, n=30):
    """n steps at B = 4 from one generator: uniform actions, then the legs
    folded (constant −1) for the second half so that the bases drop
    below the termination's height."""
    gen, act_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    st = env.reset(gen, 4)
    rew, term = [], []
    for i in range(n):
        a = 2.0 * torch.rand(4, 12, generator=act_gen) - 1.0 if i < n // 2 else -torch.ones(4, 12)
        st = env.step(st, a)
        rew.append(st.reward)
        term.append(st.terminated)
    return torch.stack(rew), torch.stack(term)


def test_declarative_mdp_matches_hand_coded():
    # a folded ANYmal settles ~0.33–0.43 m high within 15 steps: terminate
    # at 0.45 m so that folding ends episodes (the default 0.3 m needs a
    # fall over)
    r, t = anymal_declarative_mdp(min_height=0.45)
    kw = dict(observe="state", max_steps=60, min_height=0.45, device="cpu")
    rew_h, term_h = _rollout(ANYmalEnv(**kw))
    rew_d, term_d = _rollout(ANYmalEnv(reward_fn=r, termination_fn=t, **kw))
    assert term_h.sum() >= 2, "no fall in the rollout"
    torch.testing.assert_close(term_d, term_h, atol=0, rtol=0)
    torch.testing.assert_close(rew_d, rew_h, atol=1e-5, rtol=0)
