"""The port's spherical flexibility against jiminy_tpu's: so3.quat_log, the
flexible tree, the flexible Cassie and one and several substeps of it.

- ``so3.quat_log`` against the reference's in float64 within 1e-12 on
  each of its branches: random unit quaternions (half of them negated,
  w < 0), the exact identity, rotations of 1e-8 rad (the small-angle
  scale 2/w) and rotations within 1e-6 rad of π.
- ``TreeBuilder.insert_flexibility`` on a tree with frames, a world frame
  and contact sites on both sides of the inserted body, field for field
  against the reference's builder (every shifted index list included).
- ``make_cassie(flexibility=True)`` field for field: the tree
  (``tree_from_arrays`` of the reference's arrays is the port's own tree
  to the bit), the pushrods, the stand pose, the motors, the sensor suite
  (3 IMUs: pelvis, L hip, R hip; 10 encoders), with and without the
  self-collision pairs (their bodies resolved on the flexible tree).
- ``SubstepSpec`` against the reference's ``Engine._substep_spec`` on the
  flexible tree (nb 17, nv 26, nq 29, nc 28).
- One substep and five chained substeps of the port's plain version
  (every backend; the port's several substeps in one ``step`` call, K2's
  plain version on ``"substep"``) against the reference ``"xla"`` engine
  in float64, on a float64 copy of the reference's model (ROADMAP C.3),
  within 1e-9, from perturbed stand poses whose hip quaternions are
  deflected 0.05–0.5 rad (some negated, w < 0), so that the springs'
  −k·log(quat) is large.
- The float32 plain substep held env by env against the float64
  reference (ROADMAP C.2): within the float32 rounding of one solve
  through the mass matrix, κ(M)·2⁻²⁴ (κ ≈ 5e4, checked).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.engine.collision import CollisionPairSet as JCollisionPairSet
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.models.biped import cassie_self_collision_pairs as j_pairs
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine.collision import CollisionPairSet
from jiminy_tpu_torch.engine.constraints import distance_constraint_from_arrays
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.models import make_cassie
from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
DT = 2e-3
KP, KD = 150.0, 6.0
N_CHAIN = 5
SENSOR_KW = dict(sensor_period=2e-3, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
CONSTRAINT_FIELDS = ("frame1", "frame2", "distance", "baumgarte_freq")


def _tree_arrays(jtree) -> dict:
    return {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}


def _assert_same_tree(got, want):
    for k in STATIC_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        torch.testing.assert_close(getattr(got, k), getattr(want, k), atol=0, rtol=0, msg=k)


def _axis_angle_quats(rng, n, angle):
    """Unit quaternions (n, 4) xyzw of random axes turned by ``angle``."""
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = 0.5 * np.asarray(angle, np.float64)[..., None]
    return np.concatenate([axis * np.sin(half), np.cos(half)], axis=1)


def _log_inputs(branch: str) -> np.ndarray:
    rng = np.random.default_rng(["random", "identity", "small", "near_pi"].index(branch))
    n = 64
    if branch == "random":
        q = rng.standard_normal((n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q[:, 3] = np.abs(q[:, 3])
        q[: n // 2] *= -1.0  # w < 0: the sign flip
        return q
    if branch == "identity":
        return np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    if branch == "small":
        q = _axis_angle_quats(rng, n, np.full(n, 1e-8))
        q[::2] *= -1.0
        return q
    return _axis_angle_quats(rng, n, np.pi - rng.uniform(0.0, 1e-6, n))


@pytest.mark.parametrize("branch", ["random", "identity", "small", "near_pi"])
def test_quat_log_matches_reference(branch):
    q = _log_inputs(branch)
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    want = np.asarray(jax.vmap(jso3.quat_log)(jnp.asarray(q, jnp.float64)))
    got = so3.quat_log(torch.as_tensor(q, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    small = np.sum(q[:, :3] ** 2, axis=1) < 1e-14
    assert small.all() if branch in ("identity", "small") else not small.any()
    # exp(log(q)) is q's rotation
    back = so3.quat_to_matrix(so3.quat_exp(torch.as_tensor(got)))
    torch.testing.assert_close(back, so3.quat_to_matrix(torch.as_tensor(q)), atol=1e-9, rtol=0)


def _flex_builders():
    """The same small tree from both packages' builders: a free base, a
    chain of three revolute joints with frames, contact points and a
    sphere on bodies before and after the joint the flexibility goes
    above, and a world frame, then the flexibility inserted above the
    middle joint."""
    trees = []
    for TB, JT in ((JTreeBuilder, JJointType), (TreeBuilder, JointType)):
        b = TB()
        place = (lambda p, TB=TB: TB.make_placement(pos=p))
        base = b.add_body("base", -1, JT.FREE, mass=5.0, inertia=np.diag([0.1, 0.2, 0.3]))
        b.add_frame("base_imu", base, place((0.1, 0.0, 0.05)))
        b.add_frame("world_anchor", -1, place((1.0, 0.0, 0.0)))
        prev = base
        for k in range(3):
            prev = b.add_body(f"link{k}", prev, JT.REVOLUTE, placement=place((0.0, 0.1, -0.2)),
                              axis=(0, 1, 0), mass=1.0, com=(0, 0, -0.1),
                              inertia=np.diag([0.01, 0.01, 0.002]), joint_name=f"j{k}",
                              q_limits=(-1.0, 1.0), stiffness=10.0 * k, damping=0.5)
            b.add_frame(f"link{k}_tip", prev, place((0.0, 0.0, -0.2)))
            b.add_contact_point(f"link{k}_pt", prev, (0.02, 0.0, -0.2))
        b.add_contact_sphere("link2_ball", prev, (0.0, 0.0, -0.25), radius=0.03)
        assert b.insert_flexibility("j1", stiffness=600.0, damping=5.0, inertia=1e-3) == 2
        b.add_frame("after", 3, place((0.0, 0.0, 0.1)))  # the original body, shifted
        trees.append(b.build() if TB is JTreeBuilder else b.build(device="cpu"))
    return trees


def test_insert_flexibility_matches_reference():
    jtree, tree = _flex_builders()
    _assert_same_tree(tree, tree_from_arrays(_tree_arrays(jtree), device="cpu"))
    assert tree.joint_type[2] == JointType.SPHERICAL and tree.body_name[2] == "link1_flex"
    assert tree.parent == (-1, 0, 1, 2, 3) and tree.frame_body == (0, -1, 1, 3, 4, 3)
    assert tree.contact_body == (1, 3, 4, 4) and (tree.nq, tree.nv) == (14, 12)
    np.testing.assert_array_equal(tree.neutral_q(), np.asarray(jtree.neutral_q()))
    assert tree.sprung_spherical == ([7], [8]) and tree.sprung_joints == ([10, 11], [12, 13])


@pytest.fixture(scope="module")
def ref():
    """The reference's flexible robot, its pushrods and stand pose, and the
    port's model made from its arrays."""
    robot, cons, stand = j_make_cassie(flexibility=True, **SENSOR_KW)
    tree = tree_from_arrays(_tree_arrays(robot.tree), device="cpu")
    motors = motors_from_arrays(
        {k: np.asarray(getattr(robot.motors, k)) for k in MOTOR_FIELDS}, device="cpu")
    pcons = tuple(distance_constraint_from_arrays(
        {k: np.asarray(getattr(c, k)) for k in CONSTRAINT_FIELDS}) for c in cons)
    return robot, cons, np.asarray(stand), tree, motors, pcons


@pytest.mark.parametrize("self_collision", [False, True], ids=["rigid-legs", "self-collision"])
def test_make_cassie_flexible_matches_reference(ref, self_collision):
    robot, cons, stand, tree_arrays, motors_arrays, pcons = ref
    tree, motors, sensors, constraints, q = make_cassie(flexibility=True, device="cpu",
                                                        **SENSOR_KW)
    _assert_same_tree(tree, tree_arrays)
    assert (tree.nb, tree.nq, tree.nv, tree.ncp) == (17, 29, 26, 4)
    assert [t.name for t in tree.joint_type] == (
        ["FREE"] + (["SPHERICAL"] + ["REVOLUTE"] * 7) * 2)
    assert constraints == pcons and len(pcons) == 2
    assert q.dtype == np.float32
    np.testing.assert_array_equal(q, stand)
    for k in MOTOR_FIELDS:
        got, want = getattr(motors, k), getattr(motors_arrays, k)
        if isinstance(got, torch.Tensor):
            torch.testing.assert_close(got, want, atol=0, rtol=0)
        else:
            assert tuple(got) == tuple(want), k
    rs = robot.sensors
    assert [g.type for g in sensors.groups] == [g.type for g in rs.groups] == ["imu", "encoder"]
    assert [len(g.target) for g in sensors.groups] == [3, 10]
    assert [tree.frame_name[f] for f in sensors.groups[0].target] == [
        "pelvis_frame", "L_hip_imu", "R_hip_imu"]
    for g, h in zip(sensors.groups, rs.groups):
        assert tuple(g.target) == tuple(h.target) and g.buf_len == h.buf_len
        np.testing.assert_array_equal(np.asarray(g.delay), np.asarray(h.delay))
        np.testing.assert_array_equal(g.noise_std.numpy(), np.asarray(h.noise_std))
    assert sensors.n_buf == rs.flatten_buffers(rs.init_buffers()).shape[0]
    if self_collision:  # the pairs' bodies, resolved on the flexible tree
        got = CollisionPairSet(tree, cassie_self_collision_pairs(), 1.0).gens
        want = JCollisionPairSet(robot.tree, j_pairs(), 1.0).gens
        assert [(k, g["ba"], g["bb"]) for k, g in got] == [(k, g["ba"], g["bb"]) for k, g in want]


def _port_engine(ref, solver, dtype):
    _, _, _, tree, motors, pcons = ref
    opts = EngineOptions(dt=DT, pgs_iters=8, compute_solver_residual=True,
                         constraint_solver=solver, contact_model="constraint")
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(KP, KD), constraints=pcons, device="cpu")


SPEC_FIELDS = [
    "bounded_joints", "color_order", "cfg.nc", "cfg.n", "cfg.dt", "cfg.eq_blocks",
    "cfg.bounds_span", "cfg.contact_colors", "cfg.iters", "friction",
    "torque.mode", "torque.q_idx", "torque.v_idx", "torque.kp", "torque.kd",
]


def _get(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def test_spec_matches_reference(ref):
    robot, cons = ref[0], ref[1]
    jeng = JEngine(robot.tree, JEngineOptions(contact_model="constraint",
                                              constraint_solver="pallas_substep", dt=DT,
                                              pgs_iters=8),
                   motors=robot.motors, controller=JPDController(KP, KD), constraints=cons)
    jspec, eng = jeng._substep_spec, _port_engine(ref, "substep", torch.float32)
    spec = eng.substep_spec
    for field in SPEC_FIELDS:
        want, got = _get(jspec, field), _get(spec, field)
        if isinstance(want, (list, tuple)):
            assert [tuple(x) if isinstance(x, (list, tuple)) else x for x in got] == \
                [tuple(x) if isinstance(x, (list, tuple)) else x for x in want], field
        else:
            assert got == want, field
    assert eng.backend == "substep" and spec.nc == 28 and spec.springs
    np.testing.assert_array_equal(spec.tree.stiffness.numpy(), np.asarray(jspec.stiffness))
    si, sf = spec.packed("cpu")  # the joint types the kernels branch on
    jt = si[10 + 17:10 + 2 * 17].tolist()
    assert jt == [0, 3] + [1] * 7 + [3] + [1] * 7
    spec.check_kernel_caps("test")  # the large frame takes it: nq − nv = 3 ≤ 4


def _inputs(ref, seed):
    """Stand poses with the motor joints ±0.05 rad, the shin springs ±0.05
    rad, each hip quaternion turned 0.05–0.5 rad about a random axis (a
    third of them negated, w < 0), the base 1 cm low to 0.5 cm high,
    v ~ 0.3·N(0, 1), λ0 ≥ 0, PD targets ±0.1 rad around the joints, a
    root wrench of ~5 N·m and ~20 N."""
    stand, tree, motors = ref[2], ref[3], ref[4]
    rng = np.random.default_rng(seed)
    q = np.tile(stand, (B, 1)).astype(np.float64)
    qi = list(motors.q_idx)
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, 10))
    springs = [tree.q_off[tree.joint_index(n)] for n in ("L_shin_spring", "R_shin_spring")]
    q[:, springs] += rng.uniform(-0.05, 0.05, (B, 2))
    for qo in tree.sprung_spherical[1]:
        quat = _axis_angle_quats(rng, B, rng.uniform(0.05, 0.5, B))
        quat[rng.uniform(size=B) < 1 / 3] *= -1.0
        q[:, qo:qo + 4] = quat
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    v = 0.3 * rng.standard_normal((B, tree.nv))
    lam = np.abs(0.05 * rng.standard_normal((B, 28)))
    u = q[:, qi] + rng.uniform(-0.1, 0.1, (B, 10))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    return q, v, lam, u, wrench


def _jax_steps(ref, arrays):
    """The reference ``"xla"`` engine's substep in float64 on a float64
    copy of its model (x64 on), vmapped: after one and after N_CHAIN
    chained calls."""
    robot, cons = ref[0], ref[1]
    jtree, jmotors = robot.tree, robot.motors
    jtree = jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                             for k in ARRAY_FIELDS})
    jmotors = jmotors.replace(**{k: jnp.asarray(np.asarray(getattr(jmotors, k)), jnp.float64)
                                 for k in MOTOR_FIELDS[3:]})
    eng = JEngine(jtree, JEngineOptions(contact_model="constraint", constraint_solver="xla",
                                        dt=DT, pgs_iters=8, compute_solver_residual=True),
                  motors=jmotors, controller=JPDController(KP, KD), constraints=cons)
    q, v, lam, u, wrench = (jnp.asarray(a, jnp.float64) for a in arrays)
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    step = jax.jit(jax.vmap(lambda s, uu, w: eng.step(s, uu, base_wrench=w)))
    out = []
    for _ in range(N_CHAIN):
        states = step(states, u, wrench)
        out.append({k: np.asarray(getattr(states, k)) for k in SIM_FIELDS})
    return out[0], out[-1]


def _port_step(eng, arrays, dtype, n_substeps=1):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    state = eng.reset(q, v)
    state.lam = lam
    out = eng.step(state, u, n_substeps=n_substeps, base_wrench=wrench)
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


@pytest.fixture(scope="module")
def steps(ref):
    """Inputs, and the reference's substeps from them in float64 on its
    model in float64 (x64 on for that call alone)."""
    arrays = _inputs(ref, seed=0)
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_steps(ref, arrays)
    finally:
        jax.config.update("jax_enable_x64", False)
    return arrays, want64


ATOL = {"t": 1e-12, "tau": 1e-9, "q": 1e-9, "v": 1e-9, "lam": 1e-9,
        "solver_residual": 1e-9, "contact_forces": 1e-9 / DT, "a": 1e-9 / DT}


@pytest.mark.parametrize("n_substeps", [1, N_CHAIN])
def test_substep_matches_reference_in_f64(ref, steps, n_substeps):
    arrays, (one, chained) = steps
    want = one if n_substeps == 1 else chained
    assert want["q"].dtype == np.float64
    tree = ref[3]
    qo, vo = tree.sprung_spherical[1], tree.sprung_spherical[0]
    log = so3.quat_log(torch.as_tensor(arrays[0][:, qo[0]:qo[0] + 4]))
    assert float(log.norm(dim=1).min()) > 0.05  # the springs pull hard: 600 N·m/rad
    spring = 600.0 * log.norm(dim=1)
    assert float(spring.max()) > 100.0 and np.abs(one["tau"][:, vo[0]:vo[0] + 3]).max() > 100.0
    for solver in ("substep", "kernel", "inline"):
        got = _port_step(_port_engine(ref, solver, torch.float64), arrays, torch.float64,
                         n_substeps)
        for k, tol in ATOL.items():
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                       err_msg=f"{solver} {k} n_substeps={n_substeps}")


def test_substep_f32_env_by_env_against_f64(ref, steps):
    """The port's float32 substep, each env held against the float64
    reference (its model in float64): within κ(M)·2⁻²⁴ of it in v and λ,
    κ(M) the mass matrix's condition number at the stand pose (checked
    here, of order 5e4: the flexibility bodies, massless with 1e-3 kg·m²,
    under a 10 kg pelvis), that is the float32 rounding of one solve
    through M; q moves by dt·v, so within dt times that; the torque within
    1e-4 of its size. No float32 version does better env by env (ROADMAP
    C.2), and a fault of a mechanism (the springs, the SPHERICAL columns)
    moves every env by more."""
    from jiminy_tpu_torch.core import algos

    arrays, (want64, _) = steps
    M = algos.crba(ref[3].to(dtype=torch.float64),
                   torch.as_tensor(ref[2], dtype=torch.float64)[None])[0]
    eig = torch.linalg.eigvalsh(M)
    kappa = float(eig.max() / eig.min())
    assert 3e4 < kappa < 1e5
    tol = kappa * 2.0 ** -24
    got = _port_step(_port_engine(ref, "substep", torch.float32), arrays, torch.float32)
    for k, bound in (("q", DT * tol), ("v", tol), ("lam", tol)):
        d = np.abs(got[k] - want64[k]).max(axis=1)
        assert np.all(d <= bound), (k, d, bound)
    scale = max(1.0, float(np.abs(want64["tau"]).max()))
    np.testing.assert_allclose(got["tau"], want64["tau"], atol=1e-4 * scale, rtol=0)


def test_flexibility_with_self_collision_steps():
    """The flexible model with the legs' self-collision pairs: nc 37 (the
    9 pair rows after the 12 ground rows), within the whole-substep
    kernels' caps, steps on the plain version with finite states and the
    pushrods closed."""
    from jiminy_tpu_torch.envs import CassieEnv

    env = CassieEnv(sim_dt=DT, target_speed=0.4, flexibility=True, self_collision=True,
                    observe="state", device="cpu")
    spec = env.engine.substep_spec
    assert env.engine.backend == "substep" and (spec.nc, spec.n_pc, spec.tree.nv) == (37, 3, 26)
    st = env.reset(torch.Generator().manual_seed(0), 2)
    for _ in range(2):
        st = env.step(st, torch.zeros(2, 10))
    assert bool(torch.isfinite(st.sim.q).all()) and bool(torch.isfinite(st.obs).all())
    assert not bool(st.done.any())
