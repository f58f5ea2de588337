"""The port's Cassie biped against jiminy_tpu's: model, substep, env.

- ``make_cassie`` field for field against the reference's robot: the
  tree (``tree_from_arrays`` of the reference's arrays is the port's own
  tree to the bit), the pushrod constraints, the stand pose, the motors
  and the sensor suite.
- ``SubstepSpec`` against the reference's ``Engine._substep_spec``: the
  distance rows first (one equality block each), the bounds span at 2 (14
  rows), the contact colors at 2 + 14, the constraints' tuples, the stiffness.
- One substep of the port's plain version (every backend) against the
  reference ``"xla"`` engine from the same states (perturbed stand poses:
  loops open by millimetres, springs deflected, feet in and above the
  ground, a root wrench), float64 on both sides with the reference's
  model in float64: within 1e-9. With its float32 model constants (its
  default in x64) the reference sits further off in v: its CRBA sums the
  composite masses of float32 constants in float32 (ROADMAP C.3), which
  Cassie's mass matrix (its condition of order 1e4, checked here: a 0.3
  kg foot at the end of a 15-body chain) amplifies beyond ANYmal's.
- Float32: one substep is not well posed at 1e-4 on Cassie (the
  reference's own float32 substep is further than that from float64 in
  v), so the
  port's float32 substep is held env by env against the float64
  reference as ROADMAP C.2 requires: no farther than 2 × the reference's
  float32 + 1e-4.
- The reference's ``TestCassie`` properties on the port (1 ms substeps,
  its default): the loops hold within 1e-3 over 15 env steps and stand;
  a knee command moves the tarsus through the loop by > 0.01 rad.
- The sensor stage's caps hold for Cassie's suite at 2 ms and 1 ms.
- ``flexibility`` (A.14) builds the reference's flexible tree (held in
  tests/test_torch_flex.py and tests/test_torch_flex_env.py);
  ``self_collision`` builds (A.13, held in tests/test_torch_pair_substep.py
  and tests/test_torch_cassie_selfcol_env.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine.constraints import distance_constraint_from_arrays
from jiminy_tpu_torch.envs import CassieEnv
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models import make_cassie
from jiminy_tpu_torch.ops.substep_kernel import (
    MAX_SENS_BUF,
    MAX_SENS_EPS,
    MAX_SENS_GROUPS,
    SensorKernelSpec,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
DT = 2e-3
KP, KD = 150.0, 6.0
SENSOR_KW = dict(sensor_period=2e-3, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
CONSTRAINT_FIELDS = ("frame1", "frame2", "distance", "baumgarte_freq")


@pytest.fixture(scope="module")
def ref():
    """The reference robot, its pushrods and stand pose, and the port's
    model made from its arrays."""
    robot, cons, stand = j_make_cassie(**SENSOR_KW)
    tree = tree_from_arrays(
        {k: np.asarray(getattr(robot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    motors = motors_from_arrays(
        {k: np.asarray(getattr(robot.motors, k)) for k in MOTOR_FIELDS}, device="cpu")
    pcons = tuple(distance_constraint_from_arrays(
        {k: np.asarray(getattr(c, k)) for k in CONSTRAINT_FIELDS}) for c in cons)
    return robot, cons, np.asarray(stand), tree, motors, pcons


def test_make_cassie_matches_reference(ref):
    robot, cons, stand, tree_arrays, motors_arrays, pcons = ref
    tree, motors, sensors, constraints, q = make_cassie(device="cpu", **SENSOR_KW)
    for k in STATIC_FIELDS:
        assert getattr(tree, k) == getattr(tree_arrays, k), k
    for k in ARRAY_FIELDS:
        torch.testing.assert_close(getattr(tree, k), getattr(tree_arrays, k), atol=0, rtol=0)
    assert (tree.nb, tree.nv, tree.nq, tree.ncp) == (15, 20, 21, 4)
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
    for g, h in zip(sensors.groups, rs.groups):
        assert tuple(g.target) == tuple(h.target) and g.buf_len == h.buf_len
        np.testing.assert_array_equal(np.asarray(g.delay), np.asarray(h.delay))
        np.testing.assert_array_equal(g.noise_std.numpy(), np.asarray(h.noise_std))
    # the flexible model (A.14) builds, the reference's to the bit
    # (field for field with its sensors and motors in tests/test_torch_flex.py)
    jflex = j_make_cassie(flexibility=True, **SENSOR_KW)[0].tree
    flex = make_cassie(flexibility=True, device="cpu", **SENSOR_KW)[0]
    want = tree_from_arrays(
        {k: np.asarray(getattr(jflex, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    assert (flex.nb, flex.nv, flex.nq) == (17, 26, 29)
    for k in STATIC_FIELDS:
        assert getattr(flex, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        torch.testing.assert_close(getattr(flex, k), getattr(want, k), atol=0, rtol=0)


def _port_engine(ref, solver, dtype):
    _, _, _, tree, motors, pcons = ref
    opts = EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8,
                         compute_solver_residual=True,
                         constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(KP, KD), constraints=pcons, device="cpu")


SPEC_FIELDS = [
    "bounded_joints", "color_order", "cfg.nc", "cfg.n", "cfg.dt", "cfg.eq_blocks",
    "cfg.bounds_span", "cfg.contact_colors", "cfg.iters", "dist_constraints", "friction",
    "torque.mode", "torque.q_idx", "torque.v_idx", "torque.kp", "torque.kd",
    "torque.effort_limit", "torque.friction_dry",
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
    jspec, spec = jeng._substep_spec, _port_engine(ref, "substep", torch.float32).substep_spec
    for field in SPEC_FIELDS:
        want, got = _get(jspec, field), _get(spec, field)
        if field == "cfg.eq_blocks":
            assert [tuple(b) for b in got] == [tuple(b) for b in want] == [
                ("equality", 0, 1), ("equality", 1, 1)]
        elif field == "dist_constraints":
            for g, w in zip(got, want, strict=True):
                assert g[0] == w[0] and g[2] == w[2]
                np.testing.assert_allclose(g[1] + g[3] + [g[4], g[5]],
                                           w[1] + w[3] + [w[4], w[5]], rtol=1e-7, atol=0)
        elif isinstance(want, (list, tuple)) and want and isinstance(want[0], float):
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=0, err_msg=field)
        else:
            assert (tuple(got) == tuple(want) if isinstance(want, (list, tuple)) else got == want), field
    assert spec.cfg.bounds_span == (2, 14) and spec.contact_off == 16 and spec.nc == 28
    np.testing.assert_array_equal(spec.tree.stiffness.numpy(), np.asarray(jspec.stiffness))
    assert spec.springs and spec.n_dist == 2
    # the packed header and the constraints' packed floats (csrc/substep.cuh)
    si, sf = spec.packed("cpu")
    assert si[9].item() == 2 and sf[11].item() == 1.0
    assert sf.numel() == 16 + 28 * 15 + 3 * 20 + 3 * 4 + 2 * 14 + 8 * 10 + 8 * 2
    alpha = np.float32(np.float32(2 * np.pi) * np.float32(20.0) * np.float32(DT))
    np.testing.assert_allclose(sf[-20 - 1].item(), float(alpha / np.float32(DT)), rtol=1e-7)


def _inputs(ref, seed):
    """Stand poses with the motor joints ±0.05 rad (the loops open by
    millimetres), the springs ±0.05 rad, the base 1 cm low to 0.5 cm high,
    v ~ 0.3·N(0, 1), λ0 ≥ 0, PD targets ±0.1 rad around the joints, a
    root wrench of ~5 N·m and ~20 N."""
    robot, _, stand, tree, motors, _ = ref
    rng = np.random.default_rng(seed)
    q = np.tile(stand, (B, 1)).astype(np.float64)
    qi = list(motors.q_idx)
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, 10))
    springs = [tree.q_off[tree.joint_index(n)] for n in ("L_shin_spring", "R_shin_spring")]
    q[:, springs] += rng.uniform(-0.05, 0.05, (B, 2))
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    v = 0.3 * rng.standard_normal((B, tree.nv))
    lam = np.abs(0.05 * rng.standard_normal((B, 28)))
    u = q[:, qi] + rng.uniform(-0.1, 0.1, (B, 10))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    return q, v, lam, u, wrench


def _jax_step(ref, arrays, dtype, f64_model=False):
    """The reference ``"xla"`` engine's one substep, vmapped; with
    ``f64_model`` on a float64 copy of its model (x64 on)."""
    robot, cons = ref[0], ref[1]
    jtree, jmotors = robot.tree, robot.motors
    if f64_model:
        jtree = jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                                 for k in ARRAY_FIELDS})
        jmotors = jmotors.replace(**{k: jnp.asarray(np.asarray(getattr(jmotors, k)), jnp.float64)
                                     for k in MOTOR_FIELDS[3:]})
    eng = JEngine(jtree, JEngineOptions(contact_model="constraint", constraint_solver="xla",
                                        dt=DT, pgs_iters=8, compute_solver_residual=True),
                  motors=jmotors, controller=JPDController(KP, KD), constraints=cons)
    q, v, lam, u, wrench = (jnp.asarray(a, dtype) for a in arrays)
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    out = jax.jit(jax.vmap(lambda s, uu, w: eng.step(s, uu, base_wrench=w)))(states, u, wrench)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _port_step(eng, arrays, dtype):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    state = eng.reset(q, v)
    state.lam = lam
    out = eng.step(state, u, base_wrench=wrench)
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


@pytest.fixture(scope="module")
def steps(ref):
    """Inputs, and the reference's substep from them in float32 and in
    float64 on its model in float64 (x64 on for that call alone)."""
    arrays = _inputs(ref, seed=0)
    want32 = _jax_step(ref, arrays, jnp.float32)
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(ref, arrays, jnp.float64, f64_model=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    return arrays, want32, want64


def test_substep_matches_reference_in_f64(ref, steps):
    arrays, _, want = steps
    assert want["q"].dtype == np.float64
    assert np.abs(want["lam"][:, :2]).max() > 0.1  # the pushrods carry load
    atol = {"t": 1e-12, "tau": 1e-9, "q": 1e-9, "v": 1e-9, "lam": 1e-9,
            "solver_residual": 1e-9, "contact_forces": 1e-9 / DT, "a": 1e-9 / DT}
    for solver in ("substep", "kernel", "inline"):
        got = _port_step(_port_engine(ref, solver, torch.float64), arrays, torch.float64)
        for k, tol in atol.items():
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=f"{solver} {k}")


def test_substep_f32_env_by_env_against_f64(ref, steps):
    """Float32 on both sides, each env held against the float64 reference
    (its model in float64): the port's float32 no farther than 2 × the
    reference's float32 + 1e-4 (q, v, λ), and the torque within 1e-4 of
    its size."""
    arrays, want32, want64 = steps
    got = _port_step(_port_engine(ref, "substep", torch.float32), arrays, torch.float32)
    for k in ("q", "v", "lam"):
        d_port = np.abs(got[k] - want64[k]).max(axis=1)
        d_ref = np.abs(want32[k] - want64[k]).max(axis=1)
        assert np.all(d_port <= 2.0 * d_ref + 1e-4), (k, d_port, d_ref)
    scale = max(1.0, float(np.abs(want64["tau"]).max()))
    np.testing.assert_allclose(got["tau"], want64["tau"], atol=1e-4 * scale, rtol=0)
    # why: the mass matrix at the stand pose is ill-conditioned
    from jiminy_tpu_torch.core import algos

    tree = ref[3].to(dtype=torch.float64)
    M = algos.crba(tree, torch.as_tensor(ref[2], dtype=torch.float64)[None])[0]
    eig = torch.linalg.eigvalsh(M)
    assert 1e4 < float(eig.max() / eig.min()) < 1e5


def _rod_error(env, sim):
    """|d − d₀| of each pushrod, (B, 2)."""
    from jiminy_tpu_torch.core import algos

    xw = algos.forward_kinematics(env.tree, sim.q)
    out = []
    for c in env.engine.constraints:
        p1, p2 = c.points(env.tree, xw, sim.q)
        out.append(torch.linalg.vector_norm(p1 - p2, dim=-1) - c.distance)
    return torch.stack(out, dim=1).abs()


def test_model_and_loop_holds():
    """The reference's TestCassie.test_model_and_loop_holds on the port."""
    env = CassieEnv(observe="state", max_steps=100, device="cpu")
    tree = env.tree
    assert env.motors.nm == 10 and env.engine.backend == "substep"
    assert float(tree.stiffness[tree.v_off[tree.joint_index("L_shin_spring")]]) == 1500.0
    st = env.reset(torch.Generator().manual_seed(0), 1)
    for _ in range(15):
        st = env.step(st, torch.zeros(1, 10))
    assert bool(torch.isfinite(st.obs).all()) and not bool(st.done.any())
    assert float(st.sim.q[0, 2]) > 0.9  # standing
    assert float(_rod_error(env, st.sim).max()) < 1e-3


def test_knee_drives_tarsus_through_loop():
    """The reference's TestCassie.test_knee_drives_tarsus_through_loop on
    the port, from the reference's own reset state (``PRNGKey(0)``: the
    transmission is small and depends on where the knee starts)."""
    from jiminy_tpu.envs import CassieEnv as JCassieEnv
    from jiminy_tpu_torch.envs import env_state_from_arrays

    jenv = JCassieEnv(observe="state", max_steps=100)
    jst = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    arrays = {"sim": {k: np.asarray(getattr(jst.sim, k))[None] for k in SIM_FIELDS},
              **{k: np.asarray(getattr(jst, k))[None]
                 for k in ("obs", "reward", "terminated", "truncated", "steps")}}
    env = CassieEnv(observe="state", max_steps=100, device="cpu")
    st = env_state_from_arrays(arrays, torch.Generator().manual_seed(0), device="cpu")
    tarsus = env.tree.q_off[env.tree.joint_index("L_tarsus")]
    t0 = float(st.sim.q[0, tarsus])
    a = torch.zeros(1, 10)
    a[0, list(env.motors.name).index("L_knee")] = 0.8
    for _ in range(15):
        st = env.step_no_reset(st, a)
    assert abs(float(st.sim.q[0, tarsus]) - t0) > 0.01


@pytest.mark.parametrize("sim_dt", [2e-3, 1e-3])
def test_sensor_stage_caps_hold(sim_dt):
    """Cassie's suite (pelvis IMU + 10 encoders, 4 ms delay) at one update
    per substep: 10 or 20 updates per env step, within the K2 sensor
    stage's caps on groups, buffer floats and eps per update."""
    env = CassieEnv(sim_dt=sim_dt, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005,
                    device="cpu")
    assert env._fused_sensors and env.n_obs_updates == round(0.02 / sim_dt)
    sens = SensorKernelSpec(env.tree, env.sensors, env.n_substeps_per_obs)
    sens.check_kernel_caps("test")
    assert sens.n_groups <= MAX_SENS_GROUPS and sens.n_buf <= MAX_SENS_BUF
    assert sens.n_eps == 9 + 2 * 10 <= MAX_SENS_EPS
    st = env.reset(torch.Generator().manual_seed(0), 2)
    assert st.info["sensor_bufs"].shape == (2, sens.n_buf) and st.obs.shape == (2, 29)


def test_unported_options_raise():
    # flexibility (A.14) is ported: the env builds on the flexible model,
    # within the whole-substep kernels' caps, and observes 29 floats
    env = CassieEnv(flexibility=True, observe="state", device="cpu")
    assert env.engine.backend == "substep" and env.tree.nv == 26 and env.engine.nc == 28
    assert env.reset(torch.Generator().manual_seed(0), 2).obs.shape == (2, 29)
    # the declarative MDP (A.17) passes through; an unknown option raises
    fn = object()
    assert CassieEnv(reward_fn=fn, observe="state", device="cpu")._reward_fn is fn
    with pytest.raises(TypeError, match="unexpected argument 'reward'"):
        CassieEnv(reward=fn, device="cpu")
