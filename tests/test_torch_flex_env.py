"""The port's flexible-hip Cassie env step against jiminy_tpu's, in float64.

``CassieEnv(sim_dt=2e-3, target_speed=0.4, flexibility=True)``
(``examples/train.py --env cassie_flex``: 10 substeps of 2 ms per 20 ms
env step, the pushrods, the shin springs and a SPHERICAL flexibility
joint of 600 N·m/rad above each hip roll), on the state path and on the
sensor path with ``cassie_sensors_run``'s sensing (4 ms delay, IMU noise
0.02, encoder noise 0.005; 10 sensor updates per env step of the three
IMUs: the pelvis and, below the flexibility joints, the two hips). As
tests/test_torch_cassie_env.py, the comparison runs in float64 (x64 on,
the reference's model copied to float64 in a fresh engine; the port with
``dtype=float64``): float32 is not well posed on Cassie over an env step
(ROADMAP C.2).

One reference program serves both paths: the reference's sensor env's
``step_no_reset`` on its chunked path (ten engine steps of one substep,
each followed by the suite's update), vmapped and jitted once (compiling
a Cassie env step is most of this file's time). Its ``step`` is that
function plus the auto-reset, which keeps its reward, flags and
observation as the finished step's (``final_obs``); the fresh episodes
are drawn from other generators in the two packages and are not
compared. The state path's physics, reward and flags are the same
function's (the reference's state env steps the same engine over the
same substeps); its observation is the reference's privileged
``_observe`` of the reference's state.

States are the reference's reset states with the motor joints ±0.05
rad, each hip quaternion turned 0.05–0.3 rad about a random axis (a
third of them negated, w < 0) and v + 0.3·N(0, 1), handed to both
(``env_state_from_arrays``); the reference's sensor noise reaches the
port through the env's eps hook ``_sensor_eps``. B = 4.

Each path: one step in which no env finishes, every state field, the
observation, reward and buffers within 1e-9 (contact forces and a
1e-9/dt); then one step with forced terminations and a truncation, the
finished step's flags, reward and final observation (and buffers) within
1e-9, and the env that goes on as before. On the sensor path the port's
fused path (K2's plain version with the sensor stage) and its chunked
fallback both.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.envs.legged import CassieEnv as JCassieEnv
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS
from jiminy_tpu_torch.envs import CassieEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
ATOL = 1e-9
KW = dict(sim_dt=2e-3, target_speed=0.4, flexibility=True)
SENSORS = dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                "friction_viscous", "friction_vel_eps")


@functools.cache
def _reference():
    """The reference's sensor env in float64 (x64 on, which the conftest
    fixture restores after each test) on its chunked path, its jitted
    ``step_no_reset`` and privileged observation, and its reset states."""
    jax.config.update("jax_enable_x64", True)
    env = JCassieEnv(**KW, **SENSORS)
    tree, motors = env.engine.tree, env.robot.motors
    tree = tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jnp.float64)
                           for k in ARRAY_FIELDS})
    motors = motors.replace(**{k: jnp.asarray(np.asarray(getattr(motors, k)), jnp.float64)
                               for k in MOTOR_PARAMS})
    e = env.engine
    env.engine = JEngine(tree, e.options, ground=e.ground, motors=motors, controller=e.controller,
                         constraints=e.constraints)
    env.tree, env.robot.motors = tree, motors
    env._fused_sensors = False
    assert env.engine._solver_backend == "xla" and env.n_substeps == 10
    observe = jax.jit(jax.vmap(lambda sim: env._observe(sim, None)))
    return env, jax.jit(jax.vmap(env.step_no_reset)), observe, jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))


def _arrays(env, state) -> dict:
    flat = jax.vmap(env.sensors.flatten_buffers) if env.sensors is not None else None
    info = {k: np.asarray(flat(x) if isinstance(x, tuple) else x) for k, x in state.info.items()}
    return {
        "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
        **{k: np.asarray(getattr(state, k))
           for k in ("obs", "reward", "terminated", "truncated", "steps")},
        "info": info,
    }


def _start(env, template, seed, done=False):
    """The reference's reset states, perturbed (see the module's
    docstring), and an action; with ``done`` env 0 below the minimum
    height, env 1 tilted past the limit and env 2 at the step limit."""
    rng = np.random.default_rng(seed)
    t = env.tree
    sim = {k: np.array(getattr(template.sim, k), np.float64) for k in SIM_FIELDS}
    q = sim["q"]
    q[:, list(env.motors.q_idx)] += rng.uniform(-0.05, 0.05, (B, 10))
    for qo in t.sprung_spherical[1]:
        axis = rng.standard_normal((B, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        half = 0.5 * rng.uniform(0.05, 0.3, B)[:, None]
        quat = np.concatenate([axis * np.sin(half), np.cos(half)], axis=1)
        quat[rng.uniform(size=B) < 1 / 3] *= -1.0
        q[:, qo:qo + 4] = quat
    sim["v"] += 0.3 * rng.standard_normal(sim["v"].shape)
    steps = rng.integers(0, 50, B)
    if done:
        q[0, 2] = 0.3
        q[1, 3:7] = [np.sin(0.6), 0.0, 0.0, np.cos(0.6)]
        steps[2] = 999
    state = template.replace(
        sim=template.sim.replace(**{k: jnp.asarray(x) for k, x in sim.items()}),
        obs=jnp.asarray(template.obs, jnp.float64), steps=jnp.asarray(steps, jnp.int32))
    return state, rng.uniform(-1.2, 1.2, (B, 10))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def _check_sim(tnext, jnext, rows=slice(None)):
    for k in SIM_FIELDS:
        tol = ATOL / 2e-3 if k in ("contact_forces", "a") else ATOL
        _close(getattr(tnext.sim, k)[rows], jnext["sim"][k][rows], tol)
    _close(tnext.obs[rows], jnext["obs"][rows])
    _close(tnext.reward[rows], jnext["reward"][rows])
    if "sensor_bufs" in jnext["info"]:
        _close(tnext.info["sensor_bufs"][rows], jnext["info"]["sensor_bufs"][rows])


def _step(path, fused, seed, done):
    """The reference's step without reset and the port's step from the
    same state → (port env, port state after, reference arrays after: on
    the state path with the privileged observation)."""
    jax.config.update("jax_enable_x64", True)
    jenv, jstep, jobserve, template = _reference()
    kw = dict(KW, **(SENSORS if path == "sensors" else {"observe": "state"}))
    env = CassieEnv(device="cpu", dtype=torch.float64, **kw)
    assert env.engine.backend == "substep" and env._fused_sensors == (path == "sensors")
    assert env.tree.nv == 26 and env.engine.nc == 28
    env._fused_sensors = fused
    jst, action = _start(env, template, seed, done)
    jnxt = jstep(jst, jnp.asarray(action))
    jnext = _arrays(jenv, jnxt)
    if path == "sensors":
        suite, n = jenv.sensors, jenv.n_obs_updates

        def eps_of(rng):  # the reference fallback's corruption draws
            keys = jax.random.split(jax.random.split(rng, 4)[3], n)
            return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

        eps = torch.as_tensor(np.array(jax.jit(jax.vmap(eps_of))(jst.rng)))
        n_eps = env.sensors.n_eps
        assert n_eps == 3 * 9 + 2 * 10 and eps.shape == (B, 10 * n_eps)
        # a step asks for its 10 updates; the auto-reset's fill for one
        env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: \
            eps[:, :n_updates * n_eps]
        tst = env_state_from_arrays(_arrays(jenv, jst), torch.Generator().manual_seed(seed),
                                    device="cpu", dtype=torch.float64)
    else:
        jnext["obs"] = np.asarray(jobserve(jnxt.sim))
        del jnext["info"]["sensor_bufs"]
        start = _arrays(jenv, jst)
        start["obs"] = np.asarray(jobserve(jst.sim))
        start["info"] = {}
        tst = env_state_from_arrays(start, torch.Generator().manual_seed(seed), device="cpu",
                                    dtype=torch.float64)
    return env, env.step(tst, torch.as_tensor(action)), jnext


# (path, fused): the state path, and the sensor path fused and chunked
PATHS = pytest.mark.parametrize("path, fused", [("state", True), ("sensors", True),
                                                ("sensors", False)],
                                ids=["state", "sensors-fused", "sensors-chunked"])


@PATHS
def test_step_matches_reference(path, fused):
    env, tnext, jnext = _step(path, fused, seed=0, done=False)
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    vo = env.tree.sprung_spherical[0]
    flex_tau = np.abs(jnext["sim"]["tau"][:, vo[0]:vo[0] + 3]).max()
    assert flex_tau > 20.0  # the flexibility springs pull
    _check_sim(tnext, jnext)
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])


@PATHS
def test_auto_reset_matches_reference(path, fused):
    env, tnext, jnext = _step(path, fused, seed=1, done=True)
    term, trunc = jnext["terminated"], jnext["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3] or trunc[3])
    np.testing.assert_array_equal(tnext.terminated.numpy(), term)
    np.testing.assert_array_equal(tnext.truncated.numpy(), trunc)
    np.testing.assert_array_equal(tnext.steps.numpy(), np.where(term | trunc, 0, jnext["steps"]))
    _close(tnext.reward, jnext["reward"])
    _close(tnext.info["final_obs"], jnext["obs"])  # the reference's step keeps these
    if path == "sensors":
        _close(tnext.info["final_sensor_bufs"], jnext["info"]["sensor_bufs"])
    _check_sim(tnext, jnext, rows=slice(3, 4))  # the env that goes on
    done = torch.as_tensor(term | trunc)
    assert (tnext.sim.t[done] == 0).all() and (tnext.steps[done] == 0).all()
    torch.testing.assert_close(tnext.obs, env._make_obs(tnext.sim, tnext.info), atol=0, rtol=0)
