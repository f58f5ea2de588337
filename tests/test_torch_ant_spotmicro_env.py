"""The port's AntEnv and SpotmicroEnv against jiminy_tpu's, in float64.

``AntEnv()`` (``ant_run``, ``ant_sensors_run5``: 50 ms env steps of 20
substeps of 2.5 ms, its sensors every 5 ms, so one update every second
substep) and ``SpotmicroEnv()`` (``spotmicro_run``,
``spotmicro_sensors_run``: 20 ms of 20 substeps of 1 ms, sensors every
substep), each with the reference's defaults, on the state path and on
the sensor path, fused and chunked. As tests/test_torch_flex_env.py, the
comparison runs in float64 (x64 on, the reference's model copied to
float64 in a fresh engine; the port with ``dtype=float64``), and one
reference program per model serves both paths: its sensor env's
``step_no_reset`` on its chunked path, vmapped and jitted once. The
state path's physics, reward and flags are the same function's; its
observation is the reference's privileged ``_observe``.

States are the reference's reset states with the motor joints ±0.05 rad
and v + 0.3·N(0, 1), handed to both (``env_state_from_arrays``); the
reference's sensor noise reaches the port through the env's eps hook
``_sensor_eps``. B = 4. Two chained env steps in which no env finishes:
every state field, the observation, reward and buffers within 1e-9
(contact forces and a within 1e-9/dt). The port's own reset: the stand
pose within the reset noise, a finite observation of the model's width.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.envs.legged import AntEnv as JAntEnv
from jiminy_tpu.envs.legged import SpotmicroEnv as JSpotmicroEnv
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS
from jiminy_tpu_torch.envs import AntEnv, SpotmicroEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
ATOL = 1e-9
N_STEPS = 2
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                "friction_viscous", "friction_vel_eps")
# name → (reference env, port env, motors, observation width, sensor updates per step)
MODELS = {"ant": (JAntEnv, AntEnv, 8, 25, 10), "spotmicro": (JSpotmicroEnv, SpotmicroEnv, 12, 33, 20)}


@functools.cache
def _reference(name):
    """The reference's sensor env of ``name`` in float64 (x64 on, which the
    conftest fixture restores after each test) on its chunked path, its
    jitted ``step_no_reset`` and privileged observation, and its reset
    states."""
    jax.config.update("jax_enable_x64", True)
    env = MODELS[name][0](observe="sensors")
    tree, motors = env.engine.tree, env.robot.motors
    tree = tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jnp.float64)
                           for k in ARRAY_FIELDS})
    motors = motors.replace(**{k: jnp.asarray(np.asarray(getattr(motors, k)), jnp.float64)
                               for k in MOTOR_PARAMS})
    e = env.engine
    env.engine = JEngine(tree, e.options, ground=e.ground, motors=motors, controller=e.controller)
    env.tree, env.robot.motors = tree, motors
    env._fused_sensors = False
    assert env.engine._solver_backend == "xla" and env.n_substeps == 20
    assert env.n_obs_updates == MODELS[name][4]
    observe = jax.jit(jax.vmap(lambda sim: env._observe(sim, None)))
    return env, jax.jit(jax.vmap(env.step_no_reset)), observe, jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))


def _arrays(env, state) -> dict:
    flat = jax.vmap(env.sensors.flatten_buffers)
    info = {k: np.asarray(flat(x) if isinstance(x, tuple) else x) for k, x in state.info.items()}
    return {
        "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
        **{k: np.asarray(getattr(state, k))
           for k in ("obs", "reward", "terminated", "truncated", "steps")},
        "info": info,
    }


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("path, fused", [("state", True), ("sensors", True), ("sensors", False)],
                         ids=["state", "sensors-fused", "sensors-chunked"])
@pytest.mark.parametrize("name", ["ant", "spotmicro"])
def test_steps_match_reference(name, path, fused):
    jax.config.update("jax_enable_x64", True)
    jenv, jstep, jobserve, template = _reference(name)
    nm, dt = MODELS[name][2], float(jenv.engine.options.dt)
    env = MODELS[name][1](observe=path, device="cpu", dtype=torch.float64)
    assert env.engine.backend == "substep" and env._fused_sensors == (path == "sensors")
    assert env.n_substeps == 20 and env.n_substeps_per_obs == (20 if path == "state" else
                                                               {"ant": 2, "spotmicro": 1}[name])
    env._fused_sensors = fused
    rng = np.random.default_rng(0)
    sim = {k: np.array(getattr(template.sim, k), np.float64) for k in SIM_FIELDS}
    sim["q"][:, list(env.motors.q_idx)] += rng.uniform(-0.05, 0.05, (B, nm))
    sim["v"] += 0.3 * rng.standard_normal(sim["v"].shape)
    jst = template.replace(
        sim=template.sim.replace(**{k: jnp.asarray(x) for k, x in sim.items()}),
        obs=jnp.asarray(template.obs, jnp.float64),
        steps=jnp.asarray(rng.integers(0, 50, B), jnp.int32))
    start = _arrays(jenv, jst)
    if path == "state":
        start["obs"], start["info"] = np.asarray(jobserve(jst.sim)), {}
    tst = env_state_from_arrays(start, torch.Generator().manual_seed(0), device="cpu",
                                dtype=torch.float64)
    suite, n = jenv.sensors, jenv.n_obs_updates

    def eps_of(key):  # the reference fallback's corruption draws
        keys = jax.random.split(jax.random.split(key, 4)[3], n)
        return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

    draws = []
    env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: draws[-1]
    for _ in range(N_STEPS):
        action = rng.uniform(-1.2, 1.2, (B, nm))
        draws.append(torch.as_tensor(np.array(jax.jit(jax.vmap(eps_of))(jst.rng))))
        jst = jstep(jst, jnp.asarray(action))
        tst = env.step(tst, torch.as_tensor(action))
        want = _arrays(jenv, jst)
        assert not (want["terminated"] | want["truncated"]).any()
        for k in SIM_FIELDS:
            _close(getattr(tst.sim, k), want["sim"][k],
                   ATOL / dt if k in ("contact_forces", "a") else ATOL)
        _close(tst.obs, np.asarray(jobserve(jst.sim)) if path == "state" else want["obs"])
        _close(tst.reward, want["reward"])
        if path == "sensors":
            _close(tst.info["sensor_bufs"], want["info"]["sensor_bufs"])
        np.testing.assert_array_equal(tst.steps.numpy(), want["steps"])
    assert np.abs(want["sim"]["lam"]).max() > 0  # the feet and bounds carry the body


@pytest.mark.parametrize("path", ["state", "sensors"])
@pytest.mark.parametrize("name", ["ant", "spotmicro"])
def test_reset(name, path):
    env = MODELS[name][1](observe=path, device="cpu")
    st = env.reset(torch.Generator().manual_seed(1), 16)
    q, stand = st.sim.q, env._q_stand
    qi = list(env.motors.q_idx)
    assert ((q[:, qi] - stand[qi]).abs() <= env.reset_noise + 1e-6).all()
    torch.testing.assert_close(q[:, :7], stand[:7].expand(16, 7), atol=0, rtol=0)
    assert st.obs.shape == (16, MODELS[name][3]) and bool(torch.isfinite(st.obs).all())
    if path == "sensors":
        assert st.info["sensor_bufs"].shape == (16, env.sensors.n_buf)
