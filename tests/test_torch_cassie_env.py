"""The port's Cassie env step against jiminy_tpu's, in float64.

``CassieEnv(sim_dt=2e-3, target_speed=0.4)`` (``examples/train.py --env
cassie``: 10 substeps of 2 ms per 20 ms env step, the pushrods and the
shin springs) is built by both packages, on the state path and on the
sensor path with ``cassie_sensors_run``'s sensing (4 ms delay, IMU noise
0.02, encoder noise 0.005; 10 sensor updates per env step). Over a whole
env step two float32 versions drift apart by ~1e-2 in v on Cassie
(ROADMAP C.2: its mass matrix's condition is of order 1e4), so the comparison
runs in float64: the reference with x64 on and its model (tree, motors)
copied to float64 in a fresh engine, the port with ``dtype=float64``.
States are the reference's reset states plus numpy noise, handed to
both (``env_state_from_arrays``); the reference's sensor noise reaches
the port through the env's eps hook ``_sensor_eps``. B = 4.

Each path: one step in which no env finishes (the reference's ``step``
equals its ``step_no_reset`` there), every state and info field within
1e-9 (contact forces 1e-9/dt); then one step with forced terminations
and a truncation, the finished step's flags, reward and final
observation (and buffers) within 1e-9, and the env that goes on as
before. On the sensor path the port's fused path (K2's plain version
with the sensor stage) and its chunked fallback both.
"""

from __future__ import annotations

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
KW = dict(sim_dt=2e-3, target_speed=0.4)
SENSORS = dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                "friction_viscous", "friction_vel_eps")


class _Ref:
    """The reference env in float64 (x64 on while it is built, reset and
    stepped), on its chunked sensor path, its jitted step and a template
    state."""

    def __init__(self, observe):
        kw = dict(KW, **(SENSORS if observe == "sensors" else {"observe": "state"}))
        self.env = env = JCassieEnv(**kw)
        tree, motors = env.engine.tree, env.robot.motors
        tree = tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jnp.float64)
                               for k in ARRAY_FIELDS})
        motors = motors.replace(**{k: jnp.asarray(np.asarray(getattr(motors, k)), jnp.float64)
                                   for k in MOTOR_PARAMS})
        e = env.engine
        env.engine = JEngine(tree, e.options, ground=e.ground, motors=motors,
                             controller=e.controller, constraints=e.constraints)
        env.tree, env.robot.motors = tree, motors
        env._fused_sensors = False
        assert env.engine._solver_backend == "xla" and env.n_substeps == 10
        self.sensors = observe == "sensors"
        self.step = jax.jit(jax.vmap(env.step))
        self.template = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), B))

    def eps_of_step(self, state):
        """The corruption the reference's fallback draws in a step, per
        env: sample_eps on the keys it splits from the state's rng."""
        suite, n = self.env.sensors, self.env.n_obs_updates

        def one(rng):
            keys = jax.random.split(jax.random.split(rng, 4)[3], n)
            return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

        return np.asarray(jax.jit(jax.vmap(one))(state.rng))

    def arrays(self, state) -> dict:
        flat = jax.vmap(self.env.sensors.flatten_buffers) if self.sensors else None
        info = {k: np.asarray(flat(x) if isinstance(x, tuple) else x)
                for k, x in state.info.items()}
        return {
            "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
            **{k: np.asarray(getattr(state, k))
               for k in ("obs", "reward", "terminated", "truncated", "steps")},
            "info": info,
        }


def _ref_fixture(observe):
    @pytest.fixture(scope="module")
    def fixture():
        jax.config.update("jax_enable_x64", True)
        try:
            yield _Ref(observe)
        finally:
            jax.config.update("jax_enable_x64", False)

    return fixture


ref_state = _ref_fixture("state")
ref_sensors = _ref_fixture("sensors")
# (path, fused): the state path, and the sensor path fused and chunked
PATHS = pytest.mark.parametrize("path, fused", [("state", True), ("sensors", True),
                                                ("sensors", False)],
                                ids=["state", "sensors-fused", "sensors-chunked"])


def _start(ref, seed, done=False):
    """The reference's reset states in float64 with the motor joints
    ±0.05 rad, v + 0.3·N(0, 1), and an action; with ``done`` env 0 below
    the minimum height, env 1 tilted past the limit and env 2 at the step
    limit."""
    rng = np.random.default_rng(seed)
    t = ref.template
    sim = {k: np.array(getattr(t.sim, k), np.float64) for k in SIM_FIELDS}
    sim["q"][:, 7:] += rng.uniform(-0.05, 0.05, (B, 14))
    sim["v"] += 0.3 * rng.standard_normal(sim["v"].shape)
    steps = rng.integers(0, 50, B)
    if done:
        sim["q"][0, 2] = 0.3
        sim["q"][1, 3:7] = [np.sin(0.6), 0.0, 0.0, np.cos(0.6)]
        steps[2] = 999
    state = t.replace(sim=t.sim.replace(**{k: jnp.asarray(x) for k, x in sim.items()}),
                      obs=jnp.asarray(t.obs, jnp.float64), steps=jnp.asarray(steps, jnp.int32))
    return state, rng.uniform(-1.2, 1.2, (B, 10))


def _port(ref, fused):
    kw = dict(KW, **(SENSORS if ref.sensors else {"observe": "state"}))
    env = CassieEnv(device="cpu", dtype=torch.float64, **kw)
    assert env.engine.backend == "substep" and env._fused_sensors == ref.sensors
    env._fused_sensors = fused
    return env


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


def _step(ref, fused, seed, done):
    """The reference's step and the port's from the same state → (port
    env, port state after, reference arrays after)."""
    jax.config.update("jax_enable_x64", True)
    jst, action = _start(ref, seed, done)
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)))
    env = _port(ref, fused)
    if ref.sensors:
        eps = torch.as_tensor(np.array(ref.eps_of_step(jst)))
        n_eps = env.sensors.n_eps
        assert eps.shape == (B, 10 * n_eps)
        # a step asks for its 10 updates; the auto-reset's fill for one
        env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: \
            eps[:, :n_updates * n_eps]
    tst = env_state_from_arrays(ref.arrays(jst), torch.Generator().manual_seed(seed),
                                device="cpu", dtype=torch.float64)
    return env, env.step(tst, torch.as_tensor(action)), jnext


@PATHS
def test_step_matches_reference(request, path, fused):
    ref = request.getfixturevalue(f"ref_{path}")
    env, tnext, jnext = _step(ref, fused, seed=0, done=False)
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    assert np.abs(jnext["sim"]["lam"][:, :2]).max() > 0.05  # the pushrods carry load
    _check_sim(tnext, jnext)
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])


@PATHS
def test_auto_reset_matches_reference(request, path, fused):
    ref = request.getfixturevalue(f"ref_{path}")
    env, tnext, jnext = _step(ref, fused, seed=1, done=True)
    term, trunc = jnext["terminated"], jnext["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3] or trunc[3])
    np.testing.assert_array_equal(tnext.terminated.numpy(), term)
    np.testing.assert_array_equal(tnext.truncated.numpy(), trunc)
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])
    _close(tnext.reward, jnext["reward"])
    _close(tnext.info["final_obs"], jnext["info"]["final_obs"])
    if ref.sensors:
        _close(tnext.info["final_sensor_bufs"], jnext["info"]["final_sensor_bufs"])
    _check_sim(tnext, jnext, rows=slice(3, 4))  # the env that goes on
    done = torch.as_tensor(term | trunc)
    assert (tnext.sim.t[done] == 0).all() and (tnext.steps[done] == 0).all()
    torch.testing.assert_close(tnext.obs, env._make_obs(tnext.sim, tnext.info), atol=0, rtol=0)
