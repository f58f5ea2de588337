"""The port's Cassie env with self-collision against jiminy_tpu's, in
float64.

``CassieEnv(sim_dt=2e-3, target_speed=0.4, self_collision=True)``
(``examples/train.py --env cassie --self-collision``: the legs' three
capsule pairs as PGS rows, nc = 37) is built by both packages, on the
state path and on the sensor path (``cassie_sensors_run``'s sensing).
As tests/test_torch_cassie_env.py, the comparison runs in float64 (x64 on,
the reference's model copied to float64 in a fresh engine with the same
pairs; the port with ``dtype=float64``): float32 is not well posed on
Cassie over an env step (ROADMAP C.2).

States are the reference's reset states with the legs brought together
(hip rolls inward by 0.1–0.4 rad, yaws ±0.3 rad) and numpy noise, so that
pair rows are active (depth > −margin) at the start in half the envs
at least, and the pairs move the step: the same step without them ends
elsewhere. The state path runs three env steps in a row, each from both
packages' previous states; every state field, observation and reward
within 1e-9 after each (contact forces 1e-9/dt). The sensor path runs one
step, the port fused and chunked, the reference's sensor noise handed to
the port. No env finishes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.envs.legged import CassieEnv as JCassieEnv
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS
from jiminy_tpu_torch.engine.collision import pair_rows
from jiminy_tpu_torch.envs import CassieEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
ATOL = 1e-9
KW = dict(sim_dt=2e-3, target_speed=0.4, self_collision=True)
SENSORS = dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                "friction_viscous", "friction_vel_eps")


def _reference(observe):
    """The reference env in float64 on its chunked path, its jitted step
    and its reset states (x64 on; the conftest fixture restores it after
    each test)."""
    jax.config.update("jax_enable_x64", True)
    return _reference_x64(observe)


@functools.cache
def _reference_x64(observe):
    env = JCassieEnv(**KW, **(SENSORS if observe == "sensors" else {"observe": "state"}))
    tree, motors = env.engine.tree, env.robot.motors
    tree = tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jnp.float64)
                           for k in ARRAY_FIELDS})
    motors = motors.replace(**{k: jnp.asarray(np.asarray(getattr(motors, k)), jnp.float64)
                               for k in MOTOR_PARAMS})
    e = env.engine
    env.engine = JEngine(tree, e.options, ground=e.ground, motors=motors, controller=e.controller,
                         constraints=e.constraints, collision_pairs=e.collision_pairs)
    env.tree, env.robot.motors = tree, motors
    env._fused_sensors = False
    assert env.engine._solver_backend == "xla" and len(env.engine.collision_pairs) == 3
    return env, jax.jit(jax.vmap(env.step)), jax.jit(jax.vmap(env.reset))(
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


def _legs_together(template, tree_names, seed):
    """The reset states with the hips turned inward and noise, and the
    three actions of a run."""
    rng = np.random.default_rng(seed)
    sim = {k: np.array(getattr(template.sim, k), np.float64) for k in SIM_FIELDS}
    q = sim["q"]
    q[:, 7:] += rng.uniform(-0.05, 0.05, (B, 14))
    idx = {n: 7 + i for i, n in enumerate(tree_names)}
    q[:, idx["L_hip_roll"]] = -rng.uniform(0.1, 0.4, B)
    q[:, idx["R_hip_roll"]] = rng.uniform(0.1, 0.4, B)
    q[:, [idx["L_hip_yaw"], idx["R_hip_yaw"]]] = rng.uniform(-0.3, 0.3, (B, 2))
    sim["v"] += 0.3 * rng.standard_normal(sim["v"].shape)
    state = template.replace(
        sim=template.sim.replace(**{k: jnp.asarray(x) for k, x in sim.items()}),
        obs=jnp.asarray(template.obs, jnp.float64),
        steps=jnp.asarray(rng.integers(0, 50, B), jnp.int32))
    return state, [rng.uniform(-1.0, 1.0, (B, 10)) for _ in range(3)]


def _joint_names(env):
    """Names of the 1-DoF joints in q order after the free base."""
    t = env.tree
    return [t.joint_name[i] for i in range(1, t.nb)]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def _active_share(env, q) -> float:
    """Share of envs with a pair row active at q."""
    spec, o = env.engine.substep_spec, env.engine.options
    xw = algos.forward_kinematics(spec.tree, q)
    act = pair_rows(spec.pairs, spec.tree, xw, spec.dt, spec.alpha_c_over_dt, o.contact_margin,
                    o.contact_slop, o.contact_max_correction_vel)[2]
    return float((act > 0).any(dim=1).double().mean())


def _check(tnext, jnext):
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    for k in SIM_FIELDS:
        _close(getattr(tnext.sim, k), jnext["sim"][k], ATOL / 2e-3 if k in ("contact_forces", "a")
               else ATOL)
    _close(tnext.obs, jnext["obs"])
    _close(tnext.reward, jnext["reward"])
    if "sensor_bufs" in jnext["info"]:
        _close(tnext.info["sensor_bufs"], jnext["info"]["sensor_bufs"])


def test_state_path_matches_reference_over_three_steps():
    jenv, jstep, template = _reference("state")
    env = CassieEnv(device="cpu", dtype=torch.float64, observe="state", **KW)
    assert env.engine.backend == "substep" and env.engine.nc == 37
    jst, actions = _legs_together(template, _joint_names(env), seed=0)
    tst = env_state_from_arrays(_arrays(jenv, jst), torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float64)
    assert _active_share(env, tst.sim.q) >= 0.5
    no_pairs = tst.replace(sim=dataclasses.replace(tst.sim, lam=tst.sim.lam[:, :28]))
    apart = CassieEnv(device="cpu", dtype=torch.float64, observe="state",
                      **dict(KW, self_collision=False)).step(no_pairs, torch.as_tensor(actions[0]))
    for i, a in enumerate(actions):
        jst = jstep(jst, jnp.asarray(a))
        jnext = _arrays(jenv, jst)
        tst = env.step(tst, torch.as_tensor(a))
        _check(tst, jnext)
        if i == 0:  # the pairs move the step
            assert float((tst.sim.q - apart.sim.q).abs().max()) > 1e-4


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chunked"])
def test_sensor_path_matches_reference(fused):
    jenv, jstep, template = _reference("sensors")
    env = CassieEnv(device="cpu", dtype=torch.float64, **SENSORS, **KW)
    assert env._fused_sensors
    env._fused_sensors = fused
    jst, actions = _legs_together(template, _joint_names(env), seed=1)
    suite, n = jenv.sensors, jenv.n_obs_updates

    def eps_of(rng):  # the reference fallback's corruption draws
        keys = jax.random.split(jax.random.split(rng, 4)[3], n)
        return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

    eps = torch.as_tensor(np.array(jax.jit(jax.vmap(eps_of))(jst.rng)))
    n_eps = env.sensors.n_eps
    env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: \
        eps[:, :n_updates * n_eps]
    tst = env_state_from_arrays(_arrays(jenv, jst), torch.Generator().manual_seed(1),
                                device="cpu", dtype=torch.float64)
    jnext = _arrays(jenv, jstep(jst, jnp.asarray(actions[0])))
    assert _active_share(env, tst.sim.q) >= 0.5
    tnext = env.step(tst, torch.as_tensor(actions[0]))
    _check(tnext, jnext)
