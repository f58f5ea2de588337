"""The port's pipeline wrappers, gym adapter and registry against
jiminy_tpu's, and the pipeline-trained artifacts on the port.

- Every wrapper (a PD controller with target integration, the ``mahony``
  observer, ``stack:3``, ``normalize``), stacked in one pipeline, over a
  scripted inner env written in each package: both replay one recorded
  batch of observations, done flags (terminations and truncations),
  terminal observations, sensor ring buffers (ANYmal's suite) and
  terminal buffers, with resets in it. The reference's pipeline is one
  env vmapped; the port's a batch. Every step's observation, terminal
  observation, the controller's command and every layer's state (the
  integrated targets, the filter, the FIFO, the per-env statistics) agree
  within 1e-6 (float32 rounding: XLA fuses some products into FMAs), the
  normalized observations within 1e-4 (a variance of ~1e-6 after the
  first update magnifies the rounding), then
  ``step_no_reset`` (which updates no statistics), and
  ``freeze_pipeline_stats`` (the batch mean of the per-env statistics)
  and a reset of the frozen pipeline.
- The slice: one step of the reference's vmapped
  ``build_pipeline(ANYmalEnv(observe="sensors", sensor_delay=0.004,
  <declarative MDP>), [mahony, stack:4])`` (its chunked sensor path, the
  engine ``"xla"``: one compiled program for the reset and the step) from
  its reset states, three of the four envs made to end (below the
  height, tilted, at the step limit), against the port's at B = 4 from
  the same state carried across by ``wrapper_state_from_arrays``:
  tests/test_torch_sensor_env.py's tolerances (obs 1e-4, the scaled
  accelerometer's columns 2e-3, reward 1e-4, terminations exact); the
  terminal observation of the finished envs alike, the layers of the
  one that goes on within 1e-4.
- ``artifacts/anymal_sensors_run5``'s policy (``mahony,stack:4``; the
  reference's ``restore_raw``, converted) walks the port's sensor env
  (delay 0.004 s, noise 0.02 / 0.005) through the port's pipeline: 16
  envs for 100 steps with no fall and a speed of 0.70–0.85 m/s (the
  band of tests/test_torch_policy.py; the run's own 0.79 m/s).
  ``artifacts/cartpole_pipeline_run`` (``stack:4,normalize``) is
  evaluated through ``freeze_pipeline_stats`` of the reference
  checkpoint's raw carry: the frozen mean and var within 1e-7 of the
  exact batch mean and 2 ulp of the reference's own (its float32 sum),
  16 envs alive for 100 steps.
- ``register_envs`` and ``gymnasium.make("jiminy_tpu_torch/CartPole-v0")``
  resets and steps; the spaces equal the reference adapter's.
- The checkpoint of a carry holding nested ``WrapperState`` s round-trips
  bit for bit; ``tools/train.py --pipeline`` trains and evaluates, and
  ``tools/evaluate.py --pipeline`` reads its run.
- A wrapper exposes the reference's metadata and no ``symmetry_fn``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import SimState as JSimState
from jiminy_tpu.envs import blocks as jb
from jiminy_tpu.envs import pipeline as jp
from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu.envs.anymal import anymal_declarative_mdp as j_declarative_mdp
from jiminy_tpu.envs.base import EnvState as JEnvState
from jiminy_tpu.hardware import Motors as JMotors
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu_torch.checkpoint import CheckpointManager, restore_raw
from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.envs import (
    ANYmalEnv,
    CartPoleEnv,
    EnvState,
    anymal_declarative_mdp,
    build_pipeline,
    freeze_pipeline_stats,
    wrapper_state_from_arrays,
)
from jiminy_tpu_torch.envs import blocks as pb
from jiminy_tpu_torch.envs import pipeline as pp
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.models.quadruped import make_anymal
from jiminy_tpu_torch.rl import MLPPolicy, evaluate, greedy_policy, policy_params_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, T, D, NQ, A = 4, 8, 5, 6, 3
STEP_DT = 0.02
LAYERS = [{"type": "mahony", "kp": 2.0, "ki": 0.3}, {"type": "stack", "n": 3},
          {"type": "normalize"}]


def _sequence(suite_groups, seed=0):
    """A recorded batch: (T + 1, B, ...) observations, q, rewards, done
    flags (none at t = 0), terminal observations and sensor buffers (equal
    to the next ones where the env goes on), as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    term = np.zeros((T + 1, B), bool)
    trunc = np.zeros((T + 1, B), bool)
    term[2, 1] = term[5, 1] = term[3, 3] = True
    trunc[4, 0] = trunc[4, 2] = True
    done = term | trunc
    obs = f(T + 1, B, D)
    bufs = []
    for g in suite_groups:
        x = f(T + 1, B, g.ns, g.buf_len, g.dim)
        if g.type == "imu":  # the accelerometer about 1 g up
            x[..., 9] += 9.81
        bufs.append(x)
    final_obs = np.where(done[..., None], f(T + 1, B, D), obs)
    final_bufs = [np.where(done.reshape(T + 1, B, 1, 1, 1), f(*b.shape), b) for b in bufs]
    return dict(obs=obs, q=f(T + 1, B, NQ), reward=f(T + 1, B), term=term, trunc=trunc,
                final_obs=final_obs, bufs=bufs, final_bufs=final_bufs)


class _JScripted:
    """The reference side: one env replaying env ``rng``'s row of the
    sequence (vmapped over the rows; the reset's "key" is the row)."""

    action_size, discrete_actions = A, None

    def __init__(self, seq, suite):
        self.seq = jax.tree.map(jnp.asarray, seq)
        self.sensors, self.step_dt = suite, STEP_DT

    def _state(self, t, i, action):
        s = self.seq
        sim = JSimState(t=jnp.float32(0.0), q=s["q"][t, i], v=jnp.zeros(NQ),
                        contact_forces=jnp.zeros((0, 3)))
        info = {"final_obs": s["final_obs"][t, i],
                "sensor_bufs": tuple(b[t, i] for b in s["bufs"]),
                "final_sensor_bufs": tuple(b[t, i] for b in s["final_bufs"]),
                "action": action}
        return JEnvState(sim=sim, obs=s["obs"][t, i], reward=s["reward"][t, i],
                         terminated=s["term"][t, i], truncated=s["trunc"][t, i],
                         steps=jnp.int32(t), rng=i, info=info)

    def reset(self, key):
        return self._state(0, key, jnp.zeros(A))

    def step(self, state, action):
        return self._state(state.steps + 1, state.rng, action)

    step_no_reset = step


class _PScripted:
    """The port side: the batch replaying the sequence."""

    action_size, discrete_actions, termination_meaning = A, None, "failure"
    device = torch.device("cpu")

    def __init__(self, seq, suite):
        self.seq, self.sensors, self.step_dt = seq, suite, STEP_DT

    def _state(self, t, generator, action):
        s = self.seq
        x = lambda a: torch.as_tensor(a[t])  # noqa: E731
        flat = lambda bufs: torch.cat([torch.as_tensor(b[t]).reshape(B, -1) for b in bufs], 1)  # noqa: E731,E501
        zeros = torch.zeros(B)
        sim = SimState(t=zeros, q=x(s["q"]), v=torch.zeros(B, NQ),
                       contact_forces=torch.zeros(B, 0, 3), solver_residual=zeros,
                       lam=torch.zeros(B, 0), a=torch.zeros(B, NQ), tau=torch.zeros(B, NQ))
        return EnvState(sim=sim, obs=x(s["obs"]), reward=x(s["reward"]), terminated=x(s["term"]),
                        truncated=x(s["trunc"]), steps=torch.full((B,), t, dtype=torch.int32),
                        generator=generator,
                        info={"final_obs": x(s["final_obs"]), "sensor_bufs": flat(s["bufs"]),
                              "final_sensor_bufs": flat(s["final_bufs"]), "action": action})

    def reset(self, generator, batch_size):
        assert batch_size == B
        return self._state(0, generator, torch.zeros(B, A))

    def step(self, state, action):
        return self._state(int(state.steps[0]) + 1, state.generator, action)

    step_no_reset = step


def _pd_inputs(s):
    return {"qm": s.sim.q[..., :A], "vm": 0.1 * s.sim.q[..., A:2 * A]}


def _pipelines():
    """The same pipeline over each package's scripted env: a PD controller
    (velocity targets integrated) under mahony, stack:3 and normalize."""
    jsuite = j_make_anymal(sensor_period=0.005, sensor_delay=0.004).sensors
    psuite = make_anymal(device="cpu", sensor_period=0.005, sensor_delay=0.004)[2]
    seq = _sequence(psuite.groups)
    kw = dict(kp=5.0, kd=0.5, dt=STEP_DT, integrate_velocity=True)
    limit = np.full(A, 3.0, np.float32)
    jpd = jb.PDControllerBlock(JMotors.create([0, 1, 2], q_idx=[0, 1, 2], effort_limit=limit), **kw)
    ppd = pb.PDControllerBlock(Motors.create([0, 1, 2], q_idx=[0, 1, 2], effort_limit=limit,
                                             device="cpu"), **kw)
    jenv = jp.build_pipeline(jp.ControlledEnv(_JScripted(seq, jsuite), jpd, _pd_inputs), LAYERS)
    penv = build_pipeline(pp.ControlledEnv(_PScripted(seq, psuite), ppd, _pd_inputs), LAYERS)
    return jenv, penv


def _arrays(x):
    """A reference state (flax dataclasses, dicts, tuples of arrays) as
    nested dicts and lists of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: _arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _arrays(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_arrays(v) for v in x]
    return None if x is None else np.asarray(x)


def _layers(jst, pst):
    """(reference, port) layer states, outermost first: normalize, stack,
    mahony, controller."""
    out = []
    while isinstance(pst, pp.WrapperState):
        out.append((_arrays(jst.layer), pst.layer))
        jst, pst = jst.inner, pst.inner
    return out


def _same(port, ref, tol=0.0):
    if isinstance(port, dict):
        assert set(port) == set(ref), (set(port), set(ref))
        for k in port:
            _same(port[k], ref[k], tol)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def _check(jst, pst):
    # the normalized observation at 1e-4: after the first update (count
    # 1 + 1e-6) the variance is ~1e-6, which magnifies float32 rounding
    _same(pst.obs, jst.obs, 1e-4)
    _same(pst.info["final_obs"], jst.info["final_obs"], 1e-4)
    _same(pst.inner.obs, jst.inner.obs, 1e-6)
    _same(pst.inner.info["final_obs"], jst.inner.info["final_obs"], 1e-6)
    _same(pst.info["action"], jst.info["action"], 1e-6)
    for ref, port in _layers(jst, pst):
        _same(port, ref, 1e-6)


def test_wrappers_match_reference_over_a_scripted_env():
    jenv, penv = _pipelines()
    jstep = jax.jit(jax.vmap(jenv.step))
    jst = jax.vmap(jenv.reset)(jnp.arange(B))
    pst = penv.reset(torch.Generator(), B)
    _check(jst, pst)
    rng = np.random.default_rng(1)
    for t in range(1, T):
        action = rng.uniform(-1.0, 1.0, (B, A)).astype(np.float32)
        jst, pst = jstep(jst, jnp.asarray(action)), penv.step(pst, torch.as_tensor(action))
        _check(jst, pst)
        done = pst.done
        assert done.any() == bool(np.asarray(jst.done).any())
        if t == 2:  # env 1 ends: its FIFO restarts (zeros behind the new frame)
            stack = pst.inner
            assert done.tolist() == [False, True, False, False]
            assert not stack.layer[1, 1:].any() and stack.layer[0, 1:].all()
            assert not stack.obs[1, D + 4:].any() and stack.obs[0, D + 4:].all()
            # while its terminal observation stacks the finished episode's frames
            assert stack.info["final_obs"][1, D + 4:].all()
    stats = pst.layer
    assert stats["mean"].shape == (B, 3 * (D + 4)) and stats["count"].shape == (B,)
    # the statistics update from every step's observation, resets included
    torch.testing.assert_close(stats["count"], torch.full((B,), float(T - 1)), atol=1e-5, rtol=0)
    # step_no_reset: the layers step, the statistics do not
    action = rng.uniform(-1.0, 1.0, (B, A)).astype(np.float32)
    jst2 = jax.jit(jax.vmap(jenv.step_no_reset))(jst, jnp.asarray(action))
    pst2 = penv.step_no_reset(pst, torch.as_tensor(action))
    _check(jst2, pst2)
    assert torch.equal(pst2.layer["mean"], stats["mean"])
    # the frozen twin: every env starts from the batch mean of the statistics
    jfrozen, pfrozen = jp.freeze_pipeline_stats(jenv, jst), freeze_pipeline_stats(penv, pst)
    _same(pfrozen.stats["mean"], jfrozen.stats["mean"], 2.4e-7)
    _same(pfrozen.stats["var"], jfrozen.stats["var"], 2.4e-7)
    assert not pfrozen.update and pfrozen.unwrapped is penv.unwrapped
    jr = jax.vmap(jfrozen.reset)(jnp.arange(B))
    pr = pfrozen.reset(torch.Generator(), B)
    _check(jr, pr)
    _same(pr.layer["mean"][2], stats["mean"].double().mean(0).float(), 0.0)


def _reference_slice():
    """The reference's pipeline env, its state made to end three envs, the
    step after it and an action (one compiled program)."""
    r, t = j_declarative_mdp()
    base = JANYmalEnv(observe="sensors", sensor_delay=0.004, reward_fn=r, termination_fn=t)
    base._fused_sensors = False
    assert base.engine._solver_backend == "xla"
    env = jp.build_pipeline(base, [{"type": "mahony"}, {"type": "stack", "n": 4}])
    action = np.random.default_rng(5).uniform(-1.0, 1.0, (B, 12)).astype(np.float32)

    def program(keys, action):
        st = jax.vmap(env.reset)(keys)
        inner = st.inner.inner
        q = inner.sim.q.at[0, 2].set(0.2)  # below min_height → terminated
        q = q.at[1, 3:7].set(jnp.array([np.sin(0.6), 0.0, 0.0, np.cos(0.6)]))  # tilted 69°
        inner = inner.replace(sim=inner.sim.replace(q=q), steps=inner.steps.at[2].set(999))
        st = st.replace(inner=st.inner.replace(inner=inner))
        return st, jax.vmap(env.step)(st, action)

    # the program compiles in half the time without XLA's optimizations
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        st, nxt = jax.jit(program)(jax.random.split(jax.random.PRNGKey(7), B),
                                   jnp.asarray(action))
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    return _arrays(st), _arrays(nxt), action


def _close_obs(port, ref):
    """obs 1e-4, the scaled accelerometer (columns 6:9 of each 37-wide
    frame) 2e-3."""
    accel = np.zeros(port.shape[-1], bool)
    for k in range(port.shape[-1] // 37):
        accel[37 * k + 6:37 * k + 9] = True
    p, r = port.numpy(), np.asarray(ref)
    np.testing.assert_allclose(p[..., ~accel], r[..., ~accel], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p[..., accel], r[..., accel], atol=2e-3, rtol=0)


def test_pipeline_step_matches_reference():
    jst, jnext, action = _reference_slice()
    r, t = anymal_declarative_mdp()
    env = build_pipeline(ANYmalEnv(observe="sensors", sensor_delay=0.004, reward_fn=r,
                                   termination_fn=t, device="cpu"),
                         [{"type": "mahony"}, {"type": "stack", "n": 4}])
    st = wrapper_state_from_arrays(env, jst, torch.Generator().manual_seed(0))
    assert st.obs.shape == (B, 148) and st.inner.layer["quat"].shape == (B, 4)
    _close_obs(st.obs, jst["obs"])
    nxt = env.step(st, torch.as_tensor(action))
    term, trunc = jnext["inner"]["inner"]["terminated"], jnext["inner"]["inner"]["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3] or trunc[3])
    np.testing.assert_array_equal(nxt.terminated.numpy(), term)
    np.testing.assert_array_equal(nxt.truncated.numpy(), trunc)
    np.testing.assert_allclose(nxt.reward.numpy(), jnext["inner"]["inner"]["reward"], atol=1e-4)
    # the terminal observations, before the reset, of every env
    _close_obs(nxt.info["final_obs"], jnext["info"]["final_obs"])
    # the env that goes on: its observation and layers
    _close_obs(nxt.obs[3:], jnext["obs"][3:])
    np.testing.assert_allclose(nxt.layer[3].numpy(), jnext["layer"][3], atol=2e-3)
    for k in ("quat", "bias"):
        np.testing.assert_allclose(nxt.inner.layer[k][3].numpy(), jnext["inner"]["layer"][k][3],
                                   atol=1e-4)
    # the finished ones restarted: the filter from identity, the FIFO empty
    # behind the fresh observation
    assert not nxt.layer[:3, 1:].any()
    torch.testing.assert_close(nxt.obs[:3, :37], nxt.inner.obs[:3], atol=0, rtol=0)


@pytest.fixture(scope="module")
def sensors_run5():
    from jiminy_tpu.checkpoint import restore_raw as j_restore_raw

    raw = j_restore_raw(REPO / "artifacts" / "anymal_sensors_run5" / "ckpt")
    return raw[0] if isinstance(raw, (list, tuple)) else raw["0"]


def test_sensor_artifact_walks_the_port_pipeline(sensors_run5):
    params = policy_params_from_arrays(sensors_run5)
    env = build_pipeline(ANYmalEnv(observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                                   encoder_noise=0.005, device="cpu"),
                         [{"type": "mahony"}, {"type": "stack", "n": 4}])
    pol = MLPPolicy(env.observation_size, env.action_size, hidden=(256, 256))
    assert env.observation_size == 148 == params["actor"][0][0].shape[0]
    n_steps = 100
    stats = evaluate(env, greedy_policy(pol, params), n_envs=16, n_steps=n_steps,
                     generator=torch.Generator().manual_seed(0))
    speed = stats["forward_displacement_mean"] / (n_steps * env.unwrapped.step_dt)
    assert stats["fall_fraction"] == 0.0 and stats["alive_at_end"] == 1.0, stats
    assert 0.70 <= speed <= 0.85, stats


def test_cartpole_artifact_evaluates_through_frozen_statistics():
    from jiminy_tpu.checkpoint import restore_raw as j_restore_raw
    from jiminy_tpu.envs import CartPoleEnv as JCartPoleEnv

    raw = j_restore_raw(REPO / "artifacts" / "cartpole_pipeline_run" / "ckpt")
    layers = [{"type": "stack", "n": 4}, {"type": "normalize"}]
    jfrozen = jp.freeze_pipeline_stats(jp.build_pipeline(JCartPoleEnv(), layers), raw[2])
    env = freeze_pipeline_stats(build_pipeline(CartPoleEnv(device="cpu"), layers), raw[2])
    for k in ("mean", "var"):
        # the batch mean of the per-env statistics, rounded once (the
        # reference's float32 sum lands up to 2 ulp from it)
        exact = np.asarray(raw[2]["layer"][k], np.float64).mean(0)
        np.testing.assert_allclose(env.stats[k].numpy(), exact, atol=1e-7, rtol=0)
        np.testing.assert_allclose(env.stats[k].numpy(), np.asarray(jfrozen.stats[k]), atol=1e-7,
                                   rtol=2.4e-7)
    params = policy_params_from_arrays(raw[0])
    pol = MLPPolicy(env.observation_size, 2, discrete=True, hidden=(256, 256))
    stats = evaluate(env, greedy_policy(pol, params), n_envs=16, n_steps=100,
                     generator=torch.Generator().manual_seed(0))
    assert stats["alive_at_end"] == 1.0 and stats["length_mean"] == 100, stats


def test_gym_adapter_and_registry():
    gymnasium = pytest.importorskip("gymnasium")
    from jiminy_tpu.envs import CartPoleEnv as JCartPoleEnv
    from jiminy_tpu.envs.gym_adapter import make_gym_env as j_make_gym_env
    from jiminy_tpu_torch.envs import register_envs
    from jiminy_tpu_torch.envs.gym_adapter import make_gym_env

    ids = register_envs()
    assert "jiminy_tpu_torch/ANYmal-v0" in ids and register_envs() == ids
    env = gymnasium.make("jiminy_tpu_torch/CartPole-v0", device="cpu", seed=3)
    ref = j_make_gym_env(JCartPoleEnv())
    assert env.action_space == ref.action_space
    assert env.observation_space == ref.observation_space
    obs, _ = env.reset(seed=1)
    assert obs.shape == (4,) and obs.dtype == np.float32
    again, _ = env.reset(seed=1)
    np.testing.assert_array_equal(obs, again)
    for _ in range(3):
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
    assert obs.shape == (4,) and reward == 1.0 and not (terminated or truncated)
    with pytest.raises(NotImplementedError, match="A.19"):
        env.unwrapped.render()
    walker = make_gym_env(build_pipeline(CartPoleEnv(continuous=True, device="cpu"),
                                         [{"type": "stack", "n": 2}]))
    assert walker.action_space.shape == (1,) and walker.observation_space.shape == (8,)
    walker.reset()
    assert walker.step(np.array([0.5], np.float32))[0].shape == (8,)


def test_wrappers_expose_only_the_reference_metadata():
    base = ANYmalEnv(observe="sensors", device="cpu")
    env = build_pipeline(base, [{"type": "mahony"}, {"type": "stack", "n": 4}])
    assert hasattr(base, "symmetry_fn") and not hasattr(env, "symmetry_fn")
    assert (env.action_size, env.discrete_actions, env.observation_size) == (12, None, 148)
    assert env.unwrapped is base and env.device == base.device
    assert env.termination_meaning == "failure"
    with pytest.raises(ValueError, match="IMU"):
        build_pipeline(ANYmalEnv(observe="state", device="cpu"), [{"type": "mahony"}])


def test_checkpoint_round_trips_a_pipeline_carry(tmp_path):
    from jiminy_tpu_torch.rl import PPOConfig
    from jiminy_tpu_torch.rl.networks import param_leaves
    from jiminy_tpu_torch.rl.ppo import make_train_fn

    env = build_pipeline(CartPoleEnv(device="cpu"), [{"type": "stack", "n": 4},
                                                     {"type": "normalize"}])
    cfg = PPOConfig(num_envs=4, rollout_len=4, minibatches=2, epochs=1, hidden=(8, 8))
    init_fn, train_step, _ = make_train_fn(env, cfg)
    carry, _ = train_step(init_fn(0, 4))
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, carry)
    back = mgr.restore(carry)

    def leaves(x):
        if isinstance(x, (pp.WrapperState, EnvState, SimState)):
            return leaves(vars(x))
        if isinstance(x, dict):
            return [y for k in sorted(x) for y in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in leaves(v)]
        if isinstance(x, torch.Generator):
            return [x.get_state()]
        return [x] if torch.is_tensor(x) else []

    assert isinstance(back[2], pp.WrapperState) and isinstance(back[2].inner.inner, EnvState)
    got, want = leaves(back), leaves(carry)
    assert len(got) == len(want) > 20
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(back[0]), param_leaves(carry[0])))
    raw = restore_raw(tmp_path / "ckpt")
    frozen = freeze_pipeline_stats(env, raw[2])
    torch.testing.assert_close(frozen.stats["mean"], carry[2].layer["mean"].double().mean(0).float(),
                               atol=0, rtol=0)


def test_train_and_evaluate_a_pipeline(tmp_path, monkeypatch, capsys):
    from jiminy_tpu_torch.tools import evaluate as tool_evaluate
    from jiminy_tpu_torch.tools import train as tool_train

    assert tool_train.parse_pipeline("mahony,stack:4") == [{"type": "mahony"},
                                                           {"type": "stack", "n": 4}]
    assert tool_train.parse_pipeline("stack,normalize") == [{"type": "stack", "n": 4},
                                                            {"type": "normalize"}]
    run = tmp_path / "run"
    args = ["--env", "cartpole", "--pipeline", "stack:4,normalize", "--max-steps", "3",
            "--device", "cpu"]
    env, carry, stats = tool_train.main(args + ["--iters", "1", "--num-envs", "2", "--out",
                                                str(run)])
    assert env.observation_size == 16 and isinstance(carry[2], pp.WrapperState)
    assert stats["length_mean"] <= 2.0
    monkeypatch.setattr(sys, "argv", ["evaluate", "--run", str(run), "--n-envs", "4",
                                      "--n-steps", "2", "--out", str(tmp_path / "s.json")]
                        + args)
    tool_evaluate.main()
    assert json.loads((tmp_path / "s.json").read_text())["length_mean"] == 2.0
    assert "return_mean" in capsys.readouterr().out
