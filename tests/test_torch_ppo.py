"""The port's PPO (``jiminy_tpu_torch.rl.ppo``) against jiminy_tpu's.

- ``_gae`` on seeded (T, B) trajectories with terminations and
  truncations (float64 against the widened reference, 1e-12; float64
  against the reference as it is and float32, 1e-6), and the reference's own
  three cases (tests/test_ppo.py: a hand-rolled recursion, termination
  cutting the bootstrap, truncation bootstrapping V(final_obs)).
- A whole ``train_step`` from the same params and Adam state on a tiny
  linear env (a point in R⁴ pushed by a clipped 2-D action, reward for
  staying near the origin, terminated past |x₀| > 0.6, truncated after 6
  steps, reset to one fixed point), written once in JAX for the
  reference and once in torch for the port. The reference's key splits
  (``ppo.py``: the iteration's ``k_roll, k_perm``, each rollout step's
  ``k_act``, each epoch's permutation key) give its action noise (T, B,
  A) and permutations (epochs, n), which the port takes as tensors. With
  ``symmetry_coef``, ``l2_reg``, ``anneal_lr`` and ``anneal_ent`` off,
  and again all on (a mirror of the toy env; iteration 3 of 5 for the
  entropy schedule), over 2 epochs × 2 minibatches: the params, Adam's
  moments and count and every metric agree in float64 (x64 on, the
  reference widened to float64: :func:`_widen_reference`) within 1e-9
  (all off: ~1e-16; all on: ~2e-10, from optax's learning-rate schedule,
  which is float32 under x64 too: its count is int32 and int32 / int is
  float32) and in float32 within 1e-4 (~1e-7). float32 holds 1e-4:
  Adam's first steps are sign-like (m̂/√v̂ ≈ ±1), but its eps of 1e-5
  keeps a gradient near 0, where the two packages' rounding could flip
  the sign, from a step of the size lr.
- Learning: the port's ``train`` on the toy env raises ``reward_mean``
  over 30 iterations (the counterpart of ``test_cartpole_improves``,
  whose env is ROADMAP A.16).
- ANYmal: one ``train_step`` at B = 8, rollout 4, on
  ``ANYmalEnv(observe="state", device="cpu")`` with the symmetry loss
  runs and its params are finite; ``ANYmalEnv.mirror_spec`` and
  ``symmetry_fn`` are the reference's on the same arrays; ``rollout``
  equals as many calls of ``step``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.rl import ppo as j_ppo
from jiminy_tpu_torch.rl import PPOConfig, make_train_fn, policy_params_from_arrays, train
from jiminy_tpu_torch.rl.networks import param_leaves
from jiminy_tpu_torch.rl.ppo import _gae, adam_init

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

# ---- the toy env: x' = A x + 0.3·Bm·clip(a, −1, 1)
OBS, ACT, MAX_STEPS = 4, 2, 6
A_MAT = np.array([[0.9, 0.1, 0.0, 0.0], [0.0, 0.9, 0.1, 0.0],
                  [0.0, 0.0, 0.9, 0.1], [0.1, 0.0, 0.0, 0.9]])
B_MAT = np.array([[1.0, 0.0], [0.0, 1.0], [0.5, -0.5], [-0.3, 0.6]])
X0 = np.array([0.3, -0.2, 0.1, 0.0])
OBS_SIGN = np.array([1.0, -1.0, 1.0, -1.0])


class JToyState(NamedTuple):
    obs: jax.Array
    reward: jax.Array
    terminated: jax.Array
    truncated: jax.Array
    done: jax.Array
    steps: jax.Array
    info: dict


class JToyEnv:
    """The toy env for the reference (one env; the reference vmaps it)."""

    discrete_actions = None
    action_size = ACT
    observation_size = OBS

    def __init__(self, dtype):
        self.dt = dtype

    def reset(self, key):
        x0 = jnp.asarray(X0, self.dt)
        z = jnp.zeros((), self.dt)
        return JToyState(x0, z, jnp.bool_(False), jnp.bool_(False), jnp.bool_(False),
                         jnp.int32(0), {"final_obs": x0})

    def step(self, state, a):
        x = jnp.asarray(A_MAT, self.dt) @ state.obs + 0.3 * (
            jnp.asarray(B_MAT, self.dt) @ jnp.clip(a, -1.0, 1.0))
        reward = 1.0 - jnp.sum(x * x) - 0.01 * jnp.sum(a * a)
        steps = state.steps + 1
        terminated = jnp.abs(x[0]) > 0.6
        truncated = steps >= MAX_STEPS
        done = terminated | truncated
        fresh = self.reset(None)
        return JToyState(jnp.where(done, fresh.obs, x), reward, terminated, truncated, done,
                         jnp.where(done, 0, steps), {"final_obs": x})


def j_mirror(obs, action):
    return (obs * jnp.asarray(OBS_SIGN, obs.dtype),
            None if action is None else action[..., ::-1] * jnp.asarray([-1.0, 1.0], action.dtype))


@dataclasses.dataclass
class ToyState:
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    steps: torch.Tensor
    generator: torch.Generator
    info: dict

    @property
    def done(self):
        return self.terminated | self.truncated


class ToyEnv:
    """The toy env for the port (batched)."""

    discrete_actions = None
    action_size = ACT
    observation_size = OBS
    device = torch.device("cpu")

    def __init__(self, dtype):
        self.dt = dtype
        self.A, self.Bm, self.x0 = (torch.as_tensor(x, dtype=dtype) for x in (A_MAT, B_MAT, X0))

    def reset(self, generator, batch_size):
        obs = self.x0.expand(batch_size, OBS).clone()
        z = torch.zeros(batch_size, dtype=torch.bool)
        return ToyState(obs, torch.zeros(batch_size, dtype=self.dt), z, z,
                        torch.zeros(batch_size, dtype=torch.int32), generator, {"final_obs": obs})

    def step(self, state, a):
        x = state.obs @ self.A.T + 0.3 * (torch.clamp(a, -1.0, 1.0) @ self.Bm.T)
        reward = 1.0 - torch.sum(x * x, -1) - 0.01 * torch.sum(a * a, -1)
        steps = state.steps + 1
        terminated = x[:, 0].abs() > 0.6
        truncated = steps >= MAX_STEPS
        done = (terminated | truncated)[:, None]
        return ToyState(torch.where(done, self.x0, x), reward, terminated, truncated,
                        torch.where(done[:, 0], 0, steps), state.generator, {"final_obs": x})


def t_mirror(obs, action):
    return (obs * torch.as_tensor(OBS_SIGN, dtype=obs.dtype),
            None if action is None else action.flip(-1) * torch.tensor([-1.0, 1.0],
                                                                       dtype=action.dtype))


def _widen_reference(monkeypatch):
    """The reference's PPO with its float32 casts made float64: under x64
    it still casts the GAE masks, the entropy schedule and its packed
    minibatch matrix (``ppo.py:61-62``, ``:193-197``, ``:233``; the packing
    works around a TPU gather miscompile) to float32, which rounds every
    minibatch field to float32. Its module's ``jnp`` is handed a
    ``float32`` that is float64 (the counterpart of giving the physics
    reference a float64 copy of its model, ROADMAP C.3)."""

    class Wide:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    monkeypatch.setattr(j_ppo, "jnp", Wide())


# ---- GAE
def _traj(seed, T=7, Bt=5):
    rng = np.random.default_rng(seed)
    terminated = rng.uniform(size=(T, Bt)) < 0.2
    return {
        "reward": rng.standard_normal((T, Bt)),
        "terminated": terminated,
        "done": terminated | (rng.uniform(size=(T, Bt)) < 0.2),
        "value": rng.standard_normal((T, Bt)),
        "final_value": rng.standard_normal((T, Bt)),
    }


@pytest.mark.parametrize("dtype,widened,tol", [
    ("float64", True, 1e-12), ("float64", False, 1e-6), ("float32", False, 1e-6)])
def test_gae_matches_reference(dtype, widened, tol, monkeypatch):
    """Against the reference as it is, its masks float32 under x64 too
    (``ppo.py:61-62``: γ·(1 − terminated) carries float32's γ), within
    1e-6; widened to float64 (:func:`_widen_reference`), within 1e-12."""
    if widened:
        _widen_reference(monkeypatch)
    traj = _traj(0)
    assert traj["terminated"].any() and (traj["done"] & ~traj["terminated"]).any()
    jax.config.update("jax_enable_x64", dtype == "float64")  # the conftest fixture restores it
    jt = {k: jnp.asarray(v, dtype if v.dtype.kind == "f" else bool) for k, v in traj.items()}
    tt = {k: torch.as_tensor(v, dtype=getattr(torch, dtype) if v.dtype.kind == "f" else torch.bool)
          for k, v in traj.items()}
    for got, want in zip(_gae(tt, 0.99, 0.95), j_ppo._gae(jt, 0.99, 0.95)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_gae_reference_cases():
    def t(**kw):
        return {k: torch.as_tensor(v) for k, v in kw.items()}

    T = 4
    adv, ret = _gae(t(reward=torch.ones(T, 1), terminated=torch.zeros(T, 1, dtype=torch.bool),
                      done=torch.zeros(T, 1, dtype=torch.bool), value=torch.zeros(T, 1),
                      final_value=torch.full((T, 1), 2.0)), 0.9, 0.8)
    delta, acc, expect = 1.0 + 0.9 * 2.0, 0.0, []
    for _ in range(T):
        acc = delta + 0.9 * 0.8 * acc
        expect.append(acc)
    np.testing.assert_allclose(adv[:, 0].numpy(), expect[::-1], rtol=1e-6)
    torch.testing.assert_close(ret, adv)
    adv, _ = _gae(t(reward=torch.ones(2, 1), terminated=torch.tensor([[True], [False]]),
                    done=torch.tensor([[True], [False]]), value=torch.zeros(2, 1),
                    final_value=torch.full((2, 1), 5.0)), 0.9, 0.8)
    assert float(adv[0, 0]) == 1.0  # terminated: no bootstrap, nothing from t = 1
    assert abs(float(adv[1, 0]) - (1.0 + 0.9 * 5.0)) < 1e-6
    adv, _ = _gae(t(reward=torch.zeros(1, 1), terminated=torch.zeros(1, 1, dtype=torch.bool),
                    done=torch.ones(1, 1, dtype=torch.bool), value=torch.zeros(1, 1),
                    final_value=torch.full((1, 1), 3.0)), 0.5, 0.9)
    assert abs(float(adv[0, 0]) - 1.5) < 1e-6  # truncated: γ·V(final_obs)


# ---- a whole train_step against the reference's
NB, T_ROLL = 8, 4
OFF = dict(num_envs=NB, rollout_len=T_ROLL, epochs=2, minibatches=2, hidden=(16, 16),
           lr=3e-3, ent_coef=0.01, total_iters=5)
ON = dict(OFF, symmetry_coef=0.5, l2_reg=1e-3, anneal_lr=True, anneal_ent=True)


def _reference_draws(key, cfg):
    """The reference train_step's draws from its carry's key."""
    _, k_roll, k_perm = jax.random.split(key, 3)
    noise = []
    for _ in range(cfg.rollout_len):
        k_roll, k_act = jax.random.split(k_roll)
        noise.append(jax.random.normal(k_act, (cfg.num_envs, ACT)))
    n = cfg.num_envs * cfg.rollout_len
    perms = [jax.random.permutation(k, n) for k in jax.random.split(k_perm, cfg.epochs)]
    return np.stack([np.asarray(x) for x in noise]), np.stack([np.asarray(p) for p in perms])


def _run_both(kw, dtype, it):
    jax.config.update("jax_enable_x64", dtype == "float64")  # the conftest fixture restores it
    tdt = getattr(torch, dtype)
    jcfg, cfg = j_ppo.PPOConfig(**kw), PPOConfig(**kw)
    sym = kw.get("symmetry_coef", 0.0) > 0
    jenv, env = JToyEnv(getattr(jnp, dtype)), ToyEnv(tdt)
    j_init, j_step, _ = j_ppo.make_train_fn(jenv, jcfg, symmetry_fn=j_mirror if sym else None)
    jcarry = j_init(jax.random.PRNGKey(0), NB)
    jcarry = (*jcarry[:4], jnp.int32(it))
    noise, perms = _reference_draws(jcarry[3], jcfg)
    jout, jmetrics = jax.jit(j_step)(jcarry)
    init_fn, train_step, _ = make_train_fn(env, cfg, symmetry_fn=t_mirror if sym else None)
    params = policy_params_from_arrays(jax.tree.map(np.asarray, jcarry[0]), dtype=tdt)
    carry = (params, adam_init(params), env.reset(torch.Generator(), NB), torch.Generator(), it)
    out, metrics = train_step(carry, noise=torch.as_tensor(noise, dtype=tdt),
                              perms=torch.as_tensor(perms))
    return jout, jmetrics, out, metrics


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("options", ["off", "on"])
def test_train_step_matches_reference(options, dtype, monkeypatch):
    if dtype == "float64":
        _widen_reference(monkeypatch)
    kw = ON if options == "on" else OFF
    jout, jmetrics, out, metrics = _run_both(kw, dtype, it=3 if options == "on" else 0)
    tol = 1e-9 if dtype == "float64" else 1e-4
    want = [np.asarray(x) for x in jax.tree.leaves(jout[0])]
    got = [x.numpy() for x in param_leaves(out[0])]
    assert len(got) == len(want) == 13 and got[0].dtype == np.dtype(dtype)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    adam = jout[1][1][0]
    assert int(adam.count) == int(out[1]["count"]) == 4
    for k in ("mu", "nu"):
        for g, w in zip(out[1][k], jax.tree.leaves(getattr(adam, k))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=tol, atol=tol, err_msg=k)
    # the rollout saw both ends of an episode
    assert 0.0 < float(metrics["episode_done_frac"]) < 1.0
    assert out[4] == jout[4]


def test_train_raises_reward_on_the_toy_env():
    cfg = PPOConfig(num_envs=64, rollout_len=8, minibatches=4, epochs=4, hidden=(32, 32),
                    lr=3e-3, ent_coef=0.0)
    params, policy, hist = train(ToyEnv(torch.float32), cfg, seed=0, num_iters=30)
    r = hist["reward_mean"].numpy()
    assert r[-5:].mean() > r[:5].mean() + 0.1, r
    assert all(bool(torch.isfinite(x).all()) for x in param_leaves(params))


def test_anymal_train_step_and_mirror():
    from jiminy_tpu.envs import ANYmalEnv as JANYmalEnv
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(observe="state", device="cpu")
    jenv = JANYmalEnv(observe="state")
    for got, want in zip(env.mirror_spec(), jenv.mirror_spec()):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((5, 33)).astype(np.float32)
    act = rng.standard_normal((5, 12)).astype(np.float32)
    for got, want in zip(env.symmetry_fn(torch.as_tensor(obs), torch.as_tensor(act)),
                         jenv.symmetry_fn(jnp.asarray(obs), jnp.asarray(act))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert env.symmetry_fn(torch.as_tensor(obs), None)[1] is None
    cfg = PPOConfig(num_envs=8, rollout_len=4, minibatches=2, epochs=2, hidden=(64, 64),
                    symmetry_coef=0.1, anneal_lr=True)
    init_fn, train_step, policy = make_train_fn(env, cfg, symmetry_fn=env.symmetry_fn)
    assert (policy.obs_size, policy.action_size) == (33, 12)
    carry = init_fn(0, 8)
    carry, metrics = train_step(carry)
    assert all(bool(torch.isfinite(x).all()) for x in param_leaves(carry[0]))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(carry[1]["count"]) == 4 and carry[4] == 1
    # rollout: step through a fixed action sequence, as T calls of step
    actions = torch.rand(3, 8, 12, generator=torch.Generator().manual_seed(1)) * 2 - 1
    gen = torch.Generator()
    gen.set_state(carry[2].generator.get_state())
    final, traj = env.rollout(carry[2].replace(generator=gen), actions)
    st = carry[2]
    for t in range(3):
        st = env.step(st, actions[t])
        for k in ("obs", "reward", "terminated", "truncated"):
            assert torch.equal(traj[k][t], getattr(st, k)), k
    assert torch.equal(final.sim.q, st.sim.q)
