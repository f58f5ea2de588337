"""The port's policy (``jiminy_tpu_torch.rl.networks``) and ``evaluate``
against jiminy_tpu's.

- ``mlp_apply``, ``value``, ``action_dist``, ``log_prob`` and ``entropy``
  of ``MLPPolicy``, continuous and discrete, on the same seeded params
  (numpy, handed to the reference and through
  ``policy_params_from_arrays`` to the port; biases and ``log_std``
  nonzero) and observations: float32 within 1e-5.
- ``sample`` given the reference's draws (``jax.random.normal`` of the
  key it samples with; for discrete actions ``jax.random.gumbel``, which
  is what ``jax.random.categorical`` adds to the logits) gives the
  reference's action and log-prob.
- ``init_mlp``: orthogonal W at the stated gains (√2 hidden, the output's
  ``out_scale``), zero biases; one seed gives one draw.
- A.7's check: the reference's trained ANYmal policy
  (``artifacts/anymal_run``, restored with the reference's
  ``restore_raw`` as ``examples/evaluate.py`` does, converted) gives the
  reference's mean action on the port env's observations (1e-5) and,
  under the port's ``evaluate`` on ``ANYmalEnv(observe="state",
  device="cpu")`` at B = 32 for 100 steps (2 s), no fall and a forward
  speed of 0.70–0.85 m/s (the run's own 0.79 m/s,
  ``artifacts/README.md``). Statistics, not trajectories: float32
  rollouts part ways between backends (ROADMAP C.2).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.rl.networks import MLPPolicy as JMLPPolicy
from jiminy_tpu.rl.networks import mlp_apply as j_mlp_apply
from jiminy_tpu_torch.envs import ANYmalEnv
from jiminy_tpu_torch.rl import MLPPolicy, evaluate, greedy_policy, policy_params_from_arrays
from jiminy_tpu_torch.rl.networks import init_mlp, mlp_apply

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OBS, ACT, N_DISCRETE, HIDDEN, B = 7, 3, 5, (16, 12), 9
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_params(seed, discrete, container=list):
    """Seeded params as nested numpy arrays, biases and log_std nonzero."""
    rng = np.random.default_rng(seed)
    out_actor = N_DISCRETE if discrete else ACT

    def net(sizes):
        return [container((rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a),
                           0.1 * rng.standard_normal(b).astype(np.float32)))
                for a, b in zip(sizes[:-1], sizes[1:])]

    p = {"actor": net((OBS, *HIDDEN, out_actor)), "critic": net((OBS, *HIDDEN, 1))}
    if not discrete:
        p["log_std"] = (0.3 * rng.standard_normal(ACT)).astype(np.float32)
    return p


def _policies(discrete):
    n = N_DISCRETE if discrete else ACT
    return (JMLPPolicy(OBS, n, discrete=discrete, hidden=HIDDEN),
            MLPPolicy(OBS, n, discrete=discrete, hidden=HIDDEN))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_policy_functions_match_reference(discrete):
    arrays = _np_params(0, discrete, container=tuple if discrete else list)
    jpol, pol = _policies(discrete)
    jp, p = _j(arrays), policy_params_from_arrays(arrays)
    obs = np.random.default_rng(1).standard_normal((B, OBS)).astype(np.float32)
    jo, o = jnp.asarray(obs), torch.as_tensor(obs)
    torch.testing.assert_close(mlp_apply(p["actor"], o), _t(j_mlp_apply(jp["actor"], jo)), **TOL)
    torch.testing.assert_close(pol.value(p, o), _t(jpol.value(jp, jo)), **TOL)
    torch.testing.assert_close(pol.entropy(p, o), _t(jpol.entropy(jp, jo)), **TOL)
    if discrete:
        torch.testing.assert_close(pol.action_dist(p, o), _t(jpol.action_dist(jp, jo)), **TOL)
        action = np.arange(B) % N_DISCRETE
    else:
        for got, want in zip(pol.action_dist(p, o), jpol.action_dist(jp, jo)):
            torch.testing.assert_close(got, _t(want), **TOL)
        action = np.random.default_rng(2).standard_normal((B, ACT)).astype(np.float32)
    torch.testing.assert_close(pol.log_prob(p, o, torch.as_tensor(action)),
                               _t(jpol.log_prob(jp, jo, jnp.asarray(action))), **TOL)


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_sample_with_reference_noise(discrete):
    arrays = _np_params(3, discrete)
    jpol, pol = _policies(discrete)
    jp, p = _j(arrays), policy_params_from_arrays(arrays)
    obs = np.random.default_rng(4).standard_normal((B, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ja, jlogp = jpol.sample(jp, jnp.asarray(obs), key)
    if discrete:  # jax.random.categorical = argmax(logits + gumbel(key, logits.shape))
        noise = jax.random.gumbel(key, (B, N_DISCRETE))
    else:
        noise = jax.random.normal(key, (B, ACT))
    a, logp = pol.sample(p, torch.as_tensor(obs), noise=_t(noise))
    if discrete:
        assert torch.equal(a, _t(ja).long()) and len(set(a.tolist())) > 1
    else:
        torch.testing.assert_close(a, _t(ja), **TOL)
    torch.testing.assert_close(logp, _t(jlogp), **TOL)
    # drawn from a generator instead: the same law, other draws
    a2, logp2 = pol.sample(p, torch.as_tensor(obs), generator=torch.Generator().manual_seed(0))
    assert a2.shape == a.shape and bool(torch.isfinite(logp2).all())
    torch.testing.assert_close(logp2, pol.log_prob(p, torch.as_tensor(obs), a2), **TOL)


def test_init_mlp_is_orthogonal_at_the_stated_gains():
    sizes = (33, 256, 256, 12)
    params = init_mlp(torch.Generator().manual_seed(0), sizes)
    gains = (np.sqrt(2.0), np.sqrt(2.0), 0.01)
    for (W, b), g, (m, n) in zip(params, gains, zip(sizes[:-1], sizes[1:])):
        assert W.shape == (m, n) and W.dtype == torch.float32 and not b.any()
        gram = W @ W.T if m < n else W.T @ W  # orthonormal rows when wide, columns when tall
        torch.testing.assert_close(gram, g * g * torch.eye(min(m, n)), rtol=0, atol=1e-5 * g * g)
    again = init_mlp(torch.Generator().manual_seed(0), sizes)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(params, again))
    pol = MLPPolicy(33, 12)
    p = pol.init(torch.Generator().manual_seed(1))
    assert torch.allclose(p["critic"][-1][0].T @ p["critic"][-1][0], torch.ones(1, 1), atol=1e-5)
    assert not p["log_std"].any() and [W.shape for W, _ in p["actor"]] == [
        (33, 256), (256, 256), (256, 12)]


@pytest.fixture(scope="module")
def anymal_run():
    """``artifacts/anymal_run``'s params, restored on the JAX side."""
    from jiminy_tpu.checkpoint import restore_raw

    raw = restore_raw(REPO / "artifacts" / "anymal_run" / "ckpt")
    return raw[0] if isinstance(raw, (list, tuple)) else raw["0"]


def test_trained_anymal_policy_walks(anymal_run):
    params = policy_params_from_arrays(anymal_run)
    assert [W.shape for W, _ in params["actor"]] == [(33, 256), (256, 256), (256, 12)]
    env = ANYmalEnv(observe="state", device="cpu")
    pol = MLPPolicy(env.observation_size, env.action_size, hidden=(256, 256))
    obs = env.reset(torch.Generator().manual_seed(5), 32).obs
    want = j_mlp_apply(_j(anymal_run["actor"]), jnp.asarray(obs.numpy()))
    torch.testing.assert_close(pol.action_dist(params, obs)[0], _t(want), **TOL)
    n_steps = 100
    stats = evaluate(env, greedy_policy(pol, params), n_envs=32, n_steps=n_steps,
                     generator=torch.Generator().manual_seed(0))
    speed = stats["forward_displacement_mean"] / (n_steps * env.step_dt)
    assert stats["fall_fraction"] == 0.0 and stats["alive_at_end"] == 1.0
    assert stats["length_mean"] == n_steps
    assert 0.70 <= speed <= 0.85, stats
