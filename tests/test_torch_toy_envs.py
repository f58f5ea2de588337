"""The port's cartpole and acrobot envs against jiminy_tpu's, and their
training entry point.

- ``CartPoleEnv`` (10 symplectic-Euler substeps of 2 ms on the
  continuous path) and ``AcrobotEnv`` (RK4, 20 ms substeps, 0.2 s steps):
  two ``step_no_reset`` from the same states and discrete actions as the
  reference's env (float64 on both sides, x64 scoped; the reference's
  engine rebuilt on a float64 copy of its tree), within 1e-9: the state,
  a, τ, the observation, the reward and the termination; states drawn
  near the termination bounds so that some envs end. The draws of a reset
  come from a ``torch.Generator``, so the envs are held given the same
  states, not the same draws: the port's draws are checked for their
  ranges. Continuous actions map to the same commands.
- ``tools/train.py --env cartpole`` for two iterations on the CPU (the
  run's metrics, checkpoint and evaluation), and ``--env acrobot`` builds
  the reference's env (``termination_meaning="success"``).
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.envs.acrobot import AcrobotEnv as JAcrobotEnv
from jiminy_tpu.envs.cartpole import CartPoleEnv as JCartPoleEnv
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS
from jiminy_tpu_torch.envs import AcrobotEnv, CartPoleEnv, env_state_from_arrays
from jiminy_tpu_torch.rl import read_metrics

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
ENVS = {"cartpole": (JCartPoleEnv, CartPoleEnv, 2), "acrobot": (JAcrobotEnv, AcrobotEnv, 3)}


def _states(name, rng):
    """States spread over each env's range, a few near its termination:
    the cartpole's cart near ±2.4 m and pole near ±12°, the acrobot swung
    up near the goal height."""
    if name == "cartpole":
        q = rng.uniform(-0.1, 0.1, (B, 2))
        v = rng.uniform(-0.5, 0.5, (B, 2))
        q[0, 0], v[0, 0] = 2.395, 1.0
        q[1, 1], v[1, 1] = -0.205, -1.0
    else:
        q = rng.uniform(-0.5, 0.5, (B, 2))
        v = rng.uniform(-1.0, 1.0, (B, 2))
        q[0], v[0] = (2.9, 0.3), (1.0, 1.0)
    return q, v


@pytest.mark.parametrize("name", list(ENVS))
def test_env_steps_match_reference(name):
    JEnv, Env, n_act = ENVS[name]
    rng = np.random.default_rng(0)
    q, v = _states(name, rng)
    actions = rng.integers(0, n_act, (2, B))
    with jax.enable_x64(True):
        jenv = JEnv()
        e = jenv.engine
        tree = e.tree.replace(**{k: jnp.asarray(np.asarray(getattr(e.tree, k)), jnp.float64)
                                 for k in ARRAY_FIELDS})
        jenv.engine = JEngine(tree, e.options, ground=e.ground)
        jst = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
        jst = jst.replace(sim=jax.vmap(jenv.engine.reset)(jnp.asarray(q), jnp.asarray(v)),
                          obs=jnp.asarray(jst.obs, jnp.float64))
        jstep = jax.jit(jax.vmap(jenv.step_no_reset))
        wants = []
        for a in actions:
            jst = jstep(jst, jnp.asarray(a))
            wants.append(jax.tree.map(np.asarray, jst))
        jcmd = jax.vmap(lambda a: JEnv(continuous=True)._action_to_command(a, None))(
            jnp.linspace(-1.5, 1.5, B)[:, None])
    env = Env(device="cpu", dtype=torch.float64)
    assert env.engine.backend == "inline" and not env.engine.impulse and env.engine.nc == 0
    assert env.n_substeps == 10 and env.discrete_actions == n_act
    sim = env.engine.reset(torch.as_tensor(q), torch.as_tensor(v))
    start = {"sim": {k: getattr(sim, k).numpy() for k in SIM_FIELDS}, "obs": env._observe(sim),
             "reward": np.zeros(B), "terminated": np.zeros(B, bool),
             "truncated": np.zeros(B, bool), "steps": np.zeros(B, np.int32)}
    st = env_state_from_arrays(start, torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.float64)
    for a, want in zip(actions, wants):
        st = env.step_no_reset(st, torch.as_tensor(a))
        for k in ("t", "q", "v", "a", "tau"):
            np.testing.assert_allclose(getattr(st.sim, k).numpy(), getattr(want.sim, k),
                                       atol=1e-9, rtol=0, err_msg=k)
        np.testing.assert_allclose(st.obs.numpy(), want.obs, atol=1e-9, rtol=0)
        np.testing.assert_allclose(st.reward.numpy(), want.reward, atol=0, rtol=0)
        np.testing.assert_array_equal(st.terminated.numpy(), want.terminated)
    assert want.terminated.any() and not want.terminated.all()
    cont = Env(continuous=True, device="cpu", dtype=torch.float64)
    cmd = cont._action_to_command(torch.linspace(-1.5, 1.5, B, dtype=torch.float64)[:, None], sim)
    np.testing.assert_allclose(cmd.numpy(), np.asarray(jcmd), atol=1e-12, rtol=0)
    # the port's own draws: the reference's ranges
    fresh = env.reset(torch.Generator().manual_seed(1), 256)
    bound = 0.05 if name == "cartpole" else 0.1
    assert float(fresh.sim.q.abs().max()) <= bound and float(fresh.sim.v.abs().max()) <= bound
    assert float(fresh.sim.q.abs().max()) > 0.9 * bound


def test_train_entry_point_on_the_toy_envs(tmp_path, monkeypatch):
    from jiminy_tpu_torch.tools import train as tool_train

    run = tmp_path / "cartpole"
    monkeypatch.setattr(sys, "argv", ["train", "--env", "cartpole", "--iters", "2", "--num-envs",
                                      "8", "--max-steps", "3", "--device", "cpu", "--out",
                                      str(run)])
    tool_train.main()
    assert [r["iter"] for r in read_metrics(run)] == [0.0, 1.0]
    rows = read_metrics(run)
    assert all(np.isfinite(r["reward_mean"]) and r["reward_mean"] == 1.0 for r in rows)
    stats = json.loads((run / "eval.json").read_text())
    assert stats["length_mean"] == 2.0 and "fall_fraction" in stats
    acro = tool_train.make_env("acrobot", 10, device="cpu")
    assert type(acro).__name__ == "AcrobotEnv" and acro.termination_meaning == "success"
    assert acro.max_steps == 500 and acro.engine.options.solver == "runge_kutta_4"
