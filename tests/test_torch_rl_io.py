"""The port's torch checkpoints (``jiminy_tpu_torch.checkpoint``) and
metrics logging (``jiminy_tpu_torch.rl.logging``), after jiminy_tpu's
tests/test_checkpoint.py and tests/test_rl_logging.py.

- A PPO carry on the terrain, push and sensor ANYmal env (its ``info``
  holds the per-env grounds, the push state and the sensor buffers) at B
  = 4, rollout 2, CPU: 2 iterations, save, restore into a template made
  from another seed, 1 more iteration equals 3 straight bit for bit
  (params, Adam's state, the env batch, both generators), and the file
  loads with ``weights_only=True`` (tensors, dicts, lists, numbers).
- ``restore_raw`` without a template; a template of another shape is
  refused.
- ``CheckpointManager`` keeps the newest ``max_to_keep`` steps and
  restores the latest.
- ``MetricsLogger`` round-trips and appends across sessions; wandb is
  gated on its package.
- The entry points ``tools.train`` and ``tools.evaluate`` on the CPU at a
  tiny size: one iteration writes ``metrics.jsonl``, ``ckpt/`` and
  ``eval.json``, and the evaluate tool reads the checkpoint back; the
  envs and options still to port are refused, naming their ROADMAP item;
  ``--env atlas --self-collision`` builds ``examples/train.py``'s Atlas
  (``target_speed=0.3``, its pairs: nc 83).
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

from jiminy_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    restore_raw,
    save_checkpoint,
)
from jiminy_tpu_torch.envs import ANYmalEnv
from jiminy_tpu_torch.envs.base import EnvState
from jiminy_tpu_torch.rl import MetricsLogger, PPOConfig, make_train_fn, read_metrics
from jiminy_tpu_torch.rl.networks import param_leaves

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4


@pytest.fixture(scope="module")
def ppo():
    env = ANYmalEnv(terrain="fourier", push_magnitude=100.0, push_duration=0.2,
                    sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, device="cpu")
    cfg = PPOConfig(num_envs=B, rollout_len=2, minibatches=2, epochs=1, hidden=(16, 16),
                    symmetry_coef=0.1, anneal_lr=True, anneal_ent=True, total_iters=10)
    return make_train_fn(env, cfg, symmetry_fn=env.symmetry_fn)


def _flat(carry) -> list:
    """Every tensor of a carry, and the generators' states, in order."""
    params, opt, st, gen, it = carry
    out = param_leaves(params) + [opt["count"], *opt["mu"], *opt["nu"]]
    out += [getattr(st.sim, k) for k in st.sim.FIELDS]
    out += [st.obs, st.reward, st.terminated, st.truncated, st.steps]
    out += [st.info[k] for k in sorted(st.info)]
    return out + [st.generator.get_state(), gen.get_state(), torch.tensor(it)]


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume_is_exact(ppo, tmp_path):
    init_fn, train_step, _ = ppo
    carry = init_fn(0, B)
    assert {"ground", "push_force", "push_steps_left", "sensor_bufs"} <= set(carry[2].info)
    for _ in range(2):
        carry, _ = train_step(carry)
    save_checkpoint(tmp_path / "carry.pt", carry)
    torch.load(tmp_path / "carry.pt", weights_only=True)  # plain containers and tensors only
    restored = restore_checkpoint(tmp_path / "carry.pt", init_fn(1, B))
    _assert_same(carry, restored)
    _assert_same(carry, restore_raw(tmp_path / "carry.pt"))
    assert isinstance(restored[2], EnvState) and restored[4] == 2
    straight, m1 = train_step(carry)  # advances carry's generators in place
    resumed, m2 = train_step(restored)
    _assert_same(straight, resumed)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    params = init_fn(2, B)
    params[0]["actor"][0][0] = params[0]["actor"][0][0][:-1]
    with pytest.raises(ValueError, match="actor"):
        restore_checkpoint(tmp_path / "carry.pt", params)


def test_manager_rolls_and_restores(ppo, tmp_path):
    init_fn, train_step, _ = ppo
    carry, _ = train_step(init_fn(0, B))
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
    for s in range(4):
        mgr.save(s, carry)
    mgr = CheckpointManager(tmp_path / "run")
    assert mgr.latest_step == 3
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["2.pt", "3.pt"]
    _assert_same(mgr.restore(init_fn(3, B)), carry)
    _assert_same(mgr.restore(init_fn(3, B), step=2), carry)
    _assert_same(restore_raw(tmp_path / "run"), carry)  # the newest step
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(carry)


def test_metrics_jsonl_roundtrip(tmp_path):
    with MetricsLogger(tmp_path / "run") as lg:
        lg.log(0, {"reward_mean": torch.tensor(1.5), "kl": 0.01})
        lg.log(10, {"reward_mean": 2.0, "kl": 0.02})
    rows = read_metrics(tmp_path / "run")
    assert [r["step"] for r in rows] == [0, 10]
    assert rows[0]["reward_mean"] == 1.5 and rows[1]["reward_mean"] == 2.0
    assert all("wall_s" in r for r in rows)


def test_metrics_append_across_sessions(tmp_path):
    lg = MetricsLogger(tmp_path / "run")
    lg.log(0, {"a": 1})
    lg.close()
    lg = MetricsLogger(tmp_path / "run")  # resume: append, don't truncate
    lg.log(1, {"a": 2})
    lg.close()
    assert [r["a"] for r in read_metrics(tmp_path / "run" / "metrics.jsonl")] == [1.0, 2.0]


def test_wandb_gating(tmp_path):
    try:
        import wandb  # noqa: F401

        pytest.skip("wandb installed; gating path not reachable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="wandb"):
        MetricsLogger(tmp_path / "run", use_wandb=True)


def test_train_and_evaluate_entry_points(tmp_path, monkeypatch, capsys):
    from jiminy_tpu_torch.tools import evaluate as tool_evaluate
    from jiminy_tpu_torch.tools import train as tool_train

    run = tmp_path / "run"
    monkeypatch.setattr(sys, "argv", ["train", "--env", "anymal", "--iters", "1", "--num-envs",
                                      "2", "--max-steps", "3", "--device", "cpu", "--out",
                                      str(run)])
    tool_train.main()
    assert [r["iter"] for r in read_metrics(run)] == [0.0]
    assert CheckpointManager(run / "ckpt").latest_step == 1
    stats = json.loads((run / "eval.json").read_text())
    assert stats["length_mean"] <= 2.0 and "forward_displacement_mean" in stats
    monkeypatch.setattr(sys, "argv", ["evaluate", "--run", str(run), "--n-envs", "4",
                                      "--n-steps", "2", "--device", "cpu",
                                      "--out", str(tmp_path / "stats.json")])
    tool_evaluate.main()
    again = json.loads((tmp_path / "stats.json").read_text())
    assert again["length_mean"] == 2.0 and "iter" in capsys.readouterr().out
    for env, cls in (("cartpole", "CartPoleEnv"), ("acrobot", "AcrobotEnv")):
        toy = tool_train.make_env(env, 10, device="cpu")
        assert type(toy).__name__ == cls and toy.discrete_actions in (2, 3)
    atlas = tool_train.make_env("atlas", 10, self_collision=True, device="cpu")
    assert type(atlas).__name__ == "AtlasEnv" and atlas.engine.nc == 83
    assert atlas.target_speed == 0.3 and atlas.observe_mode == "state"
    # the declarative MDP is anymal's (examples/train.py applies it there only)
    decl = tool_train.make_env("anymal", 10, mdp="declarative", device="cpu")
    assert decl._reward_fn is not None and decl._termination_fn is not None
    with pytest.raises(ValueError, match="anymal's"):
        tool_train.make_env("cassie", 10, mdp="declarative", device="cpu")
