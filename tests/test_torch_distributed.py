"""The port's data-parallel PPO (``jiminy_tpu_torch.rl.distributed``,
``rl.launch``) against jiminy_tpu's ``make_distributed_train``.

One ring of 2 gloo processes (``launch_cpu_ring``) runs, on each rank:

- one ``train_step`` of ``tests/test_torch_ppo.py``'s toy env (8 envs
  global, rollout 4, 2 epochs × 2 minibatches) from the reference's
  params, each rank handed its shard's action noise and permutations as
  the reference draws them on shard i (``fold_in(k_roll, i)``,
  ``fold_in(k_perm, i)``), in float64 and in float32. The reference runs
  on a 2-device slice of the conftest's virtual CPU mesh (float64: x64 on,
  widened as ``test_torch_ppo.py`` widens it). Params, Adam's moments and
  count and every metric agree within 1e-9 in float64 and 1e-4 in
  float32, and the two ranks' params are bit-identical;
- ``init_fn``: each rank's shard of 4 envs, params equal on both ranks,
  each rank's generators its own;
- world size 1 (a gloo group of its rank alone): one ``train_step`` from
  ``init_fn(0)`` equals the single-device ``make_train_fn`` step from
  ``init_fn(0, 8)`` bit for bit (params, Adam's state, metrics), the
  generators drawing the noise and permutations;
- the reference's divisibility case (``tests/test_ppo.py``: 17 envs)
  raises ValueError in both packages;
- ``dryrun_multichip(2)`` at the tiny shapes prints a finite
  ``reward_mean``.
"""

from __future__ import annotations

import math
import pickle
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from jiminy_tpu.rl import ppo as j_ppo
from jiminy_tpu.rl.distributed import make_distributed_train as j_make_distributed_train
from jiminy_tpu_torch.rl.launch import launch_cpu_ring
from test_torch_ppo import ACT, NB, OFF, JToyEnv, _widen_reference

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

W = 2
TESTS = Path(__file__).resolve().parent

WORKER = """
import pickle
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from test_torch_ppo import NB, OFF, ToyEnv
from jiminy_tpu_torch.rl import PPOConfig, make_train_fn, policy_params_from_arrays
from jiminy_tpu_torch.rl.distributed import make_distributed_train
from jiminy_tpu_torch.rl.launch import dryrun_multichip
from jiminy_tpu_torch.rl.networks import param_leaves
from jiminy_tpu_torch.rl.ppo import adam_init

rank = dist.get_rank()
with open({inputs!r}, "rb") as f:
    inputs = pickle.load(f)


def arrays(carry, metrics):
    return {{"params": [x.numpy() for x in param_leaves(carry[0])],
            "count": int(carry[1]["count"]),
            "mu": [x.numpy() for x in carry[1]["mu"]], "nu": [x.numpy() for x in carry[1]["nu"]],
            "metrics": {{k: v.numpy() for k, v in metrics.items()}}}}


out = {{}}
cfg = PPOConfig(**OFF)
for dtype in ("float64", "float32"):
    tdt = getattr(torch, dtype)
    init_fn, train_step, _ = make_distributed_train(ToyEnv(tdt), cfg)
    carry = init_fn(0)
    if dtype == "float64":
        out["init"] = {{"batch": carry[2].obs.shape[0],
                       "params": [x.numpy() for x in param_leaves(carry[0])],
                       "run_gen": carry[3].get_state().numpy(),
                       "env_gen": carry[2].generator.get_state().numpy()}}
    d = inputs[dtype]
    params = policy_params_from_arrays(d["params"], dtype=tdt)
    carry = (params, adam_init(params), carry[2], carry[3], 0)
    carry, metrics = train_step(carry, noise=torch.as_tensor(d["noise"][rank], dtype=tdt),
                                perms=torch.as_tensor(d["perms"][rank]))
    out[dtype] = arrays(carry, metrics)

# world size 1: a group of this rank alone against the single-device step
groups = [dist.new_group([r]) for r in range({w})]
init_fn, train_step, _ = make_distributed_train(ToyEnv(torch.float64), cfg, group=groups[rank])
s_init, s_step, _ = make_train_fn(ToyEnv(torch.float64), cfg)
out["solo"] = [arrays(*train_step(init_fn(0))), arrays(*s_step(s_init(0, NB)))]

try:
    make_distributed_train(ToyEnv(torch.float64), PPOConfig(num_envs=17))
    out["raises"] = None
except ValueError as e:
    out["raises"] = str(e)
dryrun_multichip({w}, device="cpu")
with open({outputs!r}.format(rank), "wb") as f:
    pickle.dump(out, f)
"""


def _shard_draws(key, cfg, i):
    """The reference train_step's draws on shard i (of num_envs / W envs)
    from its carry's key, after its ``fold_in(·, i)``."""
    _, k_roll, k_perm = jax.random.split(key, 3)
    k_roll, k_perm = jax.random.fold_in(k_roll, i), jax.random.fold_in(k_perm, i)
    b = cfg.num_envs // W
    noise = []
    for _ in range(cfg.rollout_len):
        k_roll, k_act = jax.random.split(k_roll)
        noise.append(np.asarray(jax.random.normal(k_act, (b, ACT))))
    n = b * cfg.rollout_len
    perms = [np.asarray(jax.random.permutation(k, n)) for k in jax.random.split(k_perm, cfg.epochs)]
    return np.stack(noise), np.stack(perms)


def _reference(dtype, monkeypatch):
    """The reference's distributed step on a 2-device mesh: (its inputs
    for the port, its carry, its metrics)."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    if dtype == "float64":
        _widen_reference(monkeypatch)
    jcfg = j_ppo.PPOConfig(**OFF)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    j_init, j_step, _ = j_make_distributed_train(JToyEnv(getattr(jnp, dtype)), jcfg, mesh)
    jcarry = j_init(jax.random.PRNGKey(0))
    draws = [_shard_draws(jcarry[3], jcfg, i) for i in range(W)]
    jout, jmetrics = j_step(jcarry)
    inputs = {"params": jax.tree.map(np.asarray, jcarry[0]),
              "noise": [d[0] for d in draws], "perms": [d[1] for d in draws]}
    return inputs, jax.tree.map(np.asarray, jout), {k: float(v) for k, v in jmetrics.items()}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The reference's runs and the ring's outputs, one per rank."""
    tmp = tmp_path_factory.mktemp("ring")
    prev = jax.config.jax_enable_x64
    ref = {}
    try:
        for dtype in ("float64", "float32"):
            with pytest.MonkeyPatch.context() as mp:
                ref[dtype] = _reference(dtype, mp)
        with pytest.raises(ValueError):  # the reference's divisibility check, same mesh
            j_make_distributed_train(JToyEnv(jnp.float32), j_ppo.PPOConfig(num_envs=17),
                                     Mesh(np.array(jax.devices()[:W]), ("data",)))
    finally:
        jax.config.update("jax_enable_x64", prev)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({k: v[0] for k, v in ref.items()}, f)
    logs = launch_cpu_ring(W, WORKER.format(tests=str(TESTS), inputs=str(tmp / "inputs.pkl"),
                                            outputs=str(tmp / "rank{}.pkl"), w=W), timeout=240)
    outs = []
    for r in range(W):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return ref, outs, logs


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_distributed_train_step_matches_reference(ring, dtype):
    ref, outs, _ = ring
    _, jout, jmetrics = ref[dtype]
    tol = 1e-9 if dtype == "float64" else 1e-4
    want = jax.tree.leaves(jout[0])
    adam = jout[1][1][0]
    for r, out in enumerate(outs):
        got = out[dtype]
        assert len(got["params"]) == len(want) == 13 and got["params"][0].dtype == np.dtype(dtype)
        for g, w in zip(got["params"], want):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"rank {r}")
        assert got["count"] == int(adam.count) == 2 * 2
        for k in ("mu", "nu"):
            for g, w in zip(got[k], jax.tree.leaves(getattr(adam, k))):
                np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"rank {r} {k}")
        assert set(got["metrics"]) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(got["metrics"][k]), v, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {k}")
        assert 0.0 < float(got["metrics"]["episode_done_frac"]) < 1.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ranks_are_bit_identical(ring, dtype):
    _, outs, _ = ring
    a, b = (out[dtype] for out in outs)
    for k in ("params", "mu", "nu"):
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    for k in a["metrics"]:
        np.testing.assert_array_equal(a["metrics"][k], b["metrics"][k], err_msg=k)


def test_init_shards_the_batch(ring):
    _, outs, _ = ring
    a, b = (out["init"] for out in outs)
    assert a["batch"] == b["batch"] == NB // W
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a["run_gen"], b["run_gen"])
    assert not np.array_equal(a["env_gen"], b["env_gen"])


def test_world_size_one_is_the_single_device_step(ring):
    _, outs, _ = ring
    for out in outs:
        dist_out, solo = out["solo"]
        for k in ("params", "mu", "nu"):
            for x, y in zip(dist_out[k], solo[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert dist_out["count"] == solo["count"] == 4
        assert set(dist_out["metrics"]) == set(solo["metrics"])
        for k in solo["metrics"]:
            np.testing.assert_array_equal(dist_out["metrics"][k], solo["metrics"][k], err_msg=k)


def test_divisibility_is_checked(ring):
    _, outs, _ = ring
    for out in outs:
        assert out["raises"] is not None and "num_envs=17" in out["raises"]


def test_dryrun_multichip_tiny(ring):
    _, _, logs = ring
    m = re.search(r"dryrun_multichip\(2, tiny\): ok, reward_mean=(\S+)", logs[0])
    assert m is not None, logs[0]
    assert math.isfinite(float(m.group(1)))
