"""Checkpoint-restart across ranks (``jiminy_tpu_torch.checkpoint`` inside
a ``torch.distributed`` group), the counterpart of jiminy_tpu's
tests/test_recovery.py (a restarted 2-process cluster continues bit for
bit like an uninterrupted run; Orbax checkpoint-restart is the
reference's recovery unit).

Two rings of 2 gloo processes (``launch_cpu_ring``) train
``tests/test_torch_ppo.py``'s toy env through ``make_distributed_train``
(8 envs global, rollout 4, 2 epochs × 2 minibatches, float32), its state
held as the port's ``EnvState`` (what a checkpoint stores). Every rank
holds its own env rows and generators, so a checkpoint must keep each
rank's part:

- the first ring runs 4 uninterrupted ``train_step`` s; a second run of 2
  is saved to one file (``save_checkpoint``) and through a
  ``CheckpointManager`` (``max_to_keep=2``, steps 0, 1, 2), restored at
  once in the same ring, and read whole by ``restore_raw``; two saves of
  step 3 are abandoned (one rank's state cannot be encoded; rank 0's
  rename of the written file fails), and one iteration of the cartpole env is saved
  for ``tools/evaluate.py``;
- between the rings, the test's own process (no group) runs one
  single-device iteration and saves it (a checkpoint of one process);
- a second ring, in fresh processes, restores the file, the manager's
  newest step and the same with ``partial=True``, each into a template
  from another seed, and runs 2 more iterations; it restores the
  one-process checkpoint at world size 2 (twice), saves that re-sharded
  carry, restores it and runs 2 iterations from each.

Without a process group (world size 1): ``restore_checkpoint`` and the
manager (``partial`` too) restore the 2-rank checkpoint as the
single-device run from rank 0's generators, rows that do not divide
among the ranks raise ``ValueError``, ``restore_raw`` returns the global
carry, and ``tools/evaluate.py --run`` evaluates the 2-rank run. Every
env that PPO trains holds only per-env rows in its state (what the
re-shard splits).
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jiminy_tpu_torch.checkpoint import (CheckpointManager, _parts, restore_checkpoint,
                                         restore_raw, save_checkpoint)
from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.envs.base import EnvState
from jiminy_tpu_torch.rl import PPOConfig, make_train_fn
from jiminy_tpu_torch.rl.distributed import RANK_SEED_STRIDE
from jiminy_tpu_torch.rl.launch import launch_cpu_ring
from jiminy_tpu_torch.rl.networks import param_leaves
from jiminy_tpu_torch.rl.ppo import PPO
from test_torch_ppo import NB, OFF, ToyEnv

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

W = 2
TESTS = Path(__file__).resolve().parent

COMMON = """
import os
import pickle
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from test_torch_checkpoint_restart import NB, OFF, CkptToyEnv, flat
from jiminy_tpu_torch.checkpoint import (CheckpointManager, restore_checkpoint, restore_raw,
                                         save_checkpoint)
from jiminy_tpu_torch.rl import PPOConfig
from jiminy_tpu_torch.rl.distributed import make_distributed_train

rank = dist.get_rank()
ckpt = {ckpt!r}
init_fn, train_step, _ = make_distributed_train(CkptToyEnv(torch.float32), PPOConfig(**OFF))
out = {{}}


def steps(carry, n):
    for _ in range(n):
        carry, metrics = train_step(carry)
    return carry, metrics
"""

SAVE_RING = COMMON + """
out["uninterrupted"] = flat(*steps(init_fn(0), 4))

carry = init_fn(0)
mgr = CheckpointManager(ckpt + "/run", max_to_keep=2)
mgr.save(0, carry)
carry, _ = steps(carry, 1)
mgr.save(1, carry)
carry, _ = steps(carry, 1)
mgr.save(2, carry)
save_checkpoint(ckpt + "/carry.pt", carry)
out["saved"] = flat(carry)
out["restored_here"] = flat(restore_checkpoint(ckpt + "/carry.pt", init_fn(1)))
out["listed"] = CheckpointManager.steps_in(ckpt + "/run")
raw = restore_raw(ckpt + "/carry.pt")
out["raw_rows"] = raw[2].obs.shape[0]

# two saves of step 3 that do not finish: one rank's state cannot be
# encoded; rank 0's rename of its written file into place fails
out["abandoned"] = []
try:
    mgr.save(3, carry if rank == 0 else (carry, object()))
except RuntimeError as e:
    out["abandoned"].append(str(e))
real_replace = os.replace


def failed_replace(src, dst):
    raise OSError("disk full")


os.replace = failed_replace if rank == 0 else real_replace
try:
    mgr.save(3, carry)
except OSError as e:
    out["abandoned"].append(str(e))
os.replace = real_replace
out["files_after_abandon"] = sorted(p.name for p in Path(ckpt, "run").iterdir())
out["latest_after_abandon"] = CheckpointManager(ckpt + "/run").latest_step

# the cartpole env of tools/train.py, one iteration, for tools/evaluate.py
from jiminy_tpu_torch.tools.train import make_env

cp_init, cp_step, _ = make_distributed_train(
    make_env("cartpole", 10, device="cpu"),
    PPOConfig(num_envs=8, rollout_len=4, minibatches=2, epochs=1, hidden=(16, 16)))
CheckpointManager(ckpt + "/cartpole_run/ckpt").save(1, cp_step(cp_init(0))[0])
with open(ckpt + "/save_rank{{}}.pkl".format(rank), "wb") as f:
    pickle.dump(out, f)
"""

RESTORE_RING = COMMON + """
carry = restore_checkpoint(ckpt + "/carry.pt", init_fn(5))
out["resumed"] = flat(*steps(carry, 2))
mgr = CheckpointManager(ckpt + "/run")
out["latest"] = mgr.latest_step
out["resumed_manager"] = flat(*steps(mgr.restore(init_fn(6)), 2))
out["resumed_partial"] = flat(*steps(mgr.restore(init_fn(7), partial=True), 2))

# the one-process checkpoint re-sharded onto these 2 ranks, restored
# twice; the re-sharded carry saved at world size 2 and restored
single = restore_checkpoint(ckpt + "/single.pt", init_fn(8))
again = restore_checkpoint(ckpt + "/single.pt", init_fn(9))
out["reshard_restored"] = flat(single)
save_checkpoint(ckpt + "/resharded.pt", single)
out["reshard_steps"] = flat(*steps(single, 2))
out["reshard_again"] = flat(*steps(again, 2))
out["reshard_roundtrip"] = flat(*steps(restore_checkpoint(ckpt + "/resharded.pt", init_fn(10)),
                                       2))
with open(ckpt + "/restore_rank{{}}.pkl".format(rank), "wb") as f:
    pickle.dump(out, f)
"""


def _env_state(s):
    """The toy env's state as the port's ``EnvState`` (its sim fields
    zeros)."""
    zero = torch.zeros(s.obs.shape[0], dtype=s.obs.dtype)
    return EnvState(SimState(*(zero for _ in SimState.FIELDS)), s.obs, s.reward, s.terminated,
                    s.truncated, s.steps, s.generator, s.info)


class CkptToyEnv(ToyEnv):
    """``tests/test_torch_ppo.py``'s toy env with ``EnvState`` states."""

    def reset(self, generator, batch_size):
        return _env_state(super().reset(generator, batch_size))

    def step(self, state, a):
        return _env_state(super().step(state, a))


def flat(carry, metrics=None) -> dict:
    """Every leaf of a PPO carry (params, Adam's state, the env state and
    its info, both generators' states, the iteration) and the metrics, as
    numpy arrays."""
    params, opt, st, gen, it = carry
    leaves = {f"param{i}": x for i, x in enumerate(param_leaves(params))}
    leaves["count"] = opt["count"]
    leaves.update({f"{k}{i}": x for k in ("mu", "nu") for i, x in enumerate(opt[k])})
    leaves.update({f"sim.{k}": getattr(st.sim, k) for k in SimState.FIELDS})
    leaves.update({k: getattr(st, k) for k in ("obs", "reward", "terminated", "truncated",
                                                "steps")})
    leaves.update({f"info.{k}": v for k, v in st.info.items()})
    leaves["env_generator"] = st.generator.get_state()
    leaves["run_generator"] = gen.get_state()
    leaves["it"] = torch.tensor(it)
    if metrics is not None:
        leaves.update({f"metric.{k}": v for k, v in metrics.items()})
    return {k: v.detach().numpy().copy() for k, v in leaves.items()}


def _assert_bit_equal(a: dict, b: dict, label: str):
    assert set(a) == set(b), label
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{label}: {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Both rings' outputs, one dict per rank each, and the directory."""
    ckpt = tmp_path_factory.mktemp("restart")
    launch_cpu_ring(W, SAVE_RING.format(tests=str(TESTS), ckpt=str(ckpt)), timeout=240)
    init_fn, train_step, _ = make_train_fn(CkptToyEnv(torch.float32), PPOConfig(**OFF))
    single, _ = train_step(init_fn(4, NB))
    save_checkpoint(ckpt / "single.pt", single)
    outs = {"single": flat(single)}
    launch_cpu_ring(W, RESTORE_RING.format(tests=str(TESTS), ckpt=str(ckpt)), timeout=240)
    for name in ("save", "restore"):
        outs[name] = []
        for r in range(W):
            with open(ckpt / f"{name}_rank{r}.pkl", "rb") as f:
                outs[name].append(pickle.load(f))
    return outs, ckpt


def test_each_rank_restores_what_it_saved(rings):
    outs, _ = rings
    for r, out in enumerate(outs["save"]):
        _assert_bit_equal(out["restored_here"], out["saved"], f"rank {r}")
    a, b = (out["saved"] for out in outs["save"])
    assert not np.array_equal(a["env_generator"], b["env_generator"])  # the ranks' own parts
    assert not np.array_equal(a["obs"], b["obs"])


@pytest.mark.parametrize("how", ["resumed", "resumed_manager", "resumed_partial"])
def test_restart_continues_bit_for_bit(rings, how):
    """4 uninterrupted iterations = 2, save, restore in fresh processes, 2."""
    outs, _ = rings
    for r in range(W):
        _assert_bit_equal(outs["restore"][r][how], outs["save"][r]["uninterrupted"],
                          f"rank {r} {how}")


def test_manager_keeps_the_newest_steps(rings):
    outs, _ = rings
    for r in range(W):
        assert outs["save"][r]["listed"] == [1, 2]
        assert outs["restore"][r]["latest"] == 2


def test_an_abandoned_save_is_never_listed(rings):
    outs, ckpt = rings
    for r, out in enumerate(outs["save"]):
        unencodable, half = out["abandoned"]
        assert "rank 1" in unencodable and "cannot checkpoint" in unencodable, unencodable
        assert "disk full" in half
        assert out["latest_after_abandon"] == 2
        assert out["files_after_abandon"] == ["1.pt", "2.pt"]  # no temporary file left
    assert CheckpointManager.steps_in(ckpt / "run") == [1, 2]
    assert not (ckpt / "run" / "3.pt").exists()


def _steps(train_step, carry, n):
    for _ in range(n):
        carry, metrics = train_step(carry)
    return carry, metrics


@pytest.mark.parametrize("how", ["file", "manager", "partial"])
def test_restore_at_world_size_one_is_the_single_device_run(rings, how):
    """The 2-rank checkpoint restored without a group, 2 iterations: the
    single-device train_step from restore_raw's global carry with rank
    0's generators, bit for bit."""
    _, ckpt = rings
    env, cfg = CkptToyEnv(torch.float32), PPOConfig(**OFF)
    init_fn, train_step, _ = make_train_fn(env, cfg)
    src = ckpt / ("carry.pt" if how == "file" else "run")
    if how == "file":
        carry = restore_checkpoint(src, init_fn(3, NB))
    else:
        carry = CheckpointManager(src).restore(init_fn(3, NB), partial=how == "partial")
    params, opt, st, gens, it = restore_raw(src)
    raw = (params, opt, st.replace(generator=st.generator[0]), gens[0], it)
    _assert_bit_equal(flat(*_steps(train_step, carry, 2)),
                      flat(*_steps(PPO(env, cfg).train_step, raw, 2)), how)


ROWS = ("obs", "reward", "terminated", "truncated", "steps")


def _is_row(key: str) -> bool:
    return key in ROWS or key.startswith(("sim.", "info."))


def test_a_one_process_checkpoint_reshards_onto_two_ranks(rings):
    """Each rank takes its half of the rows and the replicated leaves;
    rank 0 the saved generators, rank 1 ``rank_generators``' (written out
    here); after 2 iterations the params agree, and a second restore
    gives the same bits."""
    outs, _ = rings
    saved, n = outs["single"], NB // W
    run = torch.Generator()
    run.set_state(torch.from_numpy(saved["run_generator"]))
    seed = int(torch.randint(0, 2**62, (), generator=run))
    derived = {k: torch.Generator().manual_seed(seed + i + RANK_SEED_STRIDE).get_state().numpy()
               for k, i in (("env_generator", 1), ("run_generator", 2))}
    for r in range(W):
        got = outs["restore"][r]["reshard_restored"]
        assert set(got) == set(saved)
        for k, v in got.items():
            if _is_row(k):
                want = saved[k][r * n:(r + 1) * n]
            elif k.endswith("_generator"):
                want = saved[k] if r == 0 else derived[k]
            else:
                want = saved[k]
            np.testing.assert_array_equal(v, want, err_msg=f"rank {r}: {k}")
        _assert_bit_equal(outs["restore"][r]["reshard_again"],
                          outs["restore"][r]["reshard_steps"], f"rank {r} restored again")
    a, b = (out["reshard_steps"] for out in outs["restore"])
    for k in a:
        if k.startswith(("param", "mu", "nu", "count", "metric")) or k == "it":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["obs"], b["obs"])


def test_a_resharded_carry_round_trips(rings):
    """The re-sharded carry saved at world size 2, restored and run 2
    iterations: the run from the carry itself, bit for bit."""
    outs, _ = rings
    for r in range(W):
        _assert_bit_equal(outs["restore"][r]["reshard_roundtrip"],
                          outs["restore"][r]["reshard_steps"], f"rank {r}")


@pytest.mark.parametrize("name, saved", [("carry.pt", 2), ("single.pt", 1)])
def test_rows_that_do_not_divide_raise(rings, name, saved):
    _, ckpt = rings
    with pytest.raises(ValueError, match=rf"{NB} env rows, saved by {saved} ranks, do not "
                                         rf"divide among 3 ranks"):
        _parts(ckpt / name, 3)


# every env that tools/train.py builds for PPO, on its paths
TRAINED_ENVS = {
    "anymal": dict(name="anymal"),
    "anymal_sensors": dict(name="anymal", observe="sensors", sensor_delay=0.004,
                           imu_noise=0.02, encoder_noise=0.005),
    "anymal_terrain": dict(name="anymal", observe="sensors", terrain="fourier", push=100.0,
                           push_duration=0.2),
    "anymal_perlin": dict(name="anymal", terrain="perlin"),
    "anymal_sim2real": dict(name="anymal", observe="sensors", terrain="fourier", push=100.0,
                            push_duration=0.2, randomize=0.2),
    "anymal_pipeline": dict(name="anymal", observe="sensors", mdp="declarative"),
    "cassie": dict(name="cassie", observe="sensors", push=50.0),
    "cassie_self_collision": dict(name="cassie", self_collision=True),
    "cassie_flex": dict(name="cassie_flex", observe="sensors"),
    "atlas": dict(name="atlas", observe="sensors", self_collision=True),
    "ant": dict(name="ant"),
    "spotmicro": dict(name="spotmicro"),
    "cartpole": dict(name="cartpole"),
    "acrobot": dict(name="acrobot"),
}


def _tensors(x, where: str = "state"):
    if isinstance(x, torch.Tensor):
        yield where, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), f"{where}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _tensors(v, f"{where}[{i}]")


@pytest.mark.parametrize("label", list(TRAINED_ENVS))
def test_every_env_state_tensor_is_per_env_rows(label):
    """A re-shard splits every env-state tensor of one dim or more by its
    rows: each such tensor of each env that PPO trains (its ``info`` and
    pipeline layers included), after a reset and a step, leads with the
    batch."""
    from jiminy_tpu_torch.envs.pipeline import build_pipeline
    from jiminy_tpu_torch.tools.train import make_env

    kw = dict(TRAINED_ENVS[label])
    env = make_env(kw.pop("name"), 100, device="cpu", **kw)
    if label == "anymal_pipeline":
        env = build_pipeline(env, [{"type": "mahony"}, {"type": "stack", "n": 4},
                                   {"type": "normalize"}])
    b = 3
    state = env.reset(torch.Generator().manual_seed(0), b)
    action = (torch.zeros(b, dtype=torch.long) if env.discrete_actions is not None
              else torch.zeros(b, env.action_size))
    state = env.step(state, action)
    shapes = dict(_tensors(state))
    assert shapes
    for where, x in shapes.items():
        assert x.dim() == 0 or x.shape[0] == b, f"{label}: {where} {tuple(x.shape)}"


def test_restore_raw_is_the_global_carry(rings):
    outs, ckpt = rings
    saved = [out["saved"] for out in outs["save"]]
    assert [out["raw_rows"] for out in outs["save"]] == [NB, NB]
    for raw in (restore_raw(ckpt / "carry.pt"), restore_raw(ckpt / "run")):
        params, opt, st, gens, it = raw
        np.testing.assert_array_equal(st.obs.numpy(), np.concatenate([s["obs"] for s in saved]))
        np.testing.assert_array_equal(st.steps.numpy(),
                                      np.concatenate([s["steps"] for s in saved]))
        assert [g.get_state().numpy().tolist() for g in st.generator] == [
            s["env_generator"].tolist() for s in saved]
        assert [g.get_state().numpy().tolist() for g in gens] == [
            s["run_generator"].tolist() for s in saved]
        np.testing.assert_array_equal(opt["count"].numpy(), saved[0]["count"])
        assert it == 2


def test_evaluate_reads_a_two_rank_run(rings, tmp_path, monkeypatch):
    from jiminy_tpu_torch.tools import evaluate as tool_evaluate

    _, ckpt = rings
    monkeypatch.setattr(sys, "argv", ["evaluate", "--env", "cartpole", "--run",
                                      str(ckpt / "cartpole_run"), "--n-envs", "4", "--n-steps",
                                      "2", "--device", "cpu", "--out", str(tmp_path / "s.json")])
    tool_evaluate.main()
    stats = json.loads((tmp_path / "s.json").read_text())
    assert np.isfinite(stats["return_mean"])
