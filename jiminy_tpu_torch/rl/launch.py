"""Process-group bring-up, the N-process ring and the multi-rank dry run.

Counterpart of ``jiminy_tpu/rl/launch.py`` and of
``__graft_entry__.py``'s ``dryrun_multichip``. Every rank runs the same
program in its own process; the group is ``torch.distributed``'s:

- :func:`initialize_cluster` starts it from explicit arguments or from
  the environment (``JIMINY_TPU_COORDINATOR`` host:port,
  ``JIMINY_TPU_NPROCS``, ``JIMINY_TPU_PROC_ID``, ``JIMINY_TPU_BACKEND``);
  one process without a coordinator takes a free port on localhost.
  NCCL (the default) puts rank r on GPU r mod the GPUs present; NCCL
  takes one rank per GPU, so one card runs world size 1;
- :func:`global_group` is the group of every rank (the reference's
  ``global_mesh``);
- :func:`launch_cpu_ring` runs N local processes on gloo, each starting
  the group and running a worker's source: the multi-rank check without
  several GPUs (its workers choose their device: the CPU, or all one
  card);
- :func:`dryrun_multichip` runs one PPO train step on ANYmal across the
  ranks of the running group, at the reference's tiny or realistic
  shapes.
"""

from __future__ import annotations

import math
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_cluster(coordinator: str | None = None, num_processes: int | None = None,
                       process_id: int | None = None, backend: str | None = None):
    """Start the default process group (host:port ``coordinator``,
    ``num_processes`` ranks, this one ``process_id``, over ``backend``),
    each argument from the environment when not given; returns the
    group."""
    env = os.environ
    coordinator = coordinator or env.get("JIMINY_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(env.get("JIMINY_TPU_NPROCS", "1"))
    if process_id is None:
        process_id = int(env.get("JIMINY_TPU_PROC_ID", "0"))
    backend = backend or env.get("JIMINY_TPU_BACKEND", "nccl")
    if coordinator is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator address")
        coordinator = f"localhost:{free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD


def global_group():
    """The group of every rank of the running cluster."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_cluster first")
    return dist.group.WORLD


_WORKER_TEMPLATE = """\
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from jiminy_tpu_torch.rl.launch import initialize_cluster
initialize_cluster()
try:
{body}
finally:
    dist.destroy_process_group()
"""


def launch_cpu_ring(n_procs: int, worker_body: str, timeout: float = 300.0) -> list[str]:
    """Run ``worker_body`` (Python source; it finds the group started, of
    ``n_procs`` ranks over gloo on a free localhost port) in ``n_procs``
    local processes.
    Returns each one's output (stdout and stderr). Raises RuntimeError if
    any exits non-zero and TimeoutError past ``timeout`` s; every process
    is ended before it returns."""
    repo = Path(__file__).resolve().parents[2]
    body = textwrap.indent(textwrap.dedent(worker_body).strip() or "pass", "    ")
    src = _WORKER_TEMPLATE.format(repo=str(repo), body=body)
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(n_procs):
            env = dict(os.environ, JIMINY_TPU_COORDINATOR=f"localhost:{port}",
                       JIMINY_TPU_NPROCS=str(n_procs), JIMINY_TPU_PROC_ID=str(rank),
                       JIMINY_TPU_BACKEND="gloo")
            log = tempfile.TemporaryFile()
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-c", src], env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"ring of {n_procs} processes still running after "
                                   f"{timeout} s") from None
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"ring worker {rank} failed (rc={p.returncode}):\n{out}")
    return outs


def dryrun_multichip(n_ranks: int, realistic: bool = False, device="cuda") -> float:
    """One PPO train step on ``ANYmalEnv(observe="state")`` across the
    ``n_ranks`` ranks of the running group (a rollout on each rank's shard,
    the grads averaged): tiny, 2 envs per rank, rollout 2, 1 epoch × 1
    minibatch, hidden (32, 32); ``realistic``, 64 envs per rank, rollout
    32, 4 epochs × 8 minibatches, hidden (256, 256). Rank 0 prints the
    result; returns ``reward_mean``, which must be finite."""
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.rl.distributed import make_distributed_train
    from jiminy_tpu_torch.rl.ppo import PPOConfig

    if not dist.is_initialized() or dist.get_world_size() != n_ranks:
        raise RuntimeError(f"dryrun_multichip({n_ranks}) runs in each rank of a process group "
                           f"of {n_ranks} (initialize_cluster or launch_cpu_ring)")
    env = ANYmalEnv(observe="state", device=device)
    if realistic:
        cfg = PPOConfig(num_envs=64 * n_ranks, rollout_len=32, epochs=4, minibatches=8,
                        hidden=(256, 256))
    else:
        cfg = PPOConfig(num_envs=2 * n_ranks, rollout_len=2, epochs=1, minibatches=1,
                        hidden=(32, 32))
    init_fn, train_step, _ = make_distributed_train(env, cfg)
    _, metrics = train_step(init_fn(0))
    r = float(metrics["reward_mean"])
    if not math.isfinite(r):
        raise AssertionError(f"dryrun_multichip({n_ranks}): reward_mean {r}")
    if dist.get_rank() == 0:
        mode = "realistic" if realistic else "tiny"
        print(f"dryrun_multichip({n_ranks}, {mode}): ok, reward_mean={r:.4f}", flush=True)
    return r
