"""Where the time of the ANYmal env step goes on a GPU.

    python -m jiminy_tpu_torch.tools.profile_env_step [--batch 4096] [--steps 5]

Runs ``ANYmalEnv(observe="state", device="cuda")`` under
``torch.profiler`` for a few env steps after a warm-up, and prints one
JSON line: the card (``nvidia-smi`` name and power limit), wall ms per env
step, device busy ms per env step (the sum of GPU kernel times), the
device's idle share, GPU kernel launches per env step, and the kernels
that take the most device time. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_env_step: no CUDA GPU available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jiminy_tpu_torch.envs import ANYmalEnv

    dev = torch.device("cuda")
    env = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env.reset(gen, args.batch)
    acts = [torch.rand(args.batch, 12, generator=gen, device=dev) * 2 - 1
            for _ in range(2 * args.steps)]
    for a in acts[:args.steps]:  # warm-up
        state = env.step(state, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in acts[args.steps:]:
            state = env.step(state, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    n = args.steps
    print(json.dumps({
        "gpu": gpu,
        "batch": args.batch,
        "wall_ms_per_env_step": 1e3 * wall / n,
        "device_busy_ms_per_env_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall,
        "gpu_kernel_launches_per_env_step": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_env_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / n for e in top
        },
    }))


if __name__ == "__main__":
    main()
