"""What ``torch.profiler`` costs and counts on the card.

    python -m jiminy_tpu_torch.tools.probe_profiler [--kernels 50000]

Profiles ``--kernels`` small in-place adds with CPU and CUDA activities
and with CUDA alone, and prints for each the kernels counted, the seconds
of the profiled run and the seconds of ``key_averages()`` against a count
of the raw device events. Then it starts an NCCL process group of world
size 1 (``rl.launch.initialize_cluster``), profiles 10 adds during and
after it, and prints those counts: whether the profiler still records
kernels in a process that ran such a group.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def count(acts, n: int) -> dict:
    """Kernels of ``n`` adds under a profiler with the activities ``acts``:
    through ``key_averages()`` and on the raw device events, with the
    seconds of the run and of each count."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    x = torch.ones(1000, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    averaged = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    t2 = time.perf_counter()
    raw = sum(1 for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA)
    t3 = time.perf_counter()
    return {"key_averages": averaged, "raw": raw, "run_s": t1 - t0,
            "key_averages_s": t2 - t1, "raw_s": t3 - t2}


def main(argv=None) -> None:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity

    from jiminy_tpu_torch.rl.launch import initialize_cluster

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", type=int, default=50000)
    args = ap.parse_args(argv)
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, acts in (("cpu+cuda", both), ("cuda", [ProfilerActivity.CUDA])):
        count(acts, 100)  # warm-up
        print(name, json.dumps(count(acts, args.kernels)), flush=True)
    initialize_cluster(num_processes=1, process_id=0, backend="nccl")
    y = torch.ones(10, device="cuda")
    dist.all_reduce(y)
    print("during an NCCL group", json.dumps(count(both, 10)), flush=True)
    dist.destroy_process_group()
    print("after it", json.dumps(count(both, 10)), flush=True)


if __name__ == "__main__":
    main()
