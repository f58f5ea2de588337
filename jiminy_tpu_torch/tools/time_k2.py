"""K2's time per launch on a GPU, for comparing two builds on one card.

    python -m jiminy_tpu_torch.tools.time_k2 [--batch 4096] [--reps 50]
        [--env anymal|ant|spotmicro|cassie] [--observe state|sensors] [--k1-gantry]

Times K2 (``substep_batched_multi``) over the env step's substeps on the
env's spec from reset states (``ANYmalEnv()``, ``AntEnv()``,
``SpotmicroEnv()`` at their defaults; ``CassieEnv(sim_dt=2e-3,
target_speed=0.4)``), with ``--observe sensors`` the sensor stage too,
with CUDA events around ``--reps`` launches after a warm-up, and prints
one JSON line (``--k1-gantry``: K1, ``solve_batched``, instead, on
seeded random SPD systems in the layout of ``ANYmalGantryEnv``'s engine,
which the package under test must have: n 18, nc 31, equality blocks of
6 and 1 rows, 12 bounds, two colors of 2 contacts, 8 sweeps): the card (``nvidia-smi`` name and power limit), the model,
the path and the milliseconds per launch. It reads only the package's
public entry points, so running this file by path with another checkout's
package first on ``PYTHONPATH`` times that checkout's kernels: two builds
compared in turns within one call on one card. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def time_k2(env_name: str, observe: str, B: int, reps: int, dev) -> float:
    """Milliseconds per K2 launch over the env step's substeps."""
    from jiminy_tpu_torch import envs
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec, substep_batched_multi

    make = {"anymal": envs.ANYmalEnv, "ant": envs.AntEnv, "spotmicro": envs.SpotmicroEnv,
            "cassie": envs.CassieEnv}[env_name]
    kw = dict(sim_dt=2e-3, target_speed=0.4) if env_name == "cassie" else {}
    env = make(observe="sensors", device=dev, **kw)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env.reset(gen, B)
    act = torch.rand(B, env.motors.nm, generator=gen, device=dev) * 2.0 - 1.0
    cmd = env._action_to_command(act, state.sim)
    args = (state.sim.q, state.sim.v, cmd, state.sim.lam, torch.zeros(B, 6, device=dev))
    spec, n_sub, suite = env.engine.substep_spec, env.n_substeps, env.sensors
    sw = {}
    if observe == "sensors":
        sens = SensorKernelSpec(env.tree, suite, env.n_substeps_per_obs)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), *args[:2]))
        eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_sub // sens.k_obs)], 1)
        sw = dict(sensors=sens, bufs=bufs, eps=eps)
    for _ in range(3):  # warm-up
        substep_batched_multi(spec, n_sub, *args, **sw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        substep_batched_multi(spec, n_sub, *args, **sw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_k1_gantry(B: int, reps: int, dev) -> float:
    """Milliseconds per K1 launch in the gantry ANYmal's layout, taken
    from ``ANYmalGantryEnv`` at ``chip_smoke.py``'s settings, on random
    SPD systems."""
    from jiminy_tpu_torch.envs import ANYmalGantryEnv
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched

    env = ANYmalGantryEnv(device=dev, observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8)
    cfg = env.engine.substep_spec.cfg
    n, nc = cfg.n, cfg.nc
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=gen, device=dev)
    R = 0.3 * torch.randn(B, n, n, **kw)
    args = (R @ R.transpose(1, 2) + 2.0 * torch.eye(n, device=dev), torch.randn(B, n, **kw),
            0.5 * torch.randn(B, n, **kw), 0.5 * torch.randn(B, nc, n, **kw),
            0.1 * torch.randn(B, nc, **kw), torch.full((B, nc), 0.8, device=dev),
            (torch.rand(B, nc, **kw) < 0.7).float(), 0.01 * torch.randn(B, nc, **kw))
    for _ in range(3):  # warm-up
        solve_batched(cfg, *args, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        solve_batched(cfg, *args, device=dev)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--env", default="anymal", choices=("anymal", "ant", "spotmicro", "cassie"))
    ap.add_argument("--observe", default="state", choices=("state", "sensors"))
    ap.add_argument("--k1-gantry", action="store_true",
                    help="time K1 in the gantry ANYmal's layout instead of K2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k2: no CUDA GPU available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    if args.k1_gantry:
        ms = time_k1_gantry(args.batch, args.reps, dev)
        print(json.dumps({"card": card, "kernel": "K1", "layout": "gantry", "B": args.batch,
                          "reps": args.reps, "ms_per_launch": ms}))
        return
    ms = time_k2(args.env, args.observe, args.batch, args.reps, dev)
    print(json.dumps({"card": card, "env": args.env, "observe": args.observe, "B": args.batch,
                      "reps": args.reps, "ms_per_launch": ms}))


if __name__ == "__main__":
    main()
