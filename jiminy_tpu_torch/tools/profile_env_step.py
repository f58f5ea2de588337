"""Where the time of the ANYmal, Cassie, Atlas, Ant or Spotmicro env step goes on a GPU.

    python -m jiminy_tpu_torch.tools.profile_env_step [--env anymal|cassie|atlas|ant|spotmicro]
        [--batch 4096] [--steps 5] [--solver auto|substep|kernel|inline]
        [--observe state|sensors] [--terrain flat|fourier|perlin|perlin_grid|stairs]
        [--push N] [--push-duration S] [--randomize R] [--self-collision] [--flexibility]
        [--gantry] [--mdp hardcoded|declarative] [--pipeline LAYERS]

``--env cassie`` runs ``CassieEnv(sim_dt=2e-3, target_speed=0.4)``
(``examples/train.py --env cassie``: 10 substeps of 2 ms, the pushrods
and shin springs; flat ground, ``--terrain`` must stay flat), with
``--observe sensors`` at ``cassie_sensors_run``'s sensing (delay 0.004
s, noise 0.02 / 0.005), ``--push 50 --push-duration 0.2`` for
``cassie_push_robust_run``'s pushes, ``--self-collision`` for the
legs' self-collision pairs (``examples/train.py --env cassie
--self-collision``, ``cassie_selfcol_run5``) and ``--flexibility`` for
the flexible hips (``examples/train.py --env cassie_flex``,
``cassie_flex_run5``: a SPHERICAL flexibility joint above each hip roll).
``--env atlas`` runs ``AtlasEnv(target_speed=0.3)`` (``examples/train.py
--env atlas``: 5 substeps of 4 ms), with ``--self-collision`` its four
pairs (``atlas_selfcol_run5``: nc 83), on ``--observe`` and with
``--push`` as above.
``--env ant`` and ``--env spotmicro`` run ``AntEnv()`` and
``SpotmicroEnv()`` at the reference's defaults (``examples/train.py --env
ant | spotmicro``: 20 substeps per env step; the Ant's sensors every
second substep), on ``--observe`` and with ``--push`` as above.
The rest is about ANYmal. ``--gantry`` runs ``ANYmalGantryEnv`` (the
base welded 0.25 m above its stand pose, the LF knee locked: a frame and
a joint constraint, so ``"auto"`` is the chain kernel K1, 4 launches per
env step) on ``--observe`` and ``--terrain`` flat; otherwise it:

Runs ``ANYmalEnv(observe="state", device="cuda")`` (by default on its
main path, ``constraint_solver="auto"``, which is the fused whole-substep
kernel for ANYmal), or with ``--observe sensors`` the sensor-observing
env of ``anymal_sensors_run5`` (delay 0.004 s, IMU noise 0.02, encoder
noise 0.005; K2 with the sensor stage), on ``--terrain`` (default flat)
with pushes of ``--push`` N held ``--push-duration`` s (default none; the
terrain slice is ``--observe sensors --terrain fourier --push 100
--push-duration 0.2``, K2 with the sensor stage and the ground query),
with ``--randomize R`` per-episode model randomization mapped as
examples/train.py maps it (mass and inertia scales 1 ± R, centre-of-mass
offsets ±0.1·R m, motor gain 1 ± R/2; the sim-to-real slice adds
``--randomize 0.2``: the randomized K2), with ``--mdp declarative``
``anymal_declarative_mdp``'s reward and termination, wrapped in
``--pipeline`` (``tools/train.py``'s syntax, e.g. ``mahony,stack:4``, the
sensor artifacts' recipe, with ``--observe sensors``), under
``torch.profiler`` for a few env steps after a warm-up
(:func:`profile_env`), and prints one JSON line: the card (``nvidia-smi`` name and power limit), wall ms per env
step, device busy ms per env step (the sum of GPU kernel times), the
device's idle share, GPU kernel launches per env step and, profiled
apart, per step without auto-reset and per reset (an env step runs one
of each), and the kernels that take the most device time. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="anymal",
                    choices=("anymal", "cassie", "atlas", "ant", "spotmicro"))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--solver", default="auto", choices=("auto", "substep", "kernel", "inline"))
    ap.add_argument("--observe", default="state", choices=("state", "sensors"))
    ap.add_argument("--terrain", default="flat",
                    choices=("flat", "fourier", "perlin", "perlin_grid", "stairs"))
    ap.add_argument("--push", type=float, default=0.0, help="push magnitude, N")
    ap.add_argument("--push-duration", type=float, default=0.1, help="push duration, s")
    ap.add_argument("--randomize", type=float, default=0.0,
                    help="model randomization half-range R (0: none)")
    ap.add_argument("--self-collision", action="store_true",
                    help="Cassie or Atlas with its self-collision pairs")
    ap.add_argument("--flexibility", action="store_true",
                    help="Cassie with its flexible hips")
    ap.add_argument("--gantry", action="store_true",
                    help="ANYmal welded on a gantry with a locked knee (the chain kernel)")
    ap.add_argument("--mdp", default="hardcoded", choices=("hardcoded", "declarative"),
                    help="ANYmal: the declarative reward and termination")
    ap.add_argument("--pipeline", default=None,
                    help="declarative wrapper layers, e.g. mahony,stack:4 (tools/train.py's)")
    args = ap.parse_args()
    if args.mdp != "hardcoded" and (args.env != "anymal" or args.gantry):
        raise SystemExit("profile_env_step: --mdp declarative is ANYmal's")
    if args.gantry and (args.env != "anymal" or args.terrain != "flat" or args.randomize):
        raise SystemExit("profile_env_step: --gantry is ANYmal's, on flat ground, nominal")
    if args.flexibility and args.env != "cassie":
        raise SystemExit("profile_env_step: --flexibility is Cassie's")
    if args.self_collision and args.env not in ("cassie", "atlas"):
        raise SystemExit("profile_env_step: --self-collision is Cassie's and Atlas's")
    if not torch.cuda.is_available():
        raise SystemExit("profile_env_step: no CUDA GPU available")
    from jiminy_tpu_torch.engine.randomization import ModelRandomization
    from jiminy_tpu_torch.envs import (
        AntEnv,
        ANYmalEnv,
        ANYmalGantryEnv,
        AtlasEnv,
        CassieEnv,
        SpotmicroEnv,
        anymal_declarative_mdp,
        build_pipeline,
    )
    from jiminy_tpu_torch.tools.train import parse_pipeline

    dev = torch.device("cuda")
    r = args.randomize
    randomization = ModelRandomization(
        mass_scale=(1 - r, 1 + r), com_offset=0.02 * r / 0.2, inertia_scale=(1 - r, 1 + r),
        motor_gain=(1 - r / 2, 1 + r / 2)) if r else None
    sensors = (dict(sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
               if args.observe == "sensors" else {})
    if args.env in ("ant", "spotmicro"):
        if args.terrain != "flat" or r:
            raise SystemExit(f"profile_env_step: the {args.env} env runs on flat ground, nominal")
        env = (AntEnv(observe=args.observe, constraint_solver=args.solver, push_magnitude=args.push,
                      push_duration=args.push_duration, device=dev) if args.env == "ant" else
               SpotmicroEnv(observe=args.observe, constraint_solver=args.solver,
                            push_magnitude=args.push, push_duration=args.push_duration,
                            device=dev))
    elif args.env == "cassie":
        if args.terrain != "flat":
            raise SystemExit("profile_env_step: the Cassie env runs on flat ground")
        env = CassieEnv(observe=args.observe, sim_dt=2e-3, target_speed=0.4, pgs_iters=8,
                        constraint_solver=args.solver, push_magnitude=args.push,
                        push_duration=args.push_duration, model_randomization=randomization,
                        self_collision=args.self_collision, flexibility=args.flexibility,
                        device=dev, **sensors)
    elif args.env == "atlas":
        if args.terrain != "flat":
            raise SystemExit("profile_env_step: the Atlas env runs on flat ground")
        env = AtlasEnv(observe=args.observe, target_speed=0.3, constraint_solver=args.solver,
                       push_magnitude=args.push, push_duration=args.push_duration,
                       model_randomization=randomization, self_collision=args.self_collision,
                       device=dev, **sensors)
    elif args.gantry:
        env = ANYmalGantryEnv(observe=args.observe, step_dt=0.02, sim_dt=5e-3, pgs_iters=8,
                              constraint_solver=args.solver, push_magnitude=args.push,
                              push_duration=args.push_duration, device=dev, **sensors)
    else:
        mdp = {}
        if args.mdp == "declarative":
            mdp["reward_fn"], mdp["termination_fn"] = anymal_declarative_mdp()
        env = ANYmalEnv(observe=args.observe, step_dt=0.02, sim_dt=5e-3, pgs_iters=8,
                        constraint_solver=args.solver, terrain=args.terrain,
                        push_magnitude=args.push, push_duration=args.push_duration,
                        model_randomization=randomization, device=dev, **sensors, **mdp)
    engine = env.engine
    env = build_pipeline(env, parse_pipeline(args.pipeline))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu,
        "env": args.env,
        "batch": args.batch,
        "constraint_solver": engine.backend,
        "observe": args.observe,
        "terrain": args.terrain,
        "push_magnitude": args.push,
        "randomize": r,
        "self_collision": args.self_collision,
        "flexibility": args.flexibility,
        "gantry": args.gantry,
        "mdp": args.mdp,
        "pipeline": args.pipeline,
        **profile_env(env, args.batch, args.steps),
    }))


def profile_env(env, batch: int, steps: int) -> dict:
    """``steps`` env steps of ``env`` (an env or a pipeline on the card)
    at ``batch`` under ``torch.profiler`` after as many of warm-up: wall
    ms, device busy ms (the sum of GPU kernel times), the device's idle
    share and GPU kernel launches per env step, the launches per step
    without auto-reset and per reset profiled apart (an env step runs one
    of each), and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(env.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env.reset(gen, batch)
    acts = [torch.rand(batch, env.action_size, generator=gen, device=dev) * 2 - 1
            for _ in range(2 * steps)]
    for a in acts[:steps]:  # warm-up
        state = env.step(state, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in acts[steps:]:
            state = env.step(state, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    # the two halves of an env step alone, over as many calls: the step
    # without auto-reset, and the reset that auto-reset runs every step
    split = {}
    for name, fn in (("step_no_reset", lambda a: env.step_no_reset(state, a)),
                     ("reset", lambda a: env.reset(gen, batch))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as part:
            for a in acts[steps:]:
                fn(a)
            torch.cuda.synchronize()
        split[name] = sum(
            e.count for e in part.key_averages() if e.device_type == DeviceType.CUDA
        ) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms_per_env_step": 1e3 * wall / steps,
        "device_busy_ms_per_env_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall,
        "gpu_kernel_launches_per_env_step": sum(e.count for e in kernels) / steps,
        "gpu_kernel_launches_per_step_no_reset": split["step_no_reset"],
        "gpu_kernel_launches_per_reset": split["reset"],
        "top_kernels_ms_per_env_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top
        },
    }


if __name__ == "__main__":
    main()
