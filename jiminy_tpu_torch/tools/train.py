"""Train a locomotion env with PPO on one device.

    python -m jiminy_tpu_torch.tools.train --env anymal --iters 4000 --num-envs 2048 \\
        --out runs/anymal_run [--device cuda|cpu]

The port's counterpart of ``examples/train.py``, with its defaults:
rollout 32, 8 minibatches, 4 epochs, hidden (256, 256), lr 3e-4 annealed
linearly to 0 over the run (``anneal_lr``), ``--ent-coef 0.005``,
``--max-steps 500``, ``--observe state``, and the mirror-symmetry loss
(``symmetry_coef=0.1``) for any env that has ``symmetry_fn`` (ANYmal).
Every 10 iterations it logs the metrics to ``<out>/metrics.jsonl``; every
100 it prints the reward, the done share, the KL and the env-steps/s,
cumulative and marginal (since the last print; the cumulative rate
carries the first iteration's set-up). It checkpoints the carry to
``<out>/ckpt/`` every 1000 iterations and at the end, then writes
``<out>/eval.json``: ``rl.evaluate`` of the greedy policy at 256 envs
for ``max_steps − 1`` steps.

Envs (``examples/train.py``'s ``make_env``): anymal, cassie,
cassie_flex, atlas (``target_speed=0.3``), ant, spotmicro, with
``--terrain`` (anymal), ``--push``, ``--push-duration``, ``--observe``,
``--sensor-delay``, ``--imu-noise``, ``--encoder-noise``, ``--randomize``
and ``--self-collision`` (cassie, atlas); cartpole and acrobot at their
own defaults (discrete actions, 500 steps an episode), as there.
``--mdp declarative`` (anymal only) trains on ``anymal_declarative_mdp``'s
reward and termination. ``--solver`` (``auto``, ``substep``, ``kernel``,
``inline``, or the reference's ``pallas_substep``, ``pallas``, ``xla``
for the same three: :data:`SOLVERS`) and ``--fusion`` / ``--no-fusion``
set the engine's ``constraint_solver`` and ``substep_fusion`` through
``Engine.set_options`` after the env is built, as ``examples/train.py``
does. ``--pipeline`` wraps the env in declarative
layers, comma-separated innermost first (``stack:N``, default N = 4;
``mahony``; ``normalize``: e.g. ``mahony,stack:4``, the sensor
artifacts' recipe); a pipeline trains without the symmetry loss (the
observation's layout is the pipeline's), and the evaluation freezes the
normalization statistics of the last carry (``freeze_pipeline_stats``).
Runs on the card unless ``--device cpu``.

``main(argv)`` returns (the env, the final carry, the evaluation's
statistics).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

ENVS = ("anymal", "cassie", "cassie_flex", "atlas", "ant", "spotmicro", "cartpole", "acrobot")
# --solver: the port's backends, and the reference's names for the same ones
SOLVERS = {
    "auto": "auto",
    "substep": "substep", "pallas_substep": "substep",  # the whole-substep kernels (K2, K3)
    "kernel": "kernel", "pallas": "kernel",  # plain physics around the chain kernel (K1)
    "inline": "inline", "xla": "inline",  # plain physics, no kernel
}


def make_env(name: str, max_steps: int, terrain=None, push=0.0, observe="state",
             sensor_delay=0.0, imu_noise=0.0, encoder_noise=0.0, push_duration=0.1,
             randomize=None, self_collision=False, mdp="hardcoded", device="cuda"):
    """The env ``examples/train.py`` builds for ``name``, on ``device``."""
    from jiminy_tpu_torch import envs as E

    if mdp != "hardcoded" and name != "anymal":
        raise ValueError(f"--mdp {mdp} is anymal's; {name} has its hand-coded MDP only")
    if name == "cartpole":
        return E.CartPoleEnv(device=device)
    if name == "acrobot":
        return E.AcrobotEnv(device=device)
    kw = {"push_duration": push_duration, "max_steps": max_steps, "push_magnitude": push,
          "observe": observe, "device": device}
    if randomize:
        from jiminy_tpu_torch.engine.randomization import ModelRandomization

        kw["model_randomization"] = ModelRandomization(
            mass_scale=(1 - randomize, 1 + randomize),
            com_offset=0.02 * randomize / 0.2,
            inertia_scale=(1 - randomize, 1 + randomize),
            motor_gain=(1 - randomize / 2, 1 + randomize / 2),
        )
    sensing = {"sensor_delay": sensor_delay, "imu_noise": imu_noise,
               "encoder_noise": encoder_noise}
    if terrain not in (None, "flat") and name != "anymal":
        raise ValueError(f"--terrain is anymal's; {name} walks on flat ground")
    if self_collision and name not in ("cassie", "cassie_flex", "atlas"):
        raise ValueError("--self-collision is cassie's and atlas's")
    if name == "anymal":
        if mdp == "declarative":
            kw["reward_fn"], kw["termination_fn"] = E.anymal_declarative_mdp()
        return E.ANYmalEnv(terrain=terrain, **sensing, **kw)
    if name in ("cassie", "cassie_flex"):
        return E.CassieEnv(sim_dt=2e-3, target_speed=0.4, self_collision=self_collision,
                           flexibility=name == "cassie_flex", **sensing, **kw)
    if name == "atlas":
        return E.AtlasEnv(target_speed=0.3, self_collision=self_collision, **sensing, **kw)
    if name == "ant":
        return E.AntEnv(**kw)
    if name == "spotmicro":
        return E.SpotmicroEnv(**sensing, **kw)
    raise ValueError(f"unknown env {name!r}")


def parse_pipeline(spec: str | None) -> list[dict]:
    """``--pipeline`` → ``build_pipeline``'s layers, as examples/train.py
    parses it: comma-separated ``kind[:arg]``, ``stack:N`` (N = 4 by
    default)."""
    layers = []
    for part in spec.split(",") if spec else ():
        kind, _, arg = part.partition(":")
        layer = {"type": kind}
        if kind == "stack":
            layer["n"] = int(arg or 4)
        layers.append(layer)
    return layers


def engine_overrides(args) -> dict:
    """The engine options that ``--solver`` and ``--fusion`` set (the
    reference's names mapped through :data:`SOLVERS`)."""
    out = {}
    if args.solver is not None:
        out["constraint_solver"] = SOLVERS[args.solver]
    if args.fusion is not None:
        out["substep_fusion"] = args.fusion
    return out


def build_env(args, **kw):
    """The env of the parsed shared options (``add_env_args``) and
    ``make_env``'s other arguments ``kw``, its engine's options set by
    ``--solver`` and ``--fusion`` (``Engine.set_options``), wrapped in its
    pipeline."""
    from jiminy_tpu_torch.envs import build_pipeline

    env = make_env(args.env, args.max_steps, terrain=args.terrain, observe=args.observe,
                   sensor_delay=args.sensor_delay, imu_noise=args.imu_noise,
                   encoder_noise=args.encoder_noise, self_collision=args.self_collision,
                   mdp=args.mdp, device=args.device, **kw)
    overrides = engine_overrides(args)
    if overrides:
        env.engine.set_options(overrides)
    return build_pipeline(env, parse_pipeline(args.pipeline))


def add_env_args(ap: argparse.ArgumentParser) -> None:
    """The env options the train and evaluate entry points share."""
    ap.add_argument("--env", default="anymal", choices=ENVS)
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--terrain", default=None,
                    choices=[None, "flat", "perlin", "perlin_grid", "stairs", "fourier"])
    ap.add_argument("--observe", default="state", choices=["state", "sensors"],
                    help="observation source: privileged state or the delayed, noisy "
                    "sensor suite")
    ap.add_argument("--self-collision", action="store_true",
                    help="cassie, atlas: the self-collision pairs")
    ap.add_argument("--sensor-delay", type=float, default=0.0)
    ap.add_argument("--imu-noise", type=float, default=0.0)
    ap.add_argument("--encoder-noise", type=float, default=0.0)
    ap.add_argument("--mdp", default="hardcoded", choices=["hardcoded", "declarative"],
                    help="anymal: the hand-coded reward and termination or the same composed "
                    "from the declarative layer")
    ap.add_argument("--pipeline", default=None,
                    help="declarative wrapper layers, innermost first, e.g. 'mahony,stack:4' "
                    "or 'stack:4,normalize'")
    ap.add_argument("--solver", default=None, choices=list(SOLVERS),
                    help="the engine's constraint_solver (default: the env's, 'auto'); the "
                    "reference's pallas_substep, pallas and xla name substep, kernel, inline")
    ap.add_argument("--fusion", action=argparse.BooleanOptionalAction, default=None,
                    help="EngineOptions.substep_fusion: every substep of an env step in one "
                    "K2 launch (the default), or --no-fusion for one K3 launch per substep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_env_args(ap)
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--num-envs", type=int, default=2048)
    ap.add_argument("--out", default=None, help="run directory (default runs/<env>_run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ent-coef", type=float, default=0.005)
    ap.add_argument("--push", type=float, default=0.0,
                    help="random push force magnitude (N), walker envs")
    ap.add_argument("--push-duration", type=float, default=0.1,
                    help="push duration (s); impulse = push × duration")
    ap.add_argument("--randomize", type=float, default=None,
                    help="model randomization half-range, e.g. 0.2: mass and inertia ±20%%, "
                    "motor gain ±10%%, centre of mass ±2 cm")
    ap.add_argument("--ent-anneal", action="store_true",
                    help="anneal the entropy bonus linearly to 0 over the run")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out or f"runs/{args.env}_run")
    out.mkdir(parents=True, exist_ok=True)

    from jiminy_tpu_torch.checkpoint import CheckpointManager
    from jiminy_tpu_torch.envs import freeze_pipeline_stats
    from jiminy_tpu_torch.rl import MetricsLogger, PPOConfig, evaluate, greedy_policy
    from jiminy_tpu_torch.rl.ppo import make_train_fn

    env = build_env(args, push=args.push, push_duration=args.push_duration,
                    randomize=args.randomize)
    symmetry_fn = getattr(env, "symmetry_fn", None)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_len=32,
        minibatches=8,
        epochs=4,
        hidden=(256, 256),
        lr=3e-4,
        ent_coef=args.ent_coef,
        symmetry_coef=0.1 if symmetry_fn is not None else 0.0,
        anneal_lr=True,
        anneal_ent=args.ent_anneal,
        total_iters=args.iters,
    )
    init_fn, train_step, policy = make_train_fn(env, cfg, symmetry_fn=symmetry_fn)
    carry = init_fn(args.seed, cfg.num_envs)
    mgr = CheckpointManager(out / "ckpt", max_to_keep=2)

    steps_per_iter = cfg.num_envs * cfg.rollout_len
    t0 = time.perf_counter()
    last_t, last_steps = t0, 0
    with MetricsLogger(out, run_name=f"{args.env}-seed{args.seed}") as lg:
        for i in range(args.iters):
            carry, metrics = train_step(carry)
            if i % 10 == 0 or i == args.iters - 1:
                m = {k: float(v) for k, v in metrics.items()}  # the one host read
                m["iter"] = i
                m["env_steps"] = (i + 1) * steps_per_iter
                lg.log(i, m)
                if i % 100 == 0:
                    now = time.perf_counter()
                    marginal = (m["env_steps"] - last_steps) / max(now - last_t, 1e-9)
                    last_t, last_steps = now, m["env_steps"]
                    print(
                        f"iter {i:5d} reward {m['reward_mean']:7.3f} "
                        f"done% {100 * m['episode_done_frac']:5.2f} "
                        f"kl {m['approx_kl']:.4f} "
                        f"{m['env_steps'] / (now - t0):,.0f} steps/s "
                        f"(marginal {marginal:,.0f})",
                        flush=True,
                    )
            if i and i % 1000 == 0:
                mgr.save(i, carry)
    mgr.save(args.iters, carry)

    # the normalization statistics are part of the trained artifact
    eval_env = freeze_pipeline_stats(env, carry[2])
    stats = evaluate(eval_env, greedy_policy(policy, carry[0]), n_envs=256,
                     n_steps=args.max_steps - 1,
                     generator=torch.Generator(device=env.device).manual_seed(123))
    (out / "eval.json").write_text(json.dumps(stats, indent=1))
    print("eval:", stats)
    total = args.iters * steps_per_iter
    dt = time.perf_counter() - t0
    print(f"done: {total:,} env-steps in {dt:,.0f}s ({total / dt:,.0f}/s)")
    return env, carry, stats


if __name__ == "__main__":
    main()
