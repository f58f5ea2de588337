"""Evaluate a trained run's policy on an env.

    python -m jiminy_tpu_torch.tools.evaluate --run runs/anymal_run [--env anymal]
        [--n-envs 256] [--n-steps 499] [--seed 123] [--device cuda|cpu] [--out stats.json]

The port's counterpart of ``examples/evaluate.py``: restores the policy's
params from the run's torch checkpoints (``<run>/ckpt/``, the newest
step; ``tools/train.py --out`` writes them), sizes the policy from them,
and runs ``rl.evaluate``'s batched greedy rollout on the env that
``tools/train.py`` builds for ``--env`` (``--max-steps``, ``--terrain``,
``--observe``, ``--sensor-delay``, ``--imu-noise``, ``--encoder-noise``,
``--self-collision``, ``--mdp`` and ``--pipeline`` as there; a pipeline's
normalization statistics frozen from the checkpointed carry, as
``freeze_pipeline_stats`` does). Prints the statistics as JSON. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from jiminy_tpu_torch.tools.train import add_env_args, build_env


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_env_args(ap)
    ap.add_argument("--run", required=True, help="run directory holding ckpt/ (train --out)")
    ap.add_argument("--n-envs", type=int, default=256)
    ap.add_argument("--n-steps", type=int, default=499)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--out", default=None, help="write the statistics as JSON here too")
    args = ap.parse_args()

    from jiminy_tpu_torch.checkpoint import restore_raw
    from jiminy_tpu_torch.envs import freeze_pipeline_stats
    from jiminy_tpu_torch.rl import MLPPolicy, evaluate, greedy_policy

    env = build_env(args)
    carry = restore_raw(pathlib.Path(args.run) / "ckpt", device=env.device)
    if args.pipeline:  # the normalization statistics are part of the trained artifact
        env = freeze_pipeline_stats(env, carry[2])
    params = carry[0]
    hidden = [W.shape[1] for W, _ in params["actor"][:-1]]
    discrete = env.discrete_actions is not None
    policy = MLPPolicy(env.observation_size, env.discrete_actions if discrete else env.action_size,
                       discrete=discrete, hidden=hidden)
    stats = evaluate(env, greedy_policy(policy, params), n_envs=args.n_envs,
                     n_steps=args.n_steps,
                     generator=torch.Generator(device=env.device).manual_seed(args.seed))
    print(json.dumps(stats, indent=1))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
