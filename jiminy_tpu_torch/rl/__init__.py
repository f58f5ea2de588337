"""Reinforcement learning on the port's envs: the MLP actor-critic, PPO,
greedy evaluation and metrics logging (counterpart of ``jiminy_tpu/rl``
on one device)."""

from jiminy_tpu_torch.rl.evaluate import evaluate, greedy_policy
from jiminy_tpu_torch.rl.logging import MetricsLogger, read_metrics
from jiminy_tpu_torch.rl.networks import MLPPolicy, policy_params_from_arrays
from jiminy_tpu_torch.rl.ppo import PPOConfig, make_train_fn, train

__all__ = [
    "MLPPolicy",
    "MetricsLogger",
    "PPOConfig",
    "evaluate",
    "greedy_policy",
    "make_train_fn",
    "policy_params_from_arrays",
    "read_metrics",
    "train",
]
