"""Policy evaluation: batched greedy rollouts and their episode statistics.

Counterpart of ``jiminy_tpu/rl/evaluate.py`` ``evaluate``: ``n_envs``
episodes from ``env.reset(generator, n_envs)``, stepped ``n_steps`` times
with ``step_no_reset`` under the policy's action, each env's first
episode counted until it ends. The statistics stay on the env's device
until the end (one host read). ``play`` (the viewer path) waits for
ROADMAP A.19.
"""

from __future__ import annotations

from typing import Callable

import torch


def greedy_policy(policy, params) -> Callable[[torch.Tensor], torch.Tensor]:
    """obs → the policy's greedy action: the mean for continuous actions,
    the argmax of the logits for discrete ones."""
    if policy.discrete:
        return lambda obs: torch.argmax(policy.action_dist(params, obs), dim=-1)
    return lambda obs: policy.action_dist(params, obs)[0]


def evaluate(
    env,
    policy_fn: Callable[[torch.Tensor], torch.Tensor],  # obs (B, d) → action
    n_envs: int = 256,
    n_steps: int = 500,
    generator: torch.Generator | None = None,
) -> dict:
    """Greedy batched evaluation. Returns the means over the envs of the
    first episode's return and length, the share of envs whose first
    episode terminated (named by ``env.termination_meaning``: the fall
    fraction and the share alive at the end for ``"failure"``, the
    success fraction and the mean steps to success for ``"success"``),
    and with a floating base (nq ≥ 7) the mean forward (x) displacement.
    ``generator`` draws the episodes (default: seed 0 on the env's
    device)."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    states = env.reset(generator, n_envs)
    x0 = states.sim.q[:, 0].clone() if states.sim.q.shape[-1] >= 7 else None
    dev = states.reward.device
    ret = torch.zeros(n_envs, dtype=states.reward.dtype, device=dev)
    length = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    alive = torch.ones(n_envs, dtype=torch.bool, device=dev)
    fell = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    with torch.no_grad():
        for _ in range(n_steps):
            states = env.step_no_reset(states, policy_fn(states.obs))
            ret = ret + torch.where(alive, states.reward, torch.zeros_like(states.reward))
            length = length + alive.to(torch.int32)
            fell = fell | (alive & states.terminated)
            alive = alive & ~states.done
    out = {
        "return_mean": ret.mean(),
        "length_mean": length.to(torch.float32).mean(),
        "terminated_fraction": fell.to(torch.float32).mean(),
    }
    # termination means failure for walkers, success for goal tasks
    if getattr(env, "termination_meaning", "failure") == "success":
        out["success_fraction"] = out["terminated_fraction"]
        done_steps = torch.where(fell, length.to(torch.float32),
                                 torch.full_like(ret, float("nan"), dtype=torch.float32))
        out["success_steps_mean"] = torch.nanmean(done_steps)
    else:
        out["fall_fraction"] = out["terminated_fraction"]
        out["alive_at_end"] = alive.to(torch.float32).mean()
    if x0 is not None:
        out["forward_displacement_mean"] = (states.sim.q[:, 0] - x0).mean()
    values = torch.stack([v.to(torch.float64) for v in out.values()]).tolist()  # one host read
    return dict(zip(out, values))
