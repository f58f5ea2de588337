"""Policy evaluation: batched greedy rollouts and their episode
statistics, and a single-env rollout for the viewers.

Counterpart of ``jiminy_tpu/rl/evaluate.py``. ``evaluate``: ``n_envs``
episodes from ``env.reset(generator, n_envs)``, stepped ``n_steps`` times
with ``step_no_reset`` under the policy's action, each env's first
episode counted until it ends; the statistics stay on the env's device
until the end (one host read). ``play``: one env's episode, its
configurations and rewards, written as an HTML replay or a GIF.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def play(env, policy_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
         n_steps: int = 250, generator: torch.Generator | None = None, replay_path=None,
         gif_path=None, frame_stride: int = 2):
    """One env's rollout (a batch of 1) until it ends or for ``n_steps``
    steps under ``policy_fn`` (None: a zero action). Returns (qs (F, nq),
    rewards (T,)), qs every ``frame_stride`` steps from the reset on. With
    ``replay_path`` writes the 3-D HTML replay (the centre of mass and the
    contact forces marked); with ``gif_path`` an animated GIF (PIL)."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    st = env.reset(generator, 1)
    qs, fs, rewards = [st.sim.q[0]], [st.sim.contact_forces[0]], []
    with torch.no_grad():
        for t in range(n_steps):
            if policy_fn is None:
                a = (torch.zeros(1, dtype=torch.long, device=env.device)
                     if env.discrete_actions is not None else st.obs.new_zeros(1, env.action_size))
            else:
                a = policy_fn(st.obs)
            st = env.step_no_reset(st, a)
            rewards.append(st.reward[0])
            if t % frame_stride == 0:
                qs.append(st.sim.q[0])
                fs.append(st.sim.contact_forces[0])
            if bool(st.done[0]):
                break
    qs, fs = torch.stack(qs).cpu().numpy(), torch.stack(fs).cpu().numpy()
    rewards = torch.stack(rewards).cpu().numpy().astype(np.float64)
    robot = getattr(env, "robot", None) or env.tree
    if replay_path is not None or gif_path is not None:
        from jiminy_tpu_torch.viewer3d import env_ground, record_gif3d, replay_html3d

        # the episode's own ground (a per-env terrain) renders in the scene
        ground = env_ground(env, getattr(st, "info", {}))
    if replay_path is not None:
        replay_html3d(robot, qs, replay_path, forces=fs, ground=ground,
                      dt=getattr(env, "step_dt", None))
    if gif_path is not None:
        record_gif3d(env.tree, qs, gif_path, visuals=getattr(robot, "visuals", None),
                     forces=fs, ground=ground)
    return qs, rewards
