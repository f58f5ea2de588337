"""PPO: batched rollouts on the env's device and a clipped-surrogate learner.

Counterpart of ``jiminy_tpu/rl/ppo.py``. The reference
fuses the rollout (``lax.scan`` over ``env.step``) and the update into one
jitted ``train_step``; here ``train_step`` runs the same stages eagerly
on the env's device: the rollout into preallocated (T, B, ...) buffers,
GAE, then ``epochs`` × ``minibatches`` updates, with no host read inside
(metrics stay 0-d tensors until the caller reads them).

The optimizer is the reference's ``optax.chain(clip_by_global_norm(
max_grad_norm), adam(schedule, eps=1e-5))``, written out
(:func:`adam_init`, :meth:`PPO._apply_grads`): the clip scales every leaf
(``log_std`` too) by max_norm / norm where the global norm exceeds
max_norm, Adam's bias-corrected step divides by sqrt(ν̂) + 1e-5, and with
``anneal_lr`` the rate falls linearly to 0 over ``total_iters · epochs ·
minibatches`` updates, the first update at ``lr`` itself (optax counts
minibatch updates).

Data-parallel runs (``rl/distributed.py``) give :class:`PPO` an
``all_mean`` hook, the counterpart of the reference's ``axis``: the mean
over the ranks of a list of tensors. It averages every minibatch's
gradients after ``torch.autograd.grad`` and before the clip and Adam (the
reference's ``pmean`` of the grads, ``ppo.py:262``), and the iteration's
metrics once at the end (its ``pmean`` of the metrics; the last
minibatch's aux terms are among them, and the mean of values already
equal on every rank is those values, so its ``pmean`` of every aux term
gives the same numbers).

Truncation: envs auto-reset when done but expose the observation of the
finished step (``info["final_obs"]``), so the TD target bootstraps
V(final_obs) on truncation and 0 on termination.

The reference's PRNG keys become the carry's ``torch.Generator`` on the
env's device, which draws the rollout's action noise (T, B, A) and the
epochs' permutations (epochs, n). ``train_step(carry, noise=, perms=)``
takes either as a tensor instead, so that a test can hand in the
reference's draws (JAX and torch streams never match). Each epoch gathers
every field with its permutation and minibatch m holds rows
``perm[m·n/M:(m+1)·n/M]``, the rows and order of the reference's packed
shuffle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from jiminy_tpu_torch.rl.networks import (
    MLPPolicy,
    gaussian_log_prob,
    gumbel,
    param_leaves,
    params_from_leaves,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 2048
    rollout_len: int = 16
    epochs: int = 4
    minibatches: int = 8
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    anneal_lr: bool = False
    # linearly anneal the entropy bonus to 0 over total_iters, so that the
    # mean policy (what evaluate runs) sharpens instead of relying on the
    # action noise
    anneal_ent: bool = False
    total_iters: int = 1000  # only used for lr/ent annealing
    l2_reg: float = 0.0  # weight decay on the networks' weights (not b, not log_std)
    symmetry_coef: float = 0.0  # weight of the mirror-symmetry loss


def _gae(traj: dict, gamma: float, lam: float):
    """Generalized advantage estimation over a (T, B) trajectory dict:
    (advantages, returns)."""
    value = traj["value"]
    not_term = 1.0 - traj["terminated"].to(value.dtype)
    not_done = 1.0 - traj["done"].to(value.dtype)
    delta = traj["reward"] + gamma * not_term * traj["final_value"] - value
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + gamma * lam * not_done[t] * carry
        adv[t] = carry
    return adv, adv + value


def adam_init(params: dict) -> dict:
    """Adam's state for ``params``: the update count and the first and
    second moments, one per leaf in ``param_leaves`` order."""
    leaves = param_leaves(params)
    return {
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        "mu": [torch.zeros_like(x) for x in leaves],
        "nu": [torch.zeros_like(x) for x in leaves],
    }


class PPO:
    """The stages of one PPO iteration on ``env``; :func:`make_train_fn`
    returns its ``init`` and ``train_step``. The carry is ``(params,
    opt_state, env_state, generator, it)``."""

    def __init__(self, env, cfg: PPOConfig, symmetry_fn: Callable | None = None,
                 all_mean: Callable | None = None):
        self.env = env
        self.cfg = cfg
        self.symmetry_fn = symmetry_fn
        self.all_mean = all_mean
        discrete = env.discrete_actions is not None
        act_size = env.discrete_actions if discrete else env.action_size
        self.policy = MLPPolicy(env.observation_size, act_size, discrete=discrete,
                                hidden=cfg.hidden)
        if cfg.symmetry_coef > 0.0 and symmetry_fn is not None and discrete:
            raise ValueError("symmetry loss requires continuous actions")

    # ---- carry
    def init(self, seed: int, n_envs: int):
        """The carry of a fresh run: params drawn on the CPU from ``seed``
        (in the observations' dtype, then moved to the env's device), a
        fresh Adam state, ``n_envs`` envs reset from a generator on the
        env's device seeded ``seed + 1`` (it then draws their auto-resets),
        and the run's generator seeded ``seed + 2``."""
        dev = self.env.device
        states = self.env.reset(torch.Generator(device=dev).manual_seed(seed + 1), n_envs)
        params = self.policy.init(torch.Generator().manual_seed(seed), dtype=states.obs.dtype,
                                  device=dev)
        run_gen = torch.Generator(device=dev).manual_seed(seed + 2)
        return (params, adam_init(params), states, run_gen, 0)

    # ---- rollout
    def draw_noise(self, generator: torch.Generator, batch_size: int, dtype) -> torch.Tensor:
        """The rollout's action noise (T, B, A): standard normal, or
        standard Gumbel over the discrete actions."""
        shape = (self.cfg.rollout_len, batch_size, self.policy.action_size)
        if self.policy.discrete:
            return gumbel(generator, shape, dtype)
        return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)

    def rollout(self, params, states, noise: torch.Tensor):
        """``rollout_len`` env steps (with auto-reset) under the policy's
        samples with ``noise`` (T, B, A): (final states, the (T, B, ...)
        trajectory)."""
        T, B = self.cfg.rollout_len, states.obs.shape[0]
        dt, dev = states.obs.dtype, states.obs.device
        policy = self.policy
        if policy.discrete:
            act = torch.empty(T, B, dtype=torch.long, device=dev)
        else:
            act = torch.empty(T, B, policy.action_size, dtype=dt, device=dev)
        traj = {
            "obs": torch.empty(T, B, states.obs.shape[-1], dtype=dt, device=dev),
            "action": act,
            "logp": torch.empty(T, B, dtype=dt, device=dev),
            "value": torch.empty(T, B, dtype=dt, device=dev),
            "reward": torch.empty(T, B, dtype=states.reward.dtype, device=dev),
            "terminated": torch.empty(T, B, dtype=torch.bool, device=dev),
            "done": torch.empty(T, B, dtype=torch.bool, device=dev),
            "final_value": torch.empty(T, B, dtype=dt, device=dev),
        }
        with torch.no_grad():
            for t in range(T):
                obs = states.obs
                a, logp = policy.sample(params, obs, noise[t])
                traj["obs"][t] = obs
                traj["action"][t] = a
                traj["logp"][t] = logp
                traj["value"][t] = policy.value(params, obs)
                states = self.env.step(states, a)
                traj["reward"][t] = states.reward
                traj["terminated"][t] = states.terminated
                traj["done"][t] = states.done
                traj["final_value"][t] = policy.value(params, states.info["final_obs"])
        return states, traj

    # ---- learner
    def ent_coef(self, it: int) -> float:
        """The entropy coefficient of iteration ``it``: with ``anneal_ent``
        scaled by 1 − min(it / total_iters, 1)."""
        if not self.cfg.anneal_ent:
            return self.cfg.ent_coef
        return self.cfg.ent_coef * (1.0 - min(it / self.cfg.total_iters, 1.0))

    def loss(self, params, batch: dict, ent_coef: float):
        """(total loss, {pg_loss, v_loss, entropy, approx_kl}) on one
        minibatch."""
        cfg, policy = self.cfg, self.policy
        obs = batch["obs"]
        if policy.discrete:
            logp = policy.log_prob(params, obs, batch["action"])
        else:  # one actor pass for the log-prob and the symmetry loss
            mean, std = policy.action_dist(params, obs)
            logp = gaussian_log_prob(mean, std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # population std, as jnp.std
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        v = policy.value(params, obs)
        v_clip = batch["value"] + torch.clamp(v - batch["value"], -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.mean(torch.maximum(torch.square(v - batch["ret"]),
                                                torch.square(v_clip - batch["ret"])))
        ent = torch.mean(policy.entropy(params, obs))
        total = pg_loss + cfg.vf_coef * v_loss - ent_coef * ent
        if cfg.l2_reg > 0.0:
            l2 = sum(torch.sum(torch.square(W)) for net in ("actor", "critic")
                     for W, _b in params[net])
            total = total + cfg.l2_reg * l2
        if cfg.symmetry_coef > 0.0 and self.symmetry_fn is not None:
            # gradients flow through both the mean and the mirrored mean
            obs_m, act_m = self.symmetry_fn(obs, mean)
            mean_m, _ = policy.action_dist(params, obs_m)
            total = total + cfg.symmetry_coef * torch.mean(torch.square(mean_m - act_m))
        return total, {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": ent,
            "approx_kl": torch.mean(batch["logp"] - logp),
        }

    def _apply_grads(self, params, opt_state, grads):
        """clip_by_global_norm, then Adam with the (annealed) rate."""
        cfg = self.cfg
        leaves = param_leaves(params)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < cfg.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm) for g in grads]
        count = opt_state["count"]
        count_inc = count + 1
        dt = leaves[0].dtype
        mu = [(1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, opt_state["mu"])]
        nu = [(1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, opt_state["nu"])]
        bc1 = 1 - torch.pow(ADAM_B1, count_inc.to(dt))
        bc2 = 1 - torch.pow(ADAM_B2, count_inc.to(dt))
        if cfg.anneal_lr:
            total_updates = cfg.total_iters * cfg.epochs * cfg.minibatches
            frac = 1 - torch.clamp(count, 0, total_updates).to(dt) / total_updates
            lr = cfg.lr * frac
        else:
            lr = cfg.lr
        new = [p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
               for p, m, v in zip(leaves, mu, nu)]
        return params_from_leaves(params, new), {"count": count_inc, "mu": mu, "nu": nu}

    def update(self, params, opt_state, batch: dict, ent_coef: float):
        """One minibatch update: (params, opt_state, aux)."""
        leaves = [x.detach().requires_grad_(True) for x in param_leaves(params)]
        with torch.enable_grad():
            total, aux = self.loss(params_from_leaves(params, leaves), batch, ent_coef)
            grads = torch.autograd.grad(total, leaves)
        with torch.no_grad():
            if self.all_mean is not None:
                grads = self.all_mean(grads)
            params, opt_state = self._apply_grads(params, opt_state, grads)
        return params, opt_state, {k: v.detach() for k, v in aux.items()}

    def learn(self, params, opt_state, flat: dict, perms: torch.Tensor, ent_coef: float):
        """``epochs`` × ``minibatches`` updates on the flat batch (n rows),
        epoch e's minibatches from the permutation ``perms[e]``: (params,
        opt_state, the last update's aux)."""
        cfg = self.cfg
        n = flat["adv"].shape[0]
        if n % cfg.minibatches:
            raise ValueError(f"{n} samples do not split into {cfg.minibatches} minibatches")
        mb = n // cfg.minibatches
        aux = None
        for e in range(cfg.epochs):
            shuffled = {k: v[perms[e]] for k, v in flat.items()}
            for m in range(cfg.minibatches):
                batch = {k: v[m * mb:(m + 1) * mb] for k, v in shuffled.items()}
                params, opt_state, aux = self.update(params, opt_state, batch, ent_coef)
        return params, opt_state, aux

    @staticmethod
    def flatten(traj: dict, adv: torch.Tensor, ret: torch.Tensor) -> dict:
        """The (T, B) trajectory and its advantages as one flat batch of
        T·B rows (time-major, as the reference's reshape)."""
        n = adv.numel()
        act = traj["action"]
        return {
            "obs": traj["obs"].reshape(n, -1),
            "action": act.reshape(n) if act.dim() == 2 else act.reshape(n, -1),
            "logp": traj["logp"].reshape(n),
            "value": traj["value"].reshape(n),
            "adv": adv.reshape(n),
            "ret": ret.reshape(n),
        }

    def train_step(self, carry, noise: torch.Tensor | None = None,
                   perms: torch.Tensor | None = None):
        """One PPO iteration: (carry, metrics as 0-d tensors). ``noise``
        (T, B, A) and ``perms`` (epochs, T·B) replace the carry
        generator's draws (noise first, then the permutations). The
        generators are advanced in place: the returned carry holds the
        same generator objects as the given one."""
        params, opt_state, states, gen, it = carry
        cfg = self.cfg
        n = cfg.rollout_len * states.obs.shape[0]
        if noise is None:
            noise = self.draw_noise(gen, states.obs.shape[0], states.obs.dtype)
        if perms is None:
            perms = torch.stack([torch.randperm(n, generator=gen, device=gen.device)
                                 for _ in range(cfg.epochs)])
        states, traj = self.rollout(params, states, noise)
        with torch.no_grad():
            adv, ret = _gae(traj, cfg.gamma, cfg.lam)
        params, opt_state, aux = self.learn(params, opt_state, self.flatten(traj, adv, ret),
                                            perms, self.ent_coef(it))
        metrics = {
            "reward_mean": torch.mean(traj["reward"]),
            "episode_done_frac": torch.mean(traj["done"].to(traj["reward"].dtype)),
            **aux,
        }
        if self.all_mean is not None:
            metrics = dict(zip(metrics, self.all_mean(list(metrics.values()))))
        return (params, opt_state, states, gen, it + 1), metrics


def make_train_fn(env, cfg: PPOConfig, symmetry_fn: Callable | None = None):
    """(init_fn, train_step, policy) for one device: ``init_fn(seed,
    n_envs)`` → carry; ``train_step(carry, noise=None, perms=None)`` →
    (carry, metrics). ``symmetry_fn(obs, action) → (obs_mirrored,
    action_mirrored)``: the robot's mirror; with ``cfg.symmetry_coef > 0``
    the loss adds symmetry_coef · mean‖π(mirror(obs)) − mirror(π(obs))‖².
    A data-parallel run goes through ``rl/distributed.py``."""
    ppo = PPO(env, cfg, symmetry_fn)
    return ppo.init, ppo.train_step, ppo.policy


def train(env, cfg: PPOConfig | None = None, seed: int = 0, num_iters: int = 50,
          log_every: int = 0):
    """Single-device convenience trainer: (params, policy, history), the
    history a dict of (num_iters,) tensors, one per metric."""
    cfg = cfg or PPOConfig()
    init_fn, train_step, policy = make_train_fn(env, cfg)
    carry = init_fn(seed, cfg.num_envs)
    history = []
    for i in range(num_iters):
        carry, metrics = train_step(carry)
        if log_every and i % log_every == 0:
            print(f"iter {i}: {({k: float(v) for k, v in metrics.items()})}")
        history.append(metrics)
    return carry[0], policy, {k: torch.stack([m[k] for m in history]) for k in history[0]}
