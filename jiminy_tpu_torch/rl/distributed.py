"""Data-parallel PPO over ``torch.distributed``.

Counterpart of ``jiminy_tpu/rl/distributed.py``. The reference runs one
SPMD program over a device mesh: the env batch sharded on a ``data``
axis, the learner's params replicated, the grads and metrics averaged
with ``pmean``. Here each rank is a process (one per GPU under NCCL; gloo
processes on the CPU, or several on one card) that holds its shard of
the global batch: rank r of W holds envs [r·B/W, (r+1)·B/W) of
``cfg.num_envs`` = B, as the reference's ``P(axis)`` sharding lays them
out. The params are replicated, rank 0's broadcast at init. :class:`PPO`
gets the ``all_mean`` hook (``rl/ppo.py``): one all-reduce sum over the
group divided by W, the reference's ``pmean``; every rank receives the
same bits, so the params stay identical on every rank.

Per-rank draws: the reference folds the shard index into its rollout and
permutation keys. Here rank r > 0 reseeds its run generator (which draws
the action noise and the permutations) with ``seed + 2 + r·RANK_SEED_STRIDE``
and its envs' auto-reset generator with ``seed + 1 + r·RANK_SEED_STRIDE``;
rank 0 keeps the single-device run's generators, so that at world size 1
a train step is the single-device one bit for bit.

A checkpoint saved by W ranks restores at any world size W′ whose ranks
share the rows evenly (``checkpoint.py``): at W′ = W each rank gets its
own generators back; at W′ ≠ W rank 0 takes rank 0's saved ones, and
rank r′ > 0 takes :func:`rank_generators` of rank 0's saved run
generator: the port's ``fold_in``. Unlike the reference's per-env keys,
which move with their rows, the ranks > 0 then draw new streams.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from jiminy_tpu_torch.rl.networks import param_leaves
from jiminy_tpu_torch.rl.ppo import PPO, PPOConfig

RANK_SEED_STRIDE = 1_000_003  # the agreed offset between two ranks' seeds


def shard_rows(x, start: int, stop: int):
    """Rows [start, stop) of every batched tensor in ``x`` (an env state:
    dataclasses, dicts and tuples of (B, ...) tensors), copied; 0-d
    tensors, generators and other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return x[start:stop].clone() if x.dim() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: shard_rows(getattr(x, f.name), start, stop)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: shard_rows(v, start, stop) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(shard_rows(v, start, stop) for v in x)
    return x


def rank_generators(run_gen: torch.Generator, rank: int, device) -> tuple:
    """(env generator, run generator) of rank ``rank`` > 0 after a restore
    at another world size: one seed s in [0, 2⁶²) drawn from a clone of
    ``run_gen`` (rank 0's restored run generator, which does not move),
    then ``init_fn``'s layout with s for the seed: the env generator
    seeded s + 1 + rank·RANK_SEED_STRIDE, the run generator s + 2 +
    rank·RANK_SEED_STRIDE, both on ``device``."""
    clone = torch.Generator(device=run_gen.device)
    clone.set_state(run_gen.get_state())
    s = int(torch.randint(0, 2**62, (), generator=clone, device=run_gen.device))
    return tuple(torch.Generator(device=device).manual_seed(s + k + rank * RANK_SEED_STRIDE)
                 for k in (1, 2))


def all_mean_fn(group=None) -> Callable:
    """The ``all_mean`` hook over ``group``: the mean over its ranks of
    each tensor of a list, in one all-reduce of their concatenation."""
    world = dist.get_world_size(group)

    def all_mean(tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        flat = flat / world
        # each mean in the layout (strides) of the tensor it replaces: a
        # gradient may be a transposed view, and a reduction over it (the
        # clip's global norm) sums in the order of that layout
        out = [torch.empty_like(t) for t in tensors]
        for o, c in zip(out, flat.split([t.numel() for t in tensors])):
            o.copy_(c.view(o.shape))
        return out

    return all_mean


def make_distributed_train(env, cfg: PPOConfig, group=None, symmetry_fn: Callable | None = None):
    """(init_fn, train_step, policy) of this rank of ``group`` (None: the
    default group). ``cfg.num_envs`` is the global batch, which must divide
    by world size × minibatches (ValueError, as the reference's).
    ``init_fn(seed)`` → this rank's carry (params, Adam's state, its envs,
    its run generator, 0); ``train_step(carry, noise=None, perms=None)`` →
    (carry, metrics averaged over the ranks), ``noise`` (T, B/W, A) and
    ``perms`` (epochs, T·B/W) replacing this rank's draws."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if cfg.num_envs % (world * cfg.minibatches) != 0:
        raise ValueError(f"num_envs={cfg.num_envs} must divide by world size {world} "
                         f"× minibatches {cfg.minibatches}")
    ppo = PPO(env, cfg, symmetry_fn, all_mean_fn(group))
    src = 0 if group is None else dist.get_global_rank(group, 0)

    def init_fn(seed: int):
        params, opt_state, states, run_gen, it = ppo.init(seed, cfg.num_envs)
        n = cfg.num_envs // world
        states = shard_rows(states, rank * n, (rank + 1) * n)
        if rank:
            states.generator = torch.Generator(device=states.generator.device).manual_seed(
                seed + 1 + rank * RANK_SEED_STRIDE)
            run_gen.manual_seed(seed + 2 + rank * RANK_SEED_STRIDE)
        for x in param_leaves(params):  # each leaf keeps its storage and strides
            buf = x.contiguous()  # NCCL broadcasts contiguous tensors only
            dist.broadcast(buf, src=src, group=group)
            x.copy_(buf)
        return (params, opt_state, states, run_gen, it)

    return init_fn, ppo.train_step, ppo.policy
