"""Policy and value networks as plain parameter trees of tensors.

Counterpart of ``jiminy_tpu/rl/networks.py``. The parameters are a dict
``{"actor": [[W, b], ...], "critic": [[W, b], ...], "log_std": (A,)}``
(``log_std`` for continuous actions only), each ``W`` (in, out) so that a
layer is ``x @ W + b``, as the reference's: weights cross between the two
packages as arrays (:func:`policy_params_from_arrays`). The policy is a
few small products outside any kernel in the reference, so here it is
``torch.nn.functional.linear``; float32 at full precision (the package
turns TF32 off).

The reference's PRNG keys become a ``torch.Generator``: ``init_mlp`` and
``MLPPolicy.init`` draw from one, ``MLPPolicy.sample`` from one or takes
its noise as a tensor (standard normal for continuous actions, standard
Gumbel for discrete ones, which is how ``jax.random.categorical``
samples), so that a test can hand in the reference's draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _orthogonal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    a = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    q, r = torch.linalg.qr(a if shape[0] >= shape[1] else a.T)
    q = q * torch.sign(torch.diagonal(r))
    if shape[0] < shape[1]:
        q = q.T
    return scale * q[: shape[0], : shape[1]]


def init_mlp(generator: torch.Generator, sizes: Sequence[int], out_scale: float = 0.01,
             dtype=torch.float32) -> list:
    """[[W, b], ...] with orthogonal W (PPO standard): gain √2 on the
    hidden layers, ``out_scale`` on the last; zero biases. Drawn from
    ``generator``, on its device."""
    params = []
    for i in range(len(sizes) - 1):
        scale = out_scale if i == len(sizes) - 2 else float(np.sqrt(2.0))
        W = _orthogonal(generator, (sizes[i], sizes[i + 1]), scale, dtype)
        params.append([W, torch.zeros(sizes[i + 1], dtype=dtype, device=W.device)])
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, (W, b) in enumerate(params):
        x = F.linear(x, W.T, b)
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def gaussian_log_prob(mean, std, action):
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * math.log(2.0 * math.pi), dim=-1)


def categorical_log_prob(logits, action):
    logp_all = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp_all, -1, action.long()[..., None])[..., 0]


class MLPPolicy:
    """Actor-critic bundle: continuous (diagonal Gaussian) or discrete
    (categorical) actor and a value head, as functions of a params dict."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        discrete: bool = False,
        hidden: Sequence[int] = (256, 256),
    ):
        self.obs_size = obs_size
        self.action_size = action_size
        self.discrete = discrete
        self.hidden = tuple(hidden)

    def init(self, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
        """Fresh params drawn from ``generator`` (the actor's layers, then
        the critic's), moved to ``device`` (default: the generator's)."""
        params = {
            "actor": init_mlp(generator, (self.obs_size, *self.hidden, self.action_size),
                              dtype=dtype),
            "critic": init_mlp(generator, (self.obs_size, *self.hidden, 1), 1.0, dtype=dtype),
        }
        if not self.discrete:
            params["log_std"] = torch.zeros(self.action_size, dtype=dtype,
                                            device=generator.device)
        return params if device is None else map_params(lambda x: x.to(device), params)

    def value(self, params, obs) -> torch.Tensor:
        return mlp_apply(params["critic"], obs)[..., 0]

    def action_dist(self, params, obs):
        """Distribution parameters: logits (discrete) or (mean, std)."""
        out = mlp_apply(params["actor"], obs)
        if self.discrete:
            return out
        return out, torch.exp(params["log_std"])

    def sample(self, params, obs, noise=None, generator=None):
        """(action, log_prob). ``noise``: the draws, standard normal (…, A)
        for continuous actions, standard Gumbel (…, n) for discrete ones
        (the action is argmax(logits + noise)); else drawn from
        ``generator``."""
        if self.discrete:
            logits = self.action_dist(params, obs)
            if noise is None:
                noise = gumbel(generator, logits.shape, logits.dtype)
            a = torch.argmax(logits + noise, dim=-1)
            return a, categorical_log_prob(logits, a)
        mean, std = self.action_dist(params, obs)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=generator.device).to(mean.device)
        a = mean + std * noise
        return a, gaussian_log_prob(mean, std, a)

    def log_prob(self, params, obs, action):
        if self.discrete:
            return categorical_log_prob(self.action_dist(params, obs), action)
        mean, std = self.action_dist(params, obs)
        return gaussian_log_prob(mean, std, action)

    def entropy(self, params, obs):
        """Per observation for discrete actions; one scalar (the same for
        every observation) for continuous ones, as the reference's."""
        if self.discrete:
            logits = self.action_dist(params, obs)
            return -torch.sum(torch.softmax(logits, -1) * torch.log_softmax(logits, -1), dim=-1)
        std = torch.exp(params["log_std"])
        return torch.sum(0.5 * math.log(2.0 * math.pi * math.e) + torch.log(std))


def gumbel(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform in [tiny, 1), on the
    generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def map_params(fn, params: dict) -> dict:
    """``fn`` applied to every tensor of a params dict (same structure)."""
    return {k: fn(v) if isinstance(v, torch.Tensor) else [[fn(W), fn(b)] for W, b in v]
            for k, v in params.items()}


def param_leaves(params: dict) -> list:
    """The params' tensors in the reference's leaf order (keys sorted;
    each net's layers in order, W before b)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend([v] if isinstance(v, torch.Tensor) else [x for layer in v for x in layer])
    return out


def params_from_leaves(template: dict, leaves) -> dict:
    """The inverse of :func:`param_leaves`: ``template``'s structure with
    ``leaves`` in its order."""
    it = iter(leaves)
    out = {}
    for k in sorted(template):
        v = template[k]
        out[k] = next(it) if isinstance(v, torch.Tensor) else [[next(it), next(it)] for _ in v]
    return {k: out[k] for k in template}


def policy_params_from_arrays(tree, device="cpu", dtype=torch.float32) -> dict:
    """The reference's policy params, as nested arrays (``{"actor": [[W,
    b], ...], "critic": ..., "log_std": ...}``, lists or tuples; numpy or
    any array that ``np.array`` takes, copied), as the port's params."""

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    out = {}
    for k in ("actor", "critic"):
        out[k] = [[t(W), t(b)] for W, b in tree[k]]
    if "log_std" in tree:
        out["log_std"] = t(tree["log_std"])
    return out
