"""Pipeline: observer and controller layers wrapped around an env.

Counterpart of ``jiminy_tpu/envs/pipeline.py`` (the reference's pipeline:
observer and controller blocks layered as env wrappers,
``ObservedJiminyEnv`` / ``ControlledJiminyEnv``, observation stacking and
normalization wrappers, and a declarative ``build_pipeline``).

Each layer is a (reset, step) pair over a :class:`WrapperState`: the
wrapped env's state and the layer's own (block states, FIFOs, running
statistics) as dicts of (B, ...) tensors. ``info["final_obs"]`` is
threaded through every layer, computed from the layer state before the
step's auto-reset and, for layers that read the sensor buffers, on the
finished episode's buffers (``info["final_sensor_bufs"]``), so PPO's
bootstrap at a truncation sees the wrapped terminal observation at any
depth. As in the reference, whose pipeline is one env vmapped by PPO,
every layer's state is per env: the normalization statistics are (B, d)
means and variances and a (B,) count.

A wrapper exposes the reference's metadata (``action_size``,
``discrete_actions``, ``observation_size``, ``unwrapped``) and the
port's ``device`` and ``termination_meaning``, and nothing else of the
env it wraps: no ``symmetry_fn`` (the inner env's mirror is of another
observation layout), so PPO trains a pipeline without the symmetry loss,
as ``examples/train.py`` does.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, Callable

import numpy as np
import torch

from jiminy_tpu_torch.envs.base import env_state_from_arrays


@dataclasses.dataclass
class WrapperState:
    """One layer's state: the wrapped env's state ``inner`` and the
    layer's ``layer``; the learner-facing fields pass through from the
    innermost env state."""

    inner: Any
    layer: Any
    obs: torch.Tensor
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def reward(self):
        return self.inner.reward

    @property
    def terminated(self):
        return self.inner.terminated

    @property
    def truncated(self):
        return self.inner.truncated

    @property
    def done(self):
        return self.inner.done

    @property
    def steps(self):
        return self.inner.steps

    @property
    def sim(self):
        return self.inner.sim

    @property
    def generator(self):
        return self.inner.generator

    def replace(self, **kw) -> "WrapperState":
        return dataclasses.replace(self, **kw)


def _pick(done: torch.Tensor, a, b):
    """``a`` where ``done`` (B,) else ``b``, leaf by leaf over dicts,
    lists and tuples of (B, ...) tensors."""
    if isinstance(a, dict):
        return {k: _pick(done, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_pick(done, x, y) for x, y in zip(a, b))
    return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _base(env):
    while isinstance(env, EnvWrapper):
        env = env.env
    return env


class EnvWrapper:
    """The identity layer; subclasses override the hooks. Presents the
    env interface: ``reset(generator, batch_size)``, ``step``,
    ``step_no_reset`` and the sizes."""

    def __init__(self, env):
        self.env = env
        self._observation_size = None

    # ---- metadata: the reference's, and the port's device and termination_meaning
    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def discrete_actions(self):
        return self.env.discrete_actions

    @property
    def observation_size(self) -> int:
        """From one reset of one env (a fixed seed), then cached."""
        if self._observation_size is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self._observation_size = int(self.reset(gen, 1).obs.shape[-1])
        return self._observation_size

    @property
    def unwrapped(self):
        return _base(self.env)

    @property
    def device(self):
        return self.env.device

    @property
    def termination_meaning(self) -> str:
        return self.env.termination_meaning

    # ---- hooks
    def _init_layer(self, generator: torch.Generator, inner_state):
        """The layer state of fresh episodes, batched as ``inner_state``."""
        return {}

    def _transform_action(self, layer, action, inner_state):
        """→ (layer', the inner env's action)."""
        return layer, action

    def _transform_obs(self, layer, obs, inner_state):
        """→ (layer', the wrapped observation). Also gives the terminal
        observation, whose layer' is dropped."""
        return layer, obs

    # ---- machinery
    def reset(self, generator: torch.Generator, batch_size: int) -> WrapperState:
        inner = self.env.reset(generator, batch_size)
        layer = self._init_layer(generator, inner)
        layer, obs = self._transform_obs(layer, inner.obs, inner)
        info = dict(inner.info)
        info["final_obs"] = obs
        return WrapperState(inner=inner, layer=layer, obs=obs, info=info)

    def step(self, state: WrapperState, action) -> WrapperState:
        layer, inner_action = self._transform_action(state.layer, action, state.inner)
        inner = self.env.step(state.inner, inner_action)
        # the terminal observation from the layer state before the reset,
        # on the finished episode's sensor buffers
        inner_final = inner
        if "final_sensor_bufs" in inner.info:
            inner_final = inner.replace(
                info={**inner.info, "sensor_bufs": inner.info["final_sensor_bufs"]})
        _, final_obs = self._transform_obs(layer, inner.info["final_obs"], inner_final)
        # where the episode ended the layer restarts with it; computed for
        # every env and picked
        fresh = self._init_layer(state.inner.generator, inner)
        layer_next, obs = self._transform_obs(_pick(inner.done, fresh, layer), inner.obs, inner)
        info = dict(inner.info)
        info["final_obs"] = final_obs
        return WrapperState(inner=inner, layer=layer_next, obs=obs, info=info)

    def step_no_reset(self, state: WrapperState, action) -> WrapperState:
        layer, inner_action = self._transform_action(state.layer, action, state.inner)
        inner = self.env.step_no_reset(state.inner, inner_action)
        layer, obs = self._transform_obs(layer, inner.obs, inner)
        info = dict(inner.info)
        info["final_obs"] = obs
        return WrapperState(inner=inner, layer=layer, obs=obs, info=info)


def _like(inner_state) -> dict:
    return {"device": inner_state.obs.device, "dtype": inner_state.obs.dtype}


class ControlledEnv(EnvWrapper):
    """Controller layer: the policy's action goes through ``block`` to the
    inner env. ``inputs_fn(inner_state) → dict`` gives the block's
    feedback inputs (none by default); ``action_size`` the policy's action
    size where it differs from the inner env's."""

    def __init__(self, env, block, inputs_fn: Callable | None = None,
                 action_size: int | None = None):
        super().__init__(env)
        self.block = block
        self._action_size = action_size
        self.inputs_fn = inputs_fn

    @property
    def action_size(self) -> int:
        return self._action_size or self.env.action_size

    def _init_layer(self, generator, inner_state):
        B = inner_state.obs.shape[0]
        if "q0" in inspect.signature(self.block.init).parameters:
            return self.block.init(generator, B, q0=inner_state.sim.q, **_like(inner_state))
        return self.block.init(generator, B, **_like(inner_state))

    def _transform_action(self, layer, action, inner_state):
        inputs = self.inputs_fn(inner_state) if self.inputs_fn is not None else {}
        return self.block.apply(layer, action, **inputs)


class ObservedEnv(EnvWrapper):
    """Observer layer: ``block``'s output, fed by ``inputs_fn(inner_state)
    → dict``, is appended to the inner observation."""

    def __init__(self, env, block, inputs_fn: Callable):
        super().__init__(env)
        self.block = block
        self.inputs_fn = inputs_fn

    def _init_layer(self, generator, inner_state):
        return self.block.init(generator, inner_state.obs.shape[0], **_like(inner_state))

    def _transform_obs(self, layer, obs, inner_state):
        layer, out = self.block.apply(layer, **self.inputs_fn(inner_state))
        return layer, torch.cat([obs, out.reshape(obs.shape[0], -1)], dim=-1)


class StackedObsEnv(EnvWrapper):
    """The last ``n`` inner observations, newest first; the layer is the
    FIFO of the n − 1 before, (B, n − 1, d), zero after a reset."""

    def __init__(self, env, n: int):
        super().__init__(env)
        self.n = n

    def _init_layer(self, generator, inner_state):
        B, d = inner_state.obs.shape
        return torch.zeros(B, self.n - 1, d, **_like(inner_state))

    def _transform_obs(self, layer, obs, inner_state):
        stacked = torch.cat([obs[:, None], layer], dim=1)
        return stacked[:, : self.n - 1], stacked.reshape(obs.shape[0], -1)


class NormalizedObsEnv(EnvWrapper):
    """Running mean and variance normalization, clipped to ±``clip``. The
    statistics are each env's, (B, d) ``mean`` and ``var`` and a (B,)
    ``count``; they update from each step's observation (after an
    auto-reset, the new episode's first) and persist across resets.
    ``update=False`` freezes them; ``stats`` ({"mean", "var"[, "count"]},
    each (d,)) starts every fresh env from them instead of unit
    statistics (see :func:`freeze_pipeline_stats`)."""

    def __init__(self, env, clip: float = 10.0, update: bool = True, eps: float = 1e-6,
                 stats: dict | None = None):
        super().__init__(env)
        self.clip = clip
        self.update = update
        self.eps = eps
        self.stats = stats

    def _init_layer(self, generator, inner_state):
        (B, d), like = inner_state.obs.shape, _like(inner_state)
        if self.stats is not None:
            return {
                "mean": torch.as_tensor(self.stats["mean"], **like).expand(B, d).clone(),
                "var": torch.as_tensor(self.stats["var"], **like).expand(B, d).clone(),
                "count": torch.full((B,), float(self.stats.get("count", 1.0)), **like),
            }
        return {"mean": torch.zeros(B, d, **like), "var": torch.ones(B, d, **like),
                "count": torch.full((B,), self.eps, **like)}

    def step(self, state: WrapperState, action) -> WrapperState:
        layer = state.layer
        inner = self.env.step(state.inner, action)
        if self.update:
            x = inner.obs
            count = layer["count"] + 1.0
            delta = x - layer["mean"]
            mean = layer["mean"] + delta / count[:, None]
            var = layer["var"] + (delta * (x - mean) - layer["var"]) / count[:, None]
            layer = {"mean": mean, "var": var, "count": count}
        _, obs = self._transform_obs(layer, inner.obs, inner)
        _, final_obs = self._transform_obs(layer, inner.info["final_obs"], inner)
        info = dict(inner.info)
        info["final_obs"] = final_obs
        return WrapperState(inner=inner, layer=layer, obs=obs, info=info)

    def _transform_obs(self, layer, obs, inner_state):
        z = (obs - layer["mean"]) / torch.sqrt(layer["var"] + self.eps)
        return layer, torch.clamp(z, -self.clip, self.clip)


def mahony_layer(env, kp: float = 1.0, ki: float = 0.1):
    """Observer layer of a :class:`~jiminy_tpu_torch.envs.blocks.MahonyFilter`
    at the env's step: it reads (gyro, accel) from the base env's first
    IMU through the sensor buffers (``info["sensor_bufs"]``, the delayed,
    corrupted readings the policy sees) and appends the attitude estimate
    (4) to the observation. Needs an env with an IMU
    (``observe="sensors"``)."""
    from jiminy_tpu_torch.envs.blocks import MahonyFilter

    base = _base(env)
    suite = getattr(base, "sensors", None)
    if suite is None or not any(g.type == "imu" for g in suite.groups):
        raise ValueError("the mahony layer needs an env with an IMU sensor suite "
                         "(walker envs: observe='sensors')")
    block = MahonyFilter(dt=base.step_dt, kp=kp, ki=ki)

    def inputs_fn(inner_state):
        imu = suite.read(suite.unflatten_buffers(inner_state.info["sensor_bufs"]))["imu"][:, 0]
        return {"gyro": imu[:, 4:7], "accel": imu[:, 7:10]}

    return ObservedEnv(env, block, inputs_fn)


_WRAPPERS = {
    "controller": ControlledEnv,
    "observer": ObservedEnv,
    "stack": StackedObsEnv,
    "normalize": NormalizedObsEnv,
    "mahony": mahony_layer,
}


def build_pipeline(env, layers: list[dict]):
    """Wrap ``env`` in ``layers``, innermost first: each {"type": one of
    controller, observer, stack, normalize, mahony, **its arguments}."""
    for spec in layers:
        spec = dict(spec)
        env = _WRAPPERS[spec.pop("type")](env, **spec)
    return env


def freeze_pipeline_stats(env, states):
    """The evaluation twin of a trained pipeline: every
    :class:`NormalizedObsEnv` layer rebuilt frozen at the mean over the
    batch (axis 0) of ``states``' per-env statistics, so that fresh
    evaluation episodes normalize as training did; the other layers are
    shallow copies over the same base env. ``states``: live
    :class:`WrapperState` s, or the nested dicts of a checkpoint read
    without a template (this package's ``restore_raw`` or the
    reference's)."""

    def get(s, k):
        return s[k] if isinstance(s, dict) else getattr(s, k)

    if not isinstance(env, EnvWrapper):
        return env
    inner = freeze_pipeline_stats(env.env, get(states, "inner"))
    if isinstance(env, NormalizedObsEnv):
        layer = get(states, "layer")

        def batch_mean(x):  # accumulated in float64: the exactly rounded mean
            x = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
            return torch.mean(x.double(), dim=0).to(x.dtype)

        return NormalizedObsEnv(inner, clip=env.clip, update=False, eps=env.eps,
                                stats={"mean": batch_mean(layer["mean"]),
                                       "var": batch_mean(layer["var"])})
    new = copy.copy(env)
    new.env = inner
    return new


def _tensors(x, device, dtype):
    """Nested numpy arrays → tensors on ``device``, floats in ``dtype``."""
    if isinstance(x, dict):
        return {k: _tensors(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors(v, device, dtype) for v in x)
    a = np.array(x)
    return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None, device=device)


def wrapper_state_from_arrays(env, d: dict, generator: torch.Generator,
                              dtype=torch.float32):
    """The state of the pipeline ``env`` from the reference's batched
    (vmapped) ``WrapperState`` as nested numpy arrays: ``d["inner"]``,
    ``d["layer"]`` (a block's state as a mapping of its fields),
    ``d["obs"]`` and ``d["info"]["final_obs"]`` at each layer, the
    innermost an ``EnvState``'s fields for ``env_state_from_arrays``. Its
    sensor ring buffers (``sensor_bufs``, ``final_sensor_bufs``), one
    array per group in the reference, become the port's flat (B, n_buf)
    rows; ``generator`` takes the place of its PRNG key. A layer's info
    is its inner state's with its own ``final_obs``, as the reference
    builds it. On ``env``'s device."""
    base = _base(env)
    dev = base.device

    def build(e, x):
        if not isinstance(e, EnvWrapper):
            info = dict(x.get("info", {}))
            for k in ("sensor_bufs", "final_sensor_bufs"):
                if isinstance(info.get(k), (list, tuple)):
                    info[k] = np.concatenate([np.asarray(b).reshape(len(b), -1)
                                              for b in info[k]], 1)
            return env_state_from_arrays({**x, "info": info}, generator, device=dev, dtype=dtype,
                                         engine=getattr(base, "engine", None))
        inner = build(e.env, x["inner"])
        info = dict(inner.info)
        info["final_obs"] = _tensors(x["info"]["final_obs"], dev, dtype)
        return WrapperState(inner=inner, layer=_tensors(x["layer"], dev, dtype),
                            obs=_tensors(x["obs"], dev, dtype), info=info)

    return build(env, d)
