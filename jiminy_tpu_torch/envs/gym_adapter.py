"""Gymnasium adapter: one env of a batched env as a ``gymnasium.Env``.

Counterpart of ``jiminy_tpu/envs/gym_adapter.py``: a thin shell over the
batched core, a batch of one driven through ``step_no_reset`` (the caller
resets at the end of an episode, as gymnasium's protocol has it), for
interactive use and the gymnasium ecosystem. Needs ``gymnasium``
(``ImportError`` without it). ``render`` draws the current state with the
3-D viewer (:func:`jiminy_tpu_torch.viewer3d.render_env`, PIL).
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces

    _HAS_GYM = True
except ImportError:  # pragma: no cover
    _HAS_GYM = False


def make_gym_env(env, seed: int = 0):
    """A ``gymnasium.Env`` over ``env`` (a batched env or a pipeline of
    one), on ``env``'s device; its episodes drawn from a generator seeded
    ``seed`` (``reset(seed=...)`` reseeds it)."""
    if not _HAS_GYM:
        raise ImportError("gymnasium is not available")

    class _Adapter(gymnasium.Env):
        metadata = {"render_modes": ["rgb_array"]}

        def __init__(self):
            self._env = env
            self._state = None
            self._generator = torch.Generator(device=env.device).manual_seed(seed)
            n_disc = env.discrete_actions
            if n_disc is not None:
                self.action_space = spaces.Discrete(n_disc)
            else:
                self.action_space = spaces.Box(low=-1.0, high=1.0, shape=(env.action_size,),
                                               dtype=np.float32)
            self.observation_space = spaces.Box(low=-np.inf, high=np.inf,
                                                shape=(env.observation_size,), dtype=np.float32)

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._generator.manual_seed(seed)
            self._state = self._env.reset(self._generator, 1)
            return self._state.obs[0].cpu().numpy(), {}

        def step(self, action):
            a = torch.as_tensor(np.asarray(action), device=self._env.device)
            a = a.reshape(1) if self._env.discrete_actions is not None else \
                a.reshape(1, -1).to(self._state.obs.dtype)
            self._state = s = self._env.step_no_reset(self._state, a)
            return (s.obs[0].cpu().numpy(), float(s.reward[0]), bool(s.terminated[0]),
                    bool(s.truncated[0]), {})

        def render(self):
            """An rgb_array frame (400, 400, 3) uint8: the shaded 3-D view
            of the current state on the episode's own ground."""
            from jiminy_tpu_torch.viewer3d import render_env

            return render_env(self._env, self._state)

    return _Adapter()
