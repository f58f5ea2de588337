"""The walker envs' options and the engine's contact-model default, as the
reference has them.

- The options that the reference's ``ANYmalEnv`` and ``CassieEnv`` pass on
  to ``WalkerEnv`` and ``BaseEnv`` through ``**kwargs`` reach the port's
  env: ``min_height``, ``max_tilt_cos`` and ``nan_guard`` on ANYmal;
  ``max_tilt_cos``, ``nan_guard``, ``ground``, ``ground_sampler`` and
  ``spawn_radius`` on Cassie.
- ``nan_guard`` (default True, ``jiminy_tpu/envs/base.py``): with it a
  non-finite env terminates with zero reward and observation; without it
  the NaN runs on and the env is not terminated (the reference's
  ``tests/test_health.py::test_guard_can_be_disabled``).
- ``EngineOptions.contact_model`` defaults to the reference's
  ``"spring_damper"``, which ``Engine`` refuses naming ROADMAP A.16, and
  the walker envs ask for ``"constraint"`` as the reference's do.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.ground import FlatGround, sample_fourier_ground
from jiminy_tpu_torch.envs import ANYmalEnv, CassieEnv
from jiminy_tpu_torch.models.quadruped import make_anymal

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)


def _fourier(generator, batch_shape):
    return sample_fourier_ground(generator, n_terms=4, amplitude=0.03, wavelength=1.5,
                                 octaves=1, batch_shape=batch_shape)


FLAT = FlatGround(height=0.05)
CASES = [
    (ANYmalEnv, "min_height", 0.25, lambda env: env.min_height == 0.25),
    (ANYmalEnv, "max_tilt_cos", 0.5, lambda env: env.max_tilt_cos == 0.5),
    (ANYmalEnv, "nan_guard", False, lambda env: env.nan_guard is False),
    (CassieEnv, "max_tilt_cos", 0.5, lambda env: env.max_tilt_cos == 0.5),
    (CassieEnv, "nan_guard", False, lambda env: env.nan_guard is False),
    (CassieEnv, "ground", FLAT, lambda env: env.engine.substep_spec.ground_height == 0.05),
    (CassieEnv, "ground_sampler", _fourier,
     lambda env: env.engine.substep_spec.ground_mode == "fourier"
     and env.reset(torch.Generator().manual_seed(0), 2).info["ground"].shape == (2, 16)),
    (CassieEnv, "spawn_radius", 0.5,
     lambda env: env.spawn_radius == 0.5
     and float(env.reset(torch.Generator().manual_seed(0), 8).sim.q[:, :2].abs().max()) > 0.0),
]


@pytest.mark.parametrize("cls, option, value, reached", CASES,
                         ids=[f"{c.__name__}-{o}" for c, o, _, _ in CASES])
def test_option_reaches_the_env(cls, option, value, reached):
    env = cls(observe="state", device="cpu", **{option: value})
    assert reached(env)
    assert env.engine.options.contact_model == "constraint"


@pytest.mark.parametrize("nan_guard", [True, False])
def test_nan_guard(nan_guard):
    env = ANYmalEnv(observe="state", nan_guard=nan_guard, device="cpu")
    st = env.reset(torch.Generator().manual_seed(0), 2)
    v = st.sim.v.clone()
    v[0, 0] = float("nan")
    nxt = env.step_no_reset(st.replace(sim=dataclasses.replace(st.sim, v=v)), torch.zeros(2, 12))
    assert not bool(torch.isfinite(nxt.sim.v[0]).all()) and bool(torch.isfinite(nxt.sim.v[1]).all())
    assert bool(nxt.terminated[0]) == nan_guard and not bool(nxt.terminated[1])
    if nan_guard:
        assert float(nxt.reward[0]) == 0.0 and bool((nxt.obs[0] == 0).all())
    else:
        assert not bool(torch.isfinite(nxt.obs[0]).all())
    assert bool(torch.isfinite(nxt.obs[1]).all())


def test_contact_model_default_is_the_reference_s():
    assert EngineOptions().contact_model == JEngineOptions().contact_model == "spring_damper"
    tree, motors, _ = make_anymal(device="cpu")
    with pytest.raises(NotImplementedError, match="A.16"):
        Engine(tree, motors=motors, device="cpu")
    with pytest.raises(NotImplementedError, match="A.16"):
        Engine(tree, EngineOptions(dt=5e-3), motors=motors, device="cpu")
    eng = Engine(tree, EngineOptions(dt=5e-3, contact_model="constraint"), motors=motors,
                 device="cpu")
    assert eng.backend == "substep" and eng.nc == 12 + 3 * tree.ncp
