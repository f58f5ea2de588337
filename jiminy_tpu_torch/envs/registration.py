"""Gymnasium registration of the env zoo.

Counterpart of ``jiminy_tpu/envs/registration.py``, under this package's
namespace, so that both packages can register in one process: call
:func:`register_envs` once, then ``gymnasium.make("jiminy_tpu_torch/ANYmal-v0",
device="cpu")``. ``device`` (default ``"cuda"``) and the env's own options
go to its constructor, ``seed`` to :func:`~jiminy_tpu_torch.envs.gym_adapter.make_gym_env`.
"""

from __future__ import annotations

_SPECS = {
    "jiminy_tpu_torch/CartPole-v0": ("jiminy_tpu_torch.envs", "CartPoleEnv"),
    "jiminy_tpu_torch/Acrobot-v0": ("jiminy_tpu_torch.envs", "AcrobotEnv"),
    "jiminy_tpu_torch/ANYmal-v0": ("jiminy_tpu_torch.envs", "ANYmalEnv"),
    "jiminy_tpu_torch/Cassie-v0": ("jiminy_tpu_torch.envs.legged", "CassieEnv"),
    "jiminy_tpu_torch/Atlas-v0": ("jiminy_tpu_torch.envs.legged", "AtlasEnv"),
    "jiminy_tpu_torch/Ant-v0": ("jiminy_tpu_torch.envs.legged", "AntEnv"),
    "jiminy_tpu_torch/Spotmicro-v0": ("jiminy_tpu_torch.envs.legged", "SpotmicroEnv"),
}


def _factory(module: str, cls: str):
    def make(**kwargs):
        import importlib

        from jiminy_tpu_torch.envs.gym_adapter import make_gym_env

        env_cls = getattr(importlib.import_module(module), cls)
        seed = kwargs.pop("seed", 0)
        return make_gym_env(env_cls(**kwargs), seed=seed)

    return make


def register_envs() -> list[str]:
    """Register every bundled env with gymnasium; returns the IDs."""
    import gymnasium

    for env_id, (module, cls) in _SPECS.items():
        if env_id not in gymnasium.registry:
            gymnasium.register(id=env_id, entry_point=_factory(module, cls),
                               disable_env_checker=True)
    return list(_SPECS)
