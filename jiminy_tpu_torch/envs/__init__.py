"""Batched RL environments."""

from jiminy_tpu_torch.envs.acrobot import AcrobotEnv  # noqa: F401
from jiminy_tpu_torch.envs.anymal import ANYmalEnv, ANYmalGantryEnv  # noqa: F401
from jiminy_tpu_torch.envs.base import (  # noqa: F401
    BaseEnv,
    EnvState,
    env_state_from_arrays,
)
from jiminy_tpu_torch.envs.cartpole import CartPoleEnv  # noqa: F401
from jiminy_tpu_torch.envs.legged import AntEnv, AtlasEnv, CassieEnv, SpotmicroEnv  # noqa: F401
