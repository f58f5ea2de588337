"""Batched RL environments."""

from jiminy_tpu_torch.envs.anymal import ANYmalEnv  # noqa: F401
from jiminy_tpu_torch.envs.base import (  # noqa: F401
    BaseEnv,
    EnvState,
    env_state_from_arrays,
)
