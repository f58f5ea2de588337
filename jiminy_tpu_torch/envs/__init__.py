"""Batched RL environments and the declarative layer (quantities,
compositions, blocks, pipeline wrappers, the gymnasium adapter and its
registry)."""

from jiminy_tpu_torch.envs.acrobot import AcrobotEnv  # noqa: F401
from jiminy_tpu_torch.envs.anymal import (  # noqa: F401
    ANYmalEnv,
    ANYmalGantryEnv,
    anymal_declarative_mdp,
)
from jiminy_tpu_torch.envs.base import (  # noqa: F401
    BaseEnv,
    EnvState,
    env_state_from_arrays,
)
from jiminy_tpu_torch.envs.cartpole import CartPoleEnv  # noqa: F401
from jiminy_tpu_torch.envs.legged import AntEnv, AtlasEnv, CassieEnv, SpotmicroEnv  # noqa: F401
from jiminy_tpu_torch.envs.locomotion import WalkerEnv  # noqa: F401
from jiminy_tpu_torch.envs.pipeline import (  # noqa: F401
    build_pipeline,
    freeze_pipeline_stats,
    wrapper_state_from_arrays,
)
from jiminy_tpu_torch.envs.registration import register_envs  # noqa: F401
