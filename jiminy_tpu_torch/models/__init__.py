"""Robot models built by the port itself (no reference import)."""

from jiminy_tpu_torch.models.ant import make_ant  # noqa: F401
from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs, make_cassie  # noqa: F401
from jiminy_tpu_torch.models.humanoid import (  # noqa: F401
    ATLAS,
    HumanoidParams,
    atlas_self_collision_pairs,
    atlas_stand_q,
    humanoid_hardware,
    humanoid_urdf,
    make_atlas,
)
from jiminy_tpu_torch.models.quadruped import (  # noqa: F401
    ANYMAL,
    SPOTMICRO,
    STAND_HEIGHT,
    QuadrupedParams,
    anymal_hardware,
    anymal_urdf,
    make_anymal,
    make_quadruped,
    make_spotmicro,
    quadruped_hardware,
    quadruped_urdf,
    stand_q,
)
from jiminy_tpu_torch.models.toys import (  # noqa: F401
    make_acrobot,
    make_ball,
    make_cartpole,
    make_double_pendulum,
    make_free_box,
    make_pendulum,
)
