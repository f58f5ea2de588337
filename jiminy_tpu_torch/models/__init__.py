"""Robot models built by the port itself (no reference import)."""

from jiminy_tpu_torch.models.quadruped import (  # noqa: F401
    ANYMAL,
    QuadrupedParams,
    make_anymal,
    stand_q,
)
