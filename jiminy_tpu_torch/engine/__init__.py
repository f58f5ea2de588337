"""The impulse engine of the slice: PGS solver, constraint rows,
contacts, flat ground and the batched step."""

from jiminy_tpu_torch.engine.contact import ContactParams  # noqa: F401
from jiminy_tpu_torch.engine.engine import (  # noqa: F401
    Engine,
    EngineOptions,
    PDController,
    SimState,
)
from jiminy_tpu_torch.engine.ground import FlatGround  # noqa: F401
