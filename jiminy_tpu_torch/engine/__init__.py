"""The engine: the impulse path (PGS solver, constraint rows, contacts)
and the continuous path (penalty contacts and bounds, steppers), the
registered forces, the grounds and the batched step."""

from jiminy_tpu_torch.engine.contact import ContactParams  # noqa: F401
from jiminy_tpu_torch.engine.engine import (  # noqa: F401
    Engine,
    EngineOptions,
    PDController,
    SimState,
)
from jiminy_tpu_torch.engine.forces import (  # noqa: F401
    CouplingForce,
    ImpulseForce,
    ProfileForce,
    compute_forces,
)
from jiminy_tpu_torch.engine.ground import FlatGround  # noqa: F401
from jiminy_tpu_torch.engine.steppers import STEPPERS  # noqa: F401
