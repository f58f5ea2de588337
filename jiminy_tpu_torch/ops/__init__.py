"""Hand-written CUDA kernels of the engine's hot ops, each beside its
plain PyTorch version."""

from jiminy_tpu_torch.ops.constraint_solve import (  # noqa: F401
    SolveConfig,
    solve_batched,
    solve_reference,
)
