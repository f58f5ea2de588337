"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX.) Tolerance
1e-4: float32 reassociation between the kernel and the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jiminy_tpu_torch.engine.solver import BlockSpec
from jiminy_tpu_torch.ops.constraint_solve import (
    SolveConfig,
    solve_batched,
    solve_reference,
)

ATOL = 1e-4
CONFIGS = {
    "anymal": SolveConfig(
        n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
        contact_colors=((12, 2), (18, 2)), iters=8, compute_residual=True,
    ),
    "atlas": SolveConfig(
        n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
        contact_colors=((23, 4), (35, 4)), iters=4, compute_residual=True,
    ),
    "cassie": SolveConfig(
        n=22, nc=26, dt=2e-3, eq_blocks=(BlockSpec("equality", 0, 4),),
        bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)), iters=4,
        relax=0.9, compute_residual=True,
    ),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel cannot run on the CPU")
    return torch.device("cuda")


def _rand_system(seed, B, n, nc, dev):
    """Well-conditioned random systems (as tests/test_pallas_solve.py)."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((B, n, n)) * 0.3
    M = R @ R.transpose(0, 2, 1) + 2.0 * np.eye(n)
    arrays = (
        M, rng.standard_normal((B, n)), 0.5 * rng.standard_normal((B, n)),
        0.5 * rng.standard_normal((B, nc, n)), 0.1 * rng.standard_normal((B, nc)),
        np.full((B, nc), 0.8), (rng.random((B, nc)) < 0.7).astype(np.float64),
        0.01 * rng.standard_normal((B, nc)),
    )
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("B", [16, 1000])
def test_kernel_matches_plain_version(cuda_device, name, B):
    cfg = CONFIGS[name]
    args = _rand_system(5, B, cfg.n, cfg.nc, cuda_device)
    before = solve_batched.launches
    out = solve_batched(cfg, *args, device=cuda_device)
    torch.cuda.synchronize()
    assert solve_batched.launches == before + 1
    for o, r in zip(out, solve_reference(cfg, *args)):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    cfg = CONFIGS["anymal"]
    args = _rand_system(6, 8, cfg.n, cfg.nc, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        solve_batched(cfg, *[a.double() for a in args], device=cuda_device)
    bad = list(args)
    bad[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)  # J, strided
    with pytest.raises(ValueError, match="contiguous"):
        solve_batched(cfg, *bad, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        solve_batched(cfg, *[a[:, :-1] if a.dim() == 2 else a for a in args], device=cuda_device)


@pytest.mark.cuda
def test_env_step_goes_through_the_kernel(cuda_device):
    """4 launches per env step; each substep equals the inline plain chain
    from the same inputs."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(device=cuda_device)
    inline = ANYmalEnv(constraint_solver="inline", device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = env.reset(gen, 256)
    before = solve_batched.launches
    state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert solve_batched.launches == before + 4
    u = env._action_to_command(torch.zeros(256, 12, device=cuda_device), state.sim)
    nk = env.engine.step(state.sim, u, n_substeps=1)
    ni = inline.engine.step(state.sim, u, n_substeps=1)
    torch.testing.assert_close(nk.q, ni.q, atol=ATOL, rtol=0)
    torch.testing.assert_close(nk.v, ni.v, atol=ATOL, rtol=0)
