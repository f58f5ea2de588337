"""The port's constraint-solve chain against jiminy_tpu's.

- The port's ``solve_reference`` (the plain version of the CUDA kernel)
  and its ``pgs_solve_grouped`` / ``kkt_residual`` match the JAX
  ``solve_reference`` (vmapped) on the ANYmal, Atlas and Cassie layouts
  at B = 16, atol 1e-4 (float32 reassociation, as in
  tests/test_pallas_solve.py).
- The row-sequential ``pgs_solve`` matches the JAX one on the same
  layouts (the bounds as "lower" rows, ANYmal's last six as "upper"),
  float32 within 1e-6, and shares the grouped solve's fixed point on
  tests/test_solver_grouped.py's block-diagonal system (100 sweeps, atol
  1e-4, that test's tolerance).
- One case matches the Pallas kernel itself,
  ``solve_batched_pallas(interpret=True)``, at B = 8.
- ``solve_batched`` runs the plain version for CPU tensors, and raises
  for a CUDA device when there is no GPU (no fallback).

The kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.solver import BlockSpec as JBlockSpec
from jiminy_tpu.engine.solver import kkt_residual as j_kkt_residual
from jiminy_tpu.ops import SolveConfig as JSolveConfig
from jiminy_tpu.ops import solve_batched_pallas
from jiminy_tpu.ops import solve_reference as j_solve_reference
from jiminy_tpu_torch.engine.solver import BlockSpec, kkt_residual, pgs_solve, pgs_solve_grouped
from jiminy_tpu_torch.ops import _build
from jiminy_tpu_torch.ops.constraint_solve import (
    SolveConfig,
    _layout,
    solve_batched,
    solve_reference,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-4

CONFIGS = {
    # ANYmal: 12 bound rows + 4 contacts in 2 colors
    "anymal": dict(
        n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
        contact_colors=((12, 2), (18, 2)), iters=8, relax=1.0, reg=1e-6,
        compute_residual=True,
    ),
    # Atlas-like: 23 bounds + 8 contacts in 2 colors
    "atlas": dict(
        n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
        contact_colors=((23, 4), (35, 4)), iters=4, relax=1.0, reg=1e-6,
        compute_residual=True,
    ),
    # Cassie-like: 4 equality rows (closed loops) + bounds + contacts
    "cassie": dict(
        n=22, nc=26, dt=2e-3, eq_blocks=(("equality", 0, 4),),
        bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)), iters=4,
        relax=0.9, reg=1e-6, compute_residual=True,
    ),
}


def _configs(name):
    c = dict(CONFIGS[name])
    eq = c.pop("eq_blocks")
    return (
        SolveConfig(eq_blocks=tuple(BlockSpec(*b) for b in eq), **c),
        JSolveConfig(eq_blocks=tuple(JBlockSpec(*b) for b in eq), **c),
    )


def _rand_system(seed, B, n, nc, active_p=0.7):
    """Well-conditioned random systems (as tests/test_pallas_solve.py)."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((B, n, n)) * 0.3
    M = R @ R.transpose(0, 2, 1) + 2.0 * np.eye(n)
    p = rng.standard_normal((B, n))
    v = rng.standard_normal((B, n)) * 0.5
    J = rng.standard_normal((B, nc, n)) * 0.5
    target = rng.standard_normal((B, nc)) * 0.1
    mu = np.full((B, nc), 0.8)
    active = rng.random((B, nc)) < active_p
    lam0 = rng.standard_normal((B, nc)) * 0.01
    f = [x.astype(np.float32) for x in (M, p, v, J, target, mu)]
    return (*f, active, lam0.astype(np.float32))


def _torch_args(args):
    return [torch.as_tensor(np.array(a)) for a in args]


def _ref(jcfg, args):
    return jax.jit(jax.vmap(lambda *a: j_solve_reference(jcfg, *a)))(*args)


@pytest.fixture(scope="module")
def references():
    """JAX reference outputs per config (one compile each)."""
    out = {}
    for name in CONFIGS:
        cfg, jcfg = _configs(name)
        args = _rand_system(0, 16, cfg.n, cfg.nc)
        out[name] = (args, _ref(jcfg, args))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("residual", [True, False])
def test_solve_reference_matches_jax(references, name, residual):
    cfg, _ = _configs(name)
    cfg = dataclasses.replace(cfg, compute_residual=residual)
    args, (vn_ref, lam_ref, res_ref) = references[name]
    vn, lam, res = solve_reference(cfg, *_torch_args(args))
    np.testing.assert_allclose(vn.numpy(), np.asarray(vn_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), atol=ATOL, rtol=0)
    if residual:
        np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=ATOL, rtol=0)
    else:
        assert not res.any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pgs_and_residual_match_jax(name):
    """The grouped PGS and the KKT residual alone, on a Delassus system."""
    from jiminy_tpu.engine.solver import pgs_solve_grouped as j_pgs

    cfg, jcfg = _configs(name)
    M, _, _, J, target, mu, active, lam0 = _rand_system(1, 16, cfg.n, cfg.nc)
    A = (J @ np.linalg.solve(M, J.transpose(0, 2, 1)) + 1e-6 * np.eye(cfg.nc)).astype(np.float32)
    b = target

    def jfn(A, b, mu, active, lam0):
        return j_pgs(
            A, b, mu, active, eq_blocks=jcfg.eq_blocks, bounds_span=jcfg.bounds_span,
            contact_colors=jcfg.contact_colors, iters=jcfg.iters, relax=jcfg.relax,
            lam0=lam0, compute_residual=True,
        )

    lam_ref, res_ref = jax.jit(jax.vmap(jfn))(A, b, mu, active, lam0)
    At, bt, mut, actt, lam0t = _torch_args((A, b, mu, active, lam0))
    lam, res = pgs_solve_grouped(
        At, bt, mut, actt, eq_blocks=cfg.eq_blocks, bounds_span=cfg.bounds_span,
        contact_colors=cfg.contact_colors, iters=cfg.iters, relax=cfg.relax,
        lam0=lam0t, compute_residual=True,
    )
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=ATOL, rtol=0)
    # the residual of the reference's own λ, through both residual functions
    kj = jax.vmap(lambda A, b, l, a: j_kkt_residual(A, b, l, a, jcfg.bounds_span, jcfg.contact_colors))(
        A, b, lam_ref, active
    )
    kt = kkt_residual(At, bt, torch.as_tensor(np.array(lam_ref)), actt, cfg.bounds_span, cfg.contact_colors)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL, rtol=0)


def _sequential_blocks(name, cls):
    """The config's rows as ``pgs_solve`` blocks: its equality blocks, the
    bounds one "lower" row each (ANYmal's last six "upper"), its contacts
    one "contact" block each."""
    c = CONFIGS[name]
    s, k = c["bounds_span"]
    blocks = [cls(*b) for b in c["eq_blocks"]]
    n_upper = 6 if name == "anymal" else 0
    blocks += [cls("lower" if i < s + k - n_upper else "upper", i, 1) for i in range(s, s + k)]
    blocks += [cls("contact", cs + 3 * j, 3) for cs, n in c["contact_colors"] for j in range(n)]
    return blocks


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sequential_pgs_matches_jax(name):
    from jiminy_tpu.engine.solver import pgs_solve as j_pgs_solve

    cfg, _ = _configs(name)
    M, _, _, J, target, mu, active, lam0 = _rand_system(2, 16, cfg.n, cfg.nc)
    A = (J @ np.linalg.solve(M, J.transpose(0, 2, 1)) + 1e-6 * np.eye(cfg.nc)).astype(np.float32)
    jblocks = _sequential_blocks(name, JBlockSpec)
    lam_ref, res_ref = jax.jit(jax.vmap(lambda A, b, mu, act, l0: j_pgs_solve(
        A, b, jblocks, mu, act, lam0=l0, iters=cfg.iters, relax=cfg.relax)))(
        A, target, mu, active, lam0)
    lam, res = pgs_solve(*_torch_args((A, target)), _sequential_blocks(name, BlockSpec),
                         *_torch_args((mu, active, lam0)), iters=cfg.iters, relax=cfg.relax)
    assert lam.dtype == torch.float32
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=1e-6, rtol=0)


def test_sequential_pgs_shares_the_grouped_fixed_point():
    """tests/test_solver_grouped.py::test_matches_sequential_without_coupling
    with the port's ``pgs_solve`` against the reference's
    ``pgs_solve_grouped``: on a block-diagonal A both reach the same λ."""
    from jiminy_tpu.engine.solver import pgs_solve_grouped as j_pgs_grouped

    rng = np.random.default_rng(5)
    n_bounds, n_contacts = 4, 4
    nc = n_bounds + 3 * n_contacts
    A = 2.0 * np.eye(nc)
    for c in range(n_contacts):
        s = n_bounds + 3 * c
        G = rng.standard_normal((3, 3))
        A[s:s + 3, s:s + 3] = G @ G.T + 2.0 * np.eye(3)
    A, b = A.astype(np.float32), (2.0 * rng.standard_normal(nc)).astype(np.float32)
    active = np.ones(nc, bool)
    mu = np.concatenate([np.zeros(n_bounds), np.full(3 * n_contacts, 0.8)]).astype(np.float32)
    lam_grp, _ = j_pgs_grouped(A, b, mu, active, eq_blocks=[], bounds_span=(0, n_bounds),
                               contact_colors=[(n_bounds, 2), (n_bounds + 6, 2)], iters=100)
    blocks = [BlockSpec("lower", i, 1) for i in range(n_bounds)]
    blocks += [BlockSpec("contact", n_bounds + 3 * c, 3) for c in range(n_contacts)]
    lam, _ = pgs_solve(*_torch_args((A[None], b[None])), blocks,
                       *_torch_args((mu[None], active[None])), iters=100)
    np.testing.assert_allclose(lam[0].numpy(), np.asarray(lam_grp), atol=1e-4, rtol=0)


def test_solve_reference_matches_pallas_kernel():
    """Against the TPU kernel itself, in interpret mode, at B = 8."""
    cfg, jcfg = _configs("anymal")
    cfg = dataclasses.replace(cfg, iters=4)
    jcfg = dataclasses.replace(jcfg, iters=4)
    M, p, v, J, target, mu, active, lam0 = _rand_system(2, 8, cfg.n, cfg.nc)
    vn_ref, lam_ref, res_ref = solve_batched_pallas(
        jcfg, M, p, v, J, target, mu, active.astype(np.float32), lam0, True
    )
    vn, lam, res = solve_reference(cfg, *_torch_args((M, p, v, J, target, mu, active, lam0)))
    np.testing.assert_allclose(vn.numpy(), np.asarray(vn_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=ATOL, rtol=0)


def test_solve_batched_on_cpu_is_the_plain_version():
    cfg, _ = _configs("cassie")
    args = _torch_args(_rand_system(3, 5, cfg.n, cfg.nc))
    args[6] = args[6].float()  # the kernel's 0/1 float mask
    before = solve_batched.launches
    out = solve_batched(cfg, *args, device="cpu")
    ref = solve_reference(cfg, *args)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
    assert solve_batched.launches == before  # no kernel launch on the CPU


def test_solve_batched_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel path is tested by the cuda tests")
    cfg, _ = _configs("anymal")
    args = _torch_args(_rand_system(4, 2, cfg.n, cfg.nc))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        solve_batched(cfg, *args)  # default device: cuda
    with pytest.raises(ValueError, match="expected"):
        solve_batched(cfg, *args, device="meta")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_layout(name):
    cfg, _ = _configs(name)
    lay = _layout(cfg)
    n_eq = lay[0]
    assert n_eq == len(cfg.eq_blocks)
    pos = 1 + 2 * n_eq
    assert tuple(lay[pos:pos + 2]) == (cfg.bounds_span or (0, 0))
    assert lay[pos + 2] == len(cfg.contact_colors)
    assert len(lay) == pos + 3 + 2 * len(cfg.contact_colors)


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc → a clear error, never a fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
