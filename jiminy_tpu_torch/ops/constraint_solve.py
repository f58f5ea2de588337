"""Batched constraint-solve chain: the CUDA kernel and its plain version.

Counterpart of ``jiminy_tpu/ops/constraint_solve.py``. For every env:

    L = chol(M);  a_free = M⁻¹p;  v_free = v + dt·a_free
    MinvJT = M⁻¹Jᵀ;  A = J·MinvJT + reg·I;  rhs = target − J·v_free
    λ = PGS(A, rhs);  v⁺ = v_free + MinvJT·λ

:func:`solve_reference` is the plain PyTorch version (the reference's
``solve_reference``, batched). :func:`solve_batched` is the entry point:
on CUDA tensors it launches the hand-written kernel in
``csrc/constraint_solve.cu`` (built with nvcc, loaded with ctypes); on
CPU tensors it runs the plain version. It never falls back from one to
the other. ``solve_batched.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.solver import pgs_solve_grouped
from jiminy_tpu_torch.math import linalg


# the chain kernel's caps (csrc/constraint_solve.cu JT_MAX_N, JT_MAX_NC;
# csrc/solve_chain.cuh JT_MAX_EQ, JT_MAX_COLORS)
MAX_N, MAX_NC, MAX_EQ, MAX_COLORS = 32, 48, 32, 16


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Static shape/solver description (the reference's, field for
    field)."""

    n: int  # velocity dimension nv
    nc: int  # stacked constraint rows
    dt: float
    eq_blocks: tuple  # tuple of BlockSpec("equality", start, size)
    bounds_span: tuple | None  # (start, size) of contiguous λ ≥ 0 rows
    contact_colors: tuple  # ((start, n_contacts), ...), rows k×[t1,t2,n]
    iters: int = 8
    relax: float = 1.0
    reg: float = 1e-6
    compute_residual: bool = False


def kernel_takes(cfg: SolveConfig) -> bool:
    """Whether the chain kernel takes systems of this configuration."""
    return (cfg.n <= MAX_N and cfg.nc <= MAX_NC and len(cfg.eq_blocks) <= MAX_EQ
            and len(cfg.contact_colors) <= MAX_COLORS)


def solve_reference(cfg: SolveConfig, M, p, v, J, target, mu, active, lam0):
    """Plain PyTorch chain: M (B,n,n), p/v (B,n), J (B,nc,n),
    target/mu/active/lam0 (B,nc) → (v⁺ (B,n), λ (B,nc), residual (B,)).
    ``active`` may be bool or 0/1 floats."""
    L = linalg.cholesky(M)
    a_free = linalg.cho_solve(L, p)
    v_free = v + cfg.dt * a_free
    MinvJT = linalg.cho_solve(L, J.transpose(-1, -2))  # (B, n, nc)
    eye = torch.eye(cfg.nc, dtype=M.dtype, device=M.device)
    A = J @ MinvJT + cfg.reg * eye
    rhs = target - (J @ v_free[:, :, None])[..., 0]
    lam, residual = pgs_solve_grouped(
        A, rhs, mu, active != 0,
        eq_blocks=list(cfg.eq_blocks),
        bounds_span=cfg.bounds_span,
        contact_colors=list(cfg.contact_colors),
        iters=cfg.iters,
        relax=cfg.relax,
        lam0=lam0,
        compute_residual=cfg.compute_residual,
    )
    v_next = v_free + (MinvJT @ lam[:, :, None])[..., 0]
    return v_next, lam, residual


def _layout(cfg: SolveConfig) -> list[int]:
    """The block structure as the kernel's flat int array."""
    out = [len(cfg.eq_blocks)]
    for blk in cfg.eq_blocks:
        out += [blk.start, blk.size]
    out += list(cfg.bounds_span) if cfg.bounds_span is not None else [0, 0]
    out.append(len(cfg.contact_colors))
    for s, k in cfg.contact_colors:
        out += [s, k]
    return out


@functools.cache
def _kernel():
    from jiminy_tpu_torch.ops import _build

    lib = _build.load("constraint_solve")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.jt_solve_chain.argtypes = [vp] * 11 + [ci, ci, ci, vp, ci, ci, cf, cf, cf, ci, vp]
    lib.jt_solve_chain.restype = ci
    lib.jt_error_string.argtypes = [ci]
    lib.jt_error_string.restype = ctypes.c_char_p
    for fn in (lib.jt_solve_chain_max_n, lib.jt_solve_chain_max_nc):
        fn.argtypes = []
        fn.restype = ci
    return lib


def _launch(cfg: SolveConfig, M, p, v, J, target, mu, active, lam0):
    B, n, nc = M.shape[0], cfg.n, cfg.nc
    shapes = {
        "M": (M, (B, n, n)), "p": (p, (B, n)), "v": (v, (B, n)),
        "J": (J, (B, nc, n)), "target": (target, (B, nc)),
        "mu": (mu, (B, nc)), "active": (active, (B, nc)),
        "lam0": (lam0, (B, nc)),
    }
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"solve_batched: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"solve_batched: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"solve_batched: {name} must be contiguous")
    lib = _kernel()
    if n > lib.jt_solve_chain_max_n() or nc > lib.jt_solve_chain_max_nc():
        raise ValueError(
            f"solve_batched: n={n}, nc={nc} exceed the kernel's caps "
            f"({lib.jt_solve_chain_max_n()}, {lib.jt_solve_chain_max_nc()})"
        )
    v_next = torch.empty((B, n), dtype=torch.float32, device=M.device)
    lam = torch.empty((B, nc), dtype=torch.float32, device=M.device)
    res = torch.empty((B,), dtype=torch.float32, device=M.device)
    layout = _layout(cfg)
    c_layout = (ctypes.c_int * len(layout))(*layout)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    err = lib.jt_solve_chain(
        M.data_ptr(), p.data_ptr(), v.data_ptr(), J.data_ptr(),
        target.data_ptr(), mu.data_ptr(), active.data_ptr(),
        lam0.data_ptr(), v_next.data_ptr(), lam.data_ptr(), res.data_ptr(),
        B, n, nc, ctypes.cast(c_layout, ctypes.c_void_p), len(layout),
        cfg.iters, cfg.dt, cfg.relax, cfg.reg, int(cfg.compute_residual),
        stream,
    )
    if err != 0:
        raise RuntimeError(
            "constraint_solve kernel launch failed: "
            f"{lib.jt_error_string(err).decode()} (cudaError {err})"
        )
    solve_batched.launches += 1
    return v_next, lam, res


def solve_batched(
    cfg: SolveConfig, M, p, v, J, target, mu, active, lam0, device="cuda"
):
    """Batched chain on ``device``: M (B,n,n), p/v (B,n), J (B,nc,n),
    target/mu/active/lam0 (B,nc), all on ``device`` → (v⁺ (B,n),
    λ (B,nc), residual (B,)).

    On a CUDA device this launches the CUDA kernel (float32, contiguous
    inputs, ``active`` as 0/1 floats) and raises on anything else; on the
    CPU it runs :func:`solve_reference`. A CUDA device without a GPU
    raises."""
    dev = resolve_device(device)
    for t in (M, p, v, J, target, mu, active, lam0):
        if t.device != dev and not (dev.index is None and t.device.type == dev.type):
            raise ValueError(
                f"solve_batched: tensor on {t.device}, expected {dev}"
            )
    if dev.type == "cpu":
        return solve_reference(cfg, M, p, v, J, target, mu, active, lam0)
    if dev.type != "cuda":
        raise ValueError(f"solve_batched: unsupported device {dev}")
    return _launch(cfg, M, p, v, J, target, mu, active, lam0)


solve_batched.launches = 0
