"""Small-matrix linear algebra over a leading batch, column at a time.

Counterpart of ``jiminy_tpu/math/linalg.py``: the same Cholesky–Crout
factorization and triangular solves, one whole-batch vector op per
column, so the plain constraint-solve chain (``ops/constraint_solve.py``)
performs the same arithmetic as the reference and as the CUDA kernel.
All functions take ``(..., n, n)`` matrices; right-hand sides are
``(..., n)`` or ``(..., n, m)``.
"""

from __future__ import annotations

import torch


def cholesky(M: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular L with L Lᵀ = M (pivots clamped at 1e-12)."""
    n = M.shape[-1]
    if jitter:
        M = M + jitter * torch.eye(n, dtype=M.dtype, device=M.device)
    L = torch.zeros_like(M)
    for j in range(n):
        # s = M[j:, j] − L[j:, :j] · L[j, :j]   (one matvec per column)
        s = M[..., j:, j]
        if j:
            s = s - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        d = torch.sqrt(torch.clamp_min(s[..., 0], 1e-12))
        col = s / d[..., None]
        col[..., 0] = d
        L[..., j:, j] = col
    return L


def _as_matrix(L: torch.Tensor, b: torch.Tensor):
    vec = b.dim() == L.dim() - 1
    return (b[..., None] if vec else b), vec


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L x = b (forward substitution)."""
    n = L.shape[-1]
    bm, vec = _as_matrix(L, b)
    x = torch.zeros_like(bm)
    for i in range(n):
        s = bm[..., i, :]
        if i:
            s = s - (L[..., i, None, :i] @ x[..., :i, :])[..., 0, :]
        x[..., i, :] = s / L[..., i, i, None]
    return x[..., 0] if vec else x


def solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with Lᵀ x = b (back substitution)."""
    n = L.shape[-1]
    bm, vec = _as_matrix(L, b)
    x = torch.zeros_like(bm)
    for i in range(n - 1, -1, -1):
        s = bm[..., i, :]
        if i < n - 1:
            s = s - (L[..., None, i + 1:, i] @ x[..., i + 1:, :])[..., 0, :]
        x[..., i, :] = s / L[..., i, i, None]
    return x[..., 0] if vec else x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given L = cholesky(M)."""
    return solve_upper_t(L, solve_lower(L, b))


def solve_psd(M: torch.Tensor, b: torch.Tensor, jitter: float = 0.0):
    """One-shot M x = b for small SPD M."""
    return cho_solve(cholesky(M, jitter=jitter), b)
