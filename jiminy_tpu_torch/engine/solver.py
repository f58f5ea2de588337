"""Projected Gauss-Seidel (PGS) impulse solver over a batch of systems.

Counterpart of ``jiminy_tpu/engine/solver.py`` (``pgs_solve_grouped``,
``kkt_residual``, ``BlockSpec``). Fixed iteration count, inactive rows
masked to zero, and the same sweep order, which decides the numbers:

1. equality rows, one at a time (Gauss-Seidel);
2. the bounds span, all rows at once from the same λ, clamped ≥ 0;
3. for each contact color, all its contacts at once (Jacobi within the
   color): the normals clamped ≥ 0, then the first tangents, then the
   second tangents, then the projection onto the cone of radius μ·λn.

Shapes: A (B, nc, nc), b/mu/active/λ (B, nc).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class BlockSpec(NamedTuple):
    """One constraint block of the stacked system (kind "equality",
    "contact", "lower" or "upper")."""

    kind: str
    start: int
    size: int


def _row_dot(A_rows: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(B, r, nc) rows · (B, nc) λ → (B, r)."""
    return (A_rows @ lam[:, :, None])[..., 0]


def kkt_residual(A, b, lam, active, bounds_span, contact_colors):
    """(B,) max complementarity violation: equality rows count |r|;
    unilateral rows |r| while pushing, else max(r, 0); tangent rows at
    the cone boundary (sliding) are not counted."""
    r = b - _row_dot(A, lam)
    zero = torch.zeros_like(r)
    viol = torch.where(active, torch.abs(r), zero)
    if bounds_span is not None:
        s, k = bounds_span
        e = s + k
        u = torch.where(
            lam[:, s:e] > 1e-6, torch.abs(r[:, s:e]), torch.clamp_min(r[:, s:e], 0.0)
        )
        viol[:, s:e] = torch.where(active[:, s:e], u, zero[:, s:e])
    for s, k in contact_colors:
        if k == 0:
            continue
        e = s + 3 * k
        bl = lam[:, s:e].reshape(-1, k, 3)
        br = r[:, s:e].reshape(-1, k, 3)
        ba = active[:, s:e].reshape(-1, k, 3)
        n_viol = torch.where(
            bl[..., 2] > 1e-6, torch.abs(br[..., 2]), torch.clamp_min(br[..., 2], 0.0)
        )
        tn = torch.sqrt(bl[..., 0] ** 2 + bl[..., 1] ** 2 + 1e-24)
        sliding = tn >= 0.999 * torch.clamp_min(bl[..., 2], 1e-9)
        t_viol = torch.where(
            sliding[..., None], torch.zeros_like(br[..., :2]), torch.abs(br[..., :2])
        )
        blk = torch.cat([t_viol, n_viol[..., None]], dim=-1)
        viol[:, s:e] = torch.where(ba, blk, torch.zeros_like(blk)).reshape(-1, 3 * k)
    return torch.amax(torch.clamp_min(viol, 0.0), dim=-1)


def pgs_solve_grouped(
    A: torch.Tensor,
    b: torch.Tensor,
    mu: torch.Tensor,
    active: torch.Tensor,
    eq_blocks: Sequence[BlockSpec],
    bounds_span: tuple | None,
    contact_colors: Sequence[tuple],
    iters: int = 16,
    relax: float = 1.0,
    lam0: torch.Tensor | None = None,
    compute_residual: bool = True,
):
    """Grouped PGS (see the module docstring). ``active`` is a bool mask.
    Returns (λ (B, nc), residual (B,))."""
    active = active.to(torch.bool)
    lam = torch.zeros_like(b) if lam0 is None else lam0
    lam = torch.where(active, lam, torch.zeros_like(lam))
    diag = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1), 1e-8)
    for _ in range(iters):
        lam = lam.clone()
        for blk in eq_blocks:
            for i in range(blk.start, blk.start + blk.size):
                r = b[:, i] - _row_dot(A[:, i:i + 1], lam)[:, 0]
                li = lam[:, i] + relax * r / diag[:, i]
                lam[:, i] = torch.where(active[:, i], li, torch.zeros_like(li))
        if bounds_span is not None:
            s, k = bounds_span
            e = s + k
            r = b[:, s:e] - _row_dot(A[:, s:e], lam)
            li = torch.clamp_min(lam[:, s:e] + relax * r / diag[:, s:e], 0.0)
            lam[:, s:e] = torch.where(active[:, s:e], li, torch.zeros_like(li))
        for s, k in contact_colors:
            if k == 0:
                continue
            e = s + 3 * k
            for j in (2, 0, 1):  # normals first, then the two tangents
                rows = slice(s + j, e, 3)
                r = b[:, rows] - _row_dot(A[:, rows], lam)
                li = lam[:, rows] + relax * r / diag[:, rows]
                if j == 2:
                    li = torch.clamp_min(li, 0.0)
                lam[:, rows] = torch.where(active[:, rows], li, torch.zeros_like(li))
            # friction-cone projection, vectorized over the color
            blk = lam[:, s:e].reshape(-1, k, 3)
            tn = torch.sqrt(blk[..., 0] ** 2 + blk[..., 1] ** 2 + 1e-24)
            lim = mu[:, s + 2:e:3] * blk[..., 2]
            scale = torch.where(
                tn > lim, lim / torch.clamp_min(tn, 1e-12), torch.ones_like(tn)
            )
            lam[:, s:e:3] = blk[..., 0] * scale
            lam[:, s + 1:e:3] = blk[..., 1] * scale
    if compute_residual:
        res = kkt_residual(A, b, lam, active, bounds_span, contact_colors)
    else:
        res = torch.zeros_like(b[:, 0])
    return lam, res
