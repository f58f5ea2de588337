"""Ground profiles. Counterpart of ``jiminy_tpu/engine/ground.py``; the
slice needs flat ground only (Fourier, Perlin, Stairs and heightmaps are
ROADMAP A.10)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlatGround:
    """z = height everywhere, normal +z."""

    height: float = 0.0

    def query(self, xy: torch.Tensor):
        """(height (...,), normal (..., 3)) at query points xy (..., 2)."""
        h = torch.full(xy.shape[:-1], self.height, dtype=xy.dtype, device=xy.device)
        n = torch.zeros(*xy.shape[:-1], 3, dtype=xy.dtype, device=xy.device)
        n[..., 2] = 1.0
        return h, n
