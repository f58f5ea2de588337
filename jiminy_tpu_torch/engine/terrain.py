"""Terrain generators and heightmap combinators.

Counterpart of ``jiminy_tpu/engine/terrain.py``: a random Perlin ground
and a staircase drawn on the host with numpy (the same arithmetic as the
reference, so the same grid to the bit), compiled to a
:class:`~jiminy_tpu_torch.engine.ground.HeightmapGround`, and the
pointwise combinators sum, merge (max) and discretize.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.engine.ground import HeightmapGround
from jiminy_tpu_torch.utils.random import PerlinNoise


def _grid(size: float, resolution: float):
    n = int(round(2.0 * size / resolution)) + 1
    return np.linspace(-size, size, n)


def perlin_ground(
    seed: int = 0,
    size: float = 10.0,
    resolution: float = 0.1,
    amplitude: float = 0.15,
    wavelength: float = 2.0,
    octaves: int = 4,
    flat_radius: float = 0.0,
    device="cuda",
) -> HeightmapGround:
    """Fractal Perlin heightmap over [−size, size]², reproducible from
    ``seed`` (PCG32-seeded gradient table); ``flat_radius`` levels a spawn
    disk at the origin."""
    xs = _grid(size, resolution)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    z = amplitude * PerlinNoise(seed).octaves(X / wavelength, Y / wavelength, n=octaves)
    if flat_radius > 0.0:
        r = np.sqrt(X**2 + Y**2)
        z = z * np.clip((r - flat_radius) / max(resolution * 4, 1e-6), 0, 1)
    return HeightmapGround.create(
        z.astype(np.float32), x0=-size, y0=-size, dx=resolution, dy=resolution, device=device
    )


def stairs_ground(
    step_width: float = 0.3,
    step_height: float = 0.1,
    n_steps: int = 8,
    size: float = 10.0,
    resolution: float = 0.05,
    axis: int = 0,
    device="cuda",
) -> HeightmapGround:
    """Staircase along x (axis=0) or y (axis=1): flat before the origin,
    ``n_steps`` up, then a plateau."""
    xs = _grid(size, resolution)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    idx = np.clip(np.floor((X if axis == 0 else Y) / step_width), 0, n_steps)
    return HeightmapGround.create(
        (idx * step_height).astype(np.float32), x0=-size, y0=-size, dx=resolution,
        dy=resolution, device=device,
    )


def _binary_op(a: HeightmapGround, b: HeightmapGround, op) -> HeightmapGround:
    if a.z.shape != b.z.shape:
        raise ValueError("combining heightmaps requires identical grids")
    return dataclasses.replace(a, z=op(a.z, b.z))


def sum_ground(a: HeightmapGround, b: HeightmapGround) -> HeightmapGround:
    """Pointwise sum."""
    return _binary_op(a, b, torch.add)


def merge_ground(a: HeightmapGround, b: HeightmapGround) -> HeightmapGround:
    """Pointwise max: the union of the solids."""
    return _binary_op(a, b, torch.maximum)


def discretize_ground(a: HeightmapGround, quantum: float) -> HeightmapGround:
    """Heights rounded (half to even) to multiples of ``quantum``:
    terraced terrain."""
    return dataclasses.replace(a, z=torch.round(a.z / quantum) * quantum)
