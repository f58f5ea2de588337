"""Ground profiles: height and unit normal at query points (x, y).

Counterpart of ``jiminy_tpu/engine/ground.py``:

- :class:`FlatGround`, z = height;
- the analytic grounds that the whole-substep kernels query in-kernel
  (``csrc/substep.cu`` ``jt_ground_query``): :class:`FourierGround` (a
  random Fourier series), :class:`PerlinGround` (hash-gradient fBm with an
  analytic gradient) and :class:`StairsGround` (a staircase with ramped
  risers), with the samplers :func:`sample_fourier_ground` and
  :func:`sample_perlin_ground`;
- :class:`HeightmapGround`, a bilinear grid (the compiled form of the
  generators of :mod:`jiminy_tpu_torch.engine.terrain`), queried by the
  plain physics only.

An analytic ground is one tensor, its coefficient vector ``gc`` (…, n_gc)
in the layout the kernels read (the reference's ``Engine._ground_coef``):
Fourier ``[amp | kx | ky | phase]`` (4K), Perlin ``[seed, freq, amp]``
(the seed an integer carried in float) with the octave count static,
Stairs ``[step_width, step_height, n_steps, ramp, x0]``. A leading batch
shape (B,) holds one ground per env; ``query(xy)`` broadcasts the points
(B, …, 2) against it. ``coef()`` and ``from_coef(coef, template)`` move
between the object and the vector that envs carry in ``info``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from jiminy_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class FlatGround:
    """z = height everywhere, normal +z."""

    height: float = 0.0
    MODE = "flat"

    def to(self, device=None, dtype=None) -> "FlatGround":
        return self

    def query(self, xy: torch.Tensor):
        """(height (...,), normal (..., 3)) at query points xy (..., 2)."""
        h = torch.full(xy.shape[:-1], self.height, dtype=xy.dtype, device=xy.device)
        n = torch.zeros(*xy.shape[:-1], 3, dtype=xy.dtype, device=xy.device)
        n[..., 2] = 1.0
        return h, n


def _lift(gc: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``gc`` (*batch, n) reshaped to (*batch, 1, …, 1, n) so that it
    broadcasts against the points xy (*batch, *points, 2)."""
    extra = xy.dim() - gc.dim()
    if extra < 0 or tuple(xy.shape[:gc.dim() - 1]) != tuple(gc.shape[:-1]):
        raise ValueError(f"points {tuple(xy.shape)} do not broadcast with a ground "
                         f"batch {tuple(gc.shape[:-1])}")
    return gc.reshape(*gc.shape[:-1], *([1] * extra), gc.shape[-1])


def _normal(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Unit normal (−∂h/∂x, −∂h/∂y, 1)/‖·‖ (..., 3)."""
    n = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def _as(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class FourierGround:
    """h(x, y) = Σₖ ampₖ · sin(kxₖ·x + kyₖ·y + phaseₖ): K sin/cos terms,
    no gather, so the kernels evaluate it in-kernel."""

    gc: torch.Tensor  # (..., 4K) [amp | kx | ky | phase]
    MODE = "fourier"

    @staticmethod
    def create(amp, kx, ky, phase, device="cuda", dtype=torch.float32) -> "FourierGround":
        return FourierGround(torch.cat([_as(x, device, dtype) for x in (amp, kx, ky, phase)], -1))

    @property
    def n_terms(self) -> int:
        return self.gc.shape[-1] // 4

    def _part(self, i):
        K = self.n_terms
        return self.gc[..., i * K:(i + 1) * K]

    amp = property(lambda self: self._part(0))
    kx = property(lambda self: self._part(1))
    ky = property(lambda self: self._part(2))
    phase = property(lambda self: self._part(3))

    def coef(self) -> torch.Tensor:
        return self.gc

    @staticmethod
    def from_coef(coef: torch.Tensor, template=None) -> "FourierGround":
        return FourierGround(coef)

    def to(self, device=None, dtype=None) -> "FourierGround":
        return FourierGround(self.gc.to(device=device, dtype=dtype))

    def query(self, xy: torch.Tensor):
        K = self.n_terms
        g = _lift(self.gc, xy)
        amp, kx, ky, ph = (g[..., i * K:(i + 1) * K] for i in range(4))
        arg = xy[..., 0:1] * kx + xy[..., 1:2] * ky + ph  # (..., K)
        s, c = torch.sin(arg), torch.cos(arg)
        h = torch.sum(amp * s, dim=-1)
        dzdx = torch.sum(amp * kx * c, dim=-1)
        dzdy = torch.sum(amp * ky * c, dim=-1)
        return h, _normal(dzdx, dzdy)


def sample_fourier_ground(
    generator: torch.Generator,
    n_terms: int = 16,
    amplitude: float = 0.12,
    wavelength: float = 2.0,
    octaves: int = 3,
    batch_shape: tuple = (),
    dtype=torch.float32,
) -> FourierGround:
    """A rough ground from a fractal band spectrum (the reference's
    sampler), one per entry of ``batch_shape``, on the generator's device.
    Directions are uniform; wave numbers sit in ``octaves`` bands at
    2π/wavelength · 2ᵒ (×U(0.75, 1.25)), with amplitudes halving per
    octave; phases are uniform. Process std ≈ ``amplitude``/√2."""
    kw = dict(generator=generator, device=generator.device, dtype=dtype)
    shape = (*batch_shape, n_terms)
    theta = 2.0 * math.pi * torch.rand(shape, **kw)
    octave = torch.arange(n_terms, device=generator.device) % octaves
    per_oct = torch.bincount(octave, minlength=octaves).to(torch.float64)
    k0 = 2.0 * math.pi / wavelength
    mag = (k0 * 2.0 ** octave.to(torch.float64)).to(dtype) * (0.75 + 0.5 * torch.rand(shape, **kw))
    amp = 0.5 ** octave.to(torch.float64) / per_oct[octave].sqrt()
    amp = amp * (amplitude / math.sqrt(sum((0.5 ** o) ** 2 for o in range(octaves))))
    phase = 2.0 * math.pi * torch.rand(shape, **kw)
    amp = amp.to(dtype).expand(shape)
    return FourierGround(torch.cat([amp, mag * torch.cos(theta), mag * torch.sin(theta), phase], -1))


_M32 = 0xFFFFFFFF


def _perlin_hash2(ix: torch.Tensor, iy: torch.Tensor, seed) -> torch.Tensor:
    """The reference's arithmetic 2-D lattice hash (int32 multiply, xor
    and logical shift; no permutation table), computed in int64 with
    every product masked to 32 bits and the result read back as a signed
    int32 value: the reference's int32 wraparound to the bit."""
    h = (ix * 0x27D4EB2D + iy * 0x165667B1 + seed) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2545F491) & _M32
    h = h ^ (h >> 13)
    return h - ((h >> 31) << 32)


def _fade(t):
    """Perlin quintic smoothstep 6t⁵−15t⁴+10t³ (C² at lattice lines)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _dfade(t):
    """d/dt fade = 30t²(t−1)²."""
    u = t * (t - 1.0)
    return 30.0 * u * u


# std of one hash-gradient octave (the reference's measurement over 2M
# samples of the (±1, ±1) gradient set)
_PERLIN_OCTAVE_STD = 0.306


def _perlin_octave(px, py, seed):
    """One octave of gradient noise at lattice scale 1: h, ∂h/∂px, ∂h/∂py;
    gradients (±1, ±1) from the hash's two low bits."""
    ix, iy = torch.floor(px), torch.floor(py)
    xf, yf = px - ix, py - iy
    ixi, iyi = ix.to(torch.int64), iy.to(torch.int64)

    def corner(di, dj):
        h = _perlin_hash2(ixi + di, iyi + dj, seed)
        sx = 1.0 - 2.0 * (h & 1).to(px.dtype)
        sy = 1.0 - (h & 2).to(px.dtype)
        return sx * (xf - di) + sy * (yf - dj), sx, sy

    n00, sx00, sy00 = corner(0, 0)
    n10, sx10, sy10 = corner(1, 0)
    n01, sx01, sy01 = corner(0, 1)
    n11, sx11, sy11 = corner(1, 1)
    u, v = _fade(xf), _fade(yf)
    du, dv = _dfade(xf), _dfade(yf)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    h = nx0 + v * (nx1 - nx0)
    dnx0_dx = sx00 + u * (sx10 - sx00) + du * (n10 - n00)
    dnx1_dx = sx01 + u * (sx11 - sx01) + du * (n11 - n01)
    dh_dx = dnx0_dx + v * (dnx1_dx - dnx0_dx)
    dnx0_dy = sy00 + u * (sy10 - sy00)
    dnx1_dy = sy01 + u * (sy11 - sy01)
    dh_dy = dnx0_dy + v * (dnx1_dy - dnx0_dy) + dv * (nx1 - nx0)
    return h, dh_dx, dh_dy


@dataclasses.dataclass(frozen=True, eq=False)
class PerlinGround:
    """Analytic fractal Perlin terrain: ``octaves`` octaves of lattice
    gradient noise (arithmetic hash, quintic fade), frequencies doubling
    and weights halving, normalized to a height std ≈ amp; octave o uses
    the seed + 1013·o."""

    gc: torch.Tensor  # (..., 3) [seed, freq, amp], seed an integer < 2²⁴
    octaves: int = 3
    MODE = "perlin"

    @staticmethod
    def create(seed, freq, amp, octaves=3, device="cuda", dtype=torch.float32) -> "PerlinGround":
        gc = torch.stack(torch.broadcast_tensors(*(_as(x, device, dtype) for x in (seed, freq, amp))), -1)
        return PerlinGround(gc, octaves)

    seed = property(lambda self: self.gc[..., 0])
    freq = property(lambda self: self.gc[..., 1])
    amp = property(lambda self: self.gc[..., 2])

    @property
    def _norm(self) -> float:
        """fBm normalization: per-octave weights 2⁻ᵒ, unit process std."""
        s = sum((0.5 ** o) ** 2 for o in range(self.octaves))
        return 1.0 / (_PERLIN_OCTAVE_STD * math.sqrt(s))

    def coef(self) -> torch.Tensor:
        return self.gc

    @staticmethod
    def from_coef(coef: torch.Tensor, template: "PerlinGround") -> "PerlinGround":
        return PerlinGround(coef, template.octaves)

    def to(self, device=None, dtype=None) -> "PerlinGround":
        return PerlinGround(self.gc.to(device=device, dtype=dtype), self.octaves)

    def query(self, xy: torch.Tensor):
        g = _lift(self.gc, xy)
        x, y = xy[..., 0], xy[..., 1]
        seed = g[..., 0].to(torch.int64)
        freq, scale = g[..., 1], g[..., 2] * self._norm
        h, gx, gy = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
        for o in range(self.octaves):
            f_o = freq * (2.0 ** o)
            w_o = scale * (0.5 ** o)
            ho, gxo, gyo = _perlin_octave(x * f_o, y * f_o, seed + 1013 * o)
            h = h + w_o * ho
            gx = gx + w_o * f_o * gxo
            gy = gy + w_o * f_o * gyo
        return h, _normal(gx, gy)


def sample_perlin_ground(
    generator: torch.Generator,
    amplitude: float = 0.08,
    wavelength: float = 1.5,
    octaves: int = 3,
    batch_shape: tuple = (),
    dtype=torch.float32,
) -> PerlinGround:
    """A random analytic Perlin ground per entry of ``batch_shape``: a
    seed uniform in [0, 2²⁴), frequency 1/wavelength, height std ≈
    ``amplitude``."""
    dev = generator.device
    seed = torch.randint(0, 1 << 24, batch_shape, generator=generator, device=dev).to(dtype)
    freq = torch.full(batch_shape, 1.0 / wavelength, dtype=torch.float32, device=dev)
    amp = torch.full(batch_shape, amplitude, dtype=torch.float32, device=dev)
    return PerlinGround(torch.stack([seed, freq.to(dtype), amp.to(dtype)], -1), octaves)


@dataclasses.dataclass(frozen=True, eq=False)
class StairsGround:
    """A staircase rising along +x: ``h = step_height · clip(k + clip((u −
    k·w)/ramp, 0, 1), 0, n_steps)`` with u = x − x0, k = ⌊u/w⌋; each riser
    a linear ramp of width ``ramp``."""

    gc: torch.Tensor  # (..., 5) [step_width, step_height, n_steps, ramp, x0]
    MODE = "stairs"

    @staticmethod
    def create(step_width=0.4, step_height=0.08, n_steps=10, ramp=0.05, x0=0.0,
               device="cuda", dtype=torch.float32) -> "StairsGround":
        parts = (_as(x, device, dtype) for x in (step_width, step_height, n_steps, ramp, x0))
        return StairsGround(torch.stack(torch.broadcast_tensors(*parts), -1))

    def coef(self) -> torch.Tensor:
        return self.gc

    @staticmethod
    def from_coef(coef: torch.Tensor, template=None) -> "StairsGround":
        return StairsGround(coef)

    def to(self, device=None, dtype=None) -> "StairsGround":
        return StairsGround(self.gc.to(device=device, dtype=dtype))

    def query(self, xy: torch.Tensor):
        g = _lift(self.gc, xy)
        w, H, n, ramp, x0 = g.unbind(-1)
        u = xy[..., 0] - x0
        k = torch.floor(u / w)
        t = (u - k * w) / ramp
        tc = torch.clamp(t, 0.0, 1.0)
        s = torch.minimum(torch.clamp(k + tc, min=0.0), n)
        h = H * s
        inner = (t > 0.0) & (t < 1.0) & (k + tc > 0.0) & (k + tc < n)
        dzdx = torch.where(inner, H / ramp, torch.zeros_like(h))
        return h, _normal(dzdx, torch.zeros_like(h))


@dataclasses.dataclass(frozen=True, eq=False)
class HeightmapGround:
    """Grid heightmap with bilinear interpolation and its analytic
    gradient. The grid covers [x0, x0 + nx·dx) × [y0, y0 + ny·dy); queries
    outside clamp to the border. Shared by the whole batch; queried by the
    plain physics (the kernels take the analytic grounds only)."""

    z: torch.Tensor  # (nx, ny)
    x0: torch.Tensor  # () each
    y0: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    MODE = "heightmap"

    @staticmethod
    def create(z, x0=0.0, y0=0.0, dx=0.1, dy=0.1, device="cuda", dtype=torch.float32):
        return HeightmapGround(*(_as(a, device, dtype) for a in (z, x0, y0, dx, dy)))

    def to(self, device=None, dtype=None) -> "HeightmapGround":
        return HeightmapGround(*(getattr(self, f.name).to(device=device, dtype=dtype)
                                 for f in dataclasses.fields(self)))

    def query(self, xy: torch.Tensor):
        nx, ny = self.z.shape
        fx = torch.clamp((xy[..., 0] - self.x0) / self.dx, 0.0, nx - 1.001)
        fy = torch.clamp((xy[..., 1] - self.y0) / self.dy, 0.0, ny - 1.001)
        ix = torch.floor(fx).to(torch.int64)
        iy = torch.floor(fy).to(torch.int64)
        tx, ty = fx - ix, fy - iy
        z00, z10 = self.z[ix, iy], self.z[ix + 1, iy]
        z01, z11 = self.z[ix, iy + 1], self.z[ix + 1, iy + 1]
        h = (z00 * (1 - tx) * (1 - ty) + z10 * tx * (1 - ty)
             + z01 * (1 - tx) * ty + z11 * tx * ty)
        dzdx = ((z10 - z00) * (1 - ty) + (z11 - z01) * ty) / self.dx
        dzdy = ((z01 - z00) * (1 - tx) + (z11 - z10) * tx) / self.dy
        return h, _normal(dzdx, dzdy)


ANALYTIC = (FourierGround, PerlinGround, StairsGround)
