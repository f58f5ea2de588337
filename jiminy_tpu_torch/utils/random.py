"""Host-side random processes: the PCG32 generator and table-based Perlin
noise.

Counterpart of ``PCG32`` and ``PerlinNoise`` in
``jiminy_tpu/utils/random.py`` (numpy only, so the port keeps its own
copy): a bit-exact PCG-XSH-RR 32-bit generator and 1/2/3-D gradient noise
with a PCG32-seeded permutation table. ``engine.terrain.perlin_ground``
draws its heightmap grids with them at env-build time, off the hot path,
so a seed gives the same terrain in both packages to the bit.
"""

from __future__ import annotations

import numpy as np

_PCG_MULT = np.uint64(6364136223846793005)


class PCG32:
    """PCG-XSH-RR 32-bit generator (O'Neill 2014), bit-exact against the
    reference C++ engine."""

    def __init__(self, seed: int = 0, stream: int = 0x14057B7EF767814F >> 1):
        with np.errstate(over="ignore"):
            self.inc = (np.uint64(stream) << np.uint64(1)) | np.uint64(1)
            self.state = np.uint64(0)
            self._step()
            self.state += np.uint64(seed)
            self._step()

    def _step(self):
        with np.errstate(over="ignore"):
            self.state = self.state * _PCG_MULT + self.inc

    def uint32(self) -> int:
        old = self.state
        self._step()
        with np.errstate(over="ignore"):
            xorshifted = np.uint32(((old >> np.uint64(18)) ^ old) >> np.uint64(27))
            rot = np.uint32(old >> np.uint64(59))
            return int(
                (xorshifted >> rot) | (xorshifted << ((-rot) & np.uint32(31)))
                & np.uint32(0xFFFFFFFF)
            ) & 0xFFFFFFFF

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + (hi - lo) * (self.uint32() / 4294967296.0)

    def normal(self, mean: float = 0.0, std: float = 1.0) -> float:
        """Box-Muller on two uniform draws."""
        u1 = max(self.uniform(), 1e-12)
        u2 = self.uniform()
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return float(mean + std * z)

    def uniform_vec(self, n: int, lo=0.0, hi=1.0) -> np.ndarray:
        return np.array([self.uniform(lo, hi) for _ in range(n)], np.float64)

    def normal_vec(self, n: int, mean=0.0, std=1.0) -> np.ndarray:
        return np.array([self.normal(mean, std) for _ in range(n)], np.float64)


def _fade(t):
    """Perlin quintic smoothstep 6t⁵−15t⁴+10t³."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


class PerlinNoise:
    """Gradient (Perlin) noise in 1/2/3-D with a PCG32-seeded permutation
    table; periodic with an integer ``period`` when given."""

    def __init__(self, seed: int = 0, period: int | None = None):
        rng = PCG32(seed)
        perm = np.arange(256, dtype=np.int64)
        for i in range(255, 0, -1):  # Fisher-Yates on PCG draws
            j = rng.uint32() % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        self.perm = np.concatenate([perm, perm])
        self.period = period

    def _hash(self, *idx):
        h = np.zeros_like(idx[0])
        for k in idx:
            if self.period is not None:
                k = np.mod(k, self.period)
            h = self.perm[(h + k) & 255]
        return h

    def _grad1(self, h, x):
        return np.where((h & 1) == 0, x, -x)

    def _grad2(self, h, x, y):
        u = np.where((h & 1) == 0, x, -x)
        v = np.where((h & 2) == 0, y, -y)
        return u + v

    def _grad3(self, h, x, y, z):
        hh = h & 15
        u = np.where(hh < 8, x, y)
        v = np.where(hh < 4, y, np.where((hh == 12) | (hh == 14), x, z))
        return np.where((hh & 1) == 0, u, -u) + np.where((hh & 2) == 0, v, -v)

    def __call__(self, x, y=None, z=None) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if y is None:
            xi = np.floor(x).astype(np.int64)
            xf = x - xi
            u = _fade(xf)
            a = self._grad1(self._hash(xi), xf)
            b = self._grad1(self._hash(xi + 1), xf - 1.0)
            return a + u * (b - a)
        y = np.asarray(y, np.float64)
        if z is None:
            xi, yi = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
            xf, yf = x - xi, y - yi
            u, v = _fade(xf), _fade(yf)
            n00 = self._grad2(self._hash(xi, yi), xf, yf)
            n10 = self._grad2(self._hash(xi + 1, yi), xf - 1, yf)
            n01 = self._grad2(self._hash(xi, yi + 1), xf, yf - 1)
            n11 = self._grad2(self._hash(xi + 1, yi + 1), xf - 1, yf - 1)
            nx0 = n00 + u * (n10 - n00)
            nx1 = n01 + u * (n11 - n01)
            return nx0 + v * (nx1 - nx0)
        z = np.asarray(z, np.float64)
        xi, yi, zi = (np.floor(c).astype(np.int64) for c in (x, y, z))
        xf, yf, zf = x - xi, y - yi, z - zi
        u, v, w = _fade(xf), _fade(yf), _fade(zf)

        def g(dx, dy, dz):
            return self._grad3(
                self._hash(xi + dx, yi + dy, zi + dz), xf - dx, yf - dy, zf - dz
            )

        def lerp(a, b, t):
            return a + t * (b - a)

        return lerp(
            lerp(lerp(g(0, 0, 0), g(1, 0, 0), u), lerp(g(0, 1, 0), g(1, 1, 0), u), v),
            lerp(lerp(g(0, 0, 1), g(1, 0, 1), u), lerp(g(0, 1, 1), g(1, 1, 1), u), v),
            w,
        )

    def octaves(self, x, y=None, n: int = 4, persistence: float = 0.5,
                lacunarity: float = 2.0) -> np.ndarray:
        """Fractal (fBm) sum of ``n`` octaves, normalized by the sum of
        the amplitudes."""
        out = 0.0
        amp, freq, norm = 1.0, 1.0, 0.0
        for _ in range(n):
            out = out + amp * (self(x * freq) if y is None else self(x * freq, y * freq))
            norm += amp
            amp *= persistence
            freq *= lacunarity
        return out / norm
