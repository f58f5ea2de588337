"""The port's grounds, terrain generators and random processes against
jiminy_tpu's.

- Each analytic ground's ``query`` (Fourier, Perlin, Stairs) on the same
  coefficients as the reference's, per env (a (B,) batch of grounds, the
  reference vmapped) and shared (one ground for every point), at points
  around the origin and tens of metres out: h and the normal within 1e-5
  in float32 (the two frameworks sum the Fourier terms and round the
  sines in another order; the Perlin and Stairs arithmetic is the same
  operations in the same order and agrees to the bit here).
- The Perlin lattice hash bit-equal to the reference's int32 hash on
  integer lattices with negative coordinates and seeds near 2²⁴.
- ``HeightmapGround``, the ``terrain.py`` generators and combinators, and
  ``PCG32``/``PerlinNoise``: numpy on both sides, so equal to the bit
  (heights, grids, draws); the heightmap query within 1e-6.
- The samplers' statistics, as tests/test_fourier_ground.py checks the
  reference's (JAX PRNG and torch.Generator streams never match): process
  std against the amplitude, per-env grounds distinct, the deterministic
  parts (Fourier amplitudes, the Perlin frequency) equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine import ground as jg
from jiminy_tpu.engine import terrain as jt
from jiminy_tpu.utils import random as jr
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine import terrain as pt
from jiminy_tpu_torch.utils import random as pr

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
ATOL = 1e-5


def _points(seed, far):
    rng = np.random.default_rng(seed)
    span = 40.0 if far else 1.5
    return rng.uniform(-span, span, (B, 6, 2)).astype(np.float32)


def _reference_grounds(kind):
    """B reference grounds (a vmapped pytree) and their coefficients as
    numpy (B, n_gc) in the port's layout."""
    keys = jax.random.split(jax.random.PRNGKey({"fourier": 0, "perlin": 1, "stairs": 2}[kind]), B)
    if kind == "fourier":
        g = jax.vmap(lambda k: jg.sample_fourier_ground(k, n_terms=16, amplitude=0.08,
                                                        wavelength=1.5))(keys)
        gc = np.concatenate([np.asarray(x) for x in (g.amp, g.kx, g.ky, g.phase)], -1)
    elif kind == "perlin":
        g = jax.vmap(lambda k: jg.sample_perlin_ground(k, amplitude=0.08, wavelength=1.5))(keys)
        gc = np.stack([np.asarray(x) for x in (g.seed, g.freq, g.amp)], -1)
    else:
        rng = np.random.default_rng(3)
        p = [rng.uniform(0.3, 0.5, B), rng.uniform(0.05, 0.1, B), np.full(B, 10.0),
             rng.uniform(0.03, 0.06, B), rng.uniform(-1.0, 1.0, B)]
        g = jg.StairsGround(*(jnp.asarray(x, jnp.float32) for x in p))
        gc = np.stack(p, -1).astype(np.float32)
    return g, gc


def _port_ground(kind, gc):
    cls = {"fourier": pg.FourierGround, "perlin": pg.PerlinGround, "stairs": pg.StairsGround}[kind]
    return cls.from_coef(torch.as_tensor(gc), pg.PerlinGround(torch.zeros(3), 3))


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("kind", ["fourier", "perlin", "stairs"])
def test_query_per_env_matches_reference(kind, far):
    g, gc = _reference_grounds(kind)
    xy = _points(10 + far, far)
    hj, nj = jax.vmap(lambda gg, x: gg.query(x))(g, jnp.asarray(xy))
    hp, np_ = _port_ground(kind, gc).query(torch.as_tensor(xy))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), atol=ATOL, rtol=0)
    assert np.asarray(hj).std() > 1e-3  # the points see terrain, not a plane


@pytest.mark.parametrize("kind", ["fourier", "perlin", "stairs"])
def test_query_shared_matches_reference(kind):
    """One ground for a batch of points, and the env's own termination
    query shape (B, 2)."""
    g, gc = _reference_grounds(kind)
    g0 = jax.tree.map(lambda x: x[0], g)
    port = _port_ground(kind, gc[0])
    for xy in (_points(20, True), _points(21, False)[:, 0]):
        hj, nj = g0.query(jnp.asarray(xy))
        hp, np_ = port.query(torch.as_tensor(xy))
        np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
        np.testing.assert_allclose(np_.numpy(), np.asarray(nj), atol=ATOL, rtol=0)


def test_perlin_hash_bit_equal():
    rng = np.random.default_rng(4)
    ix, iy = (rng.integers(-70000, 70000, 4096).astype(np.int32) for _ in range(2))
    ix[:8] = [-1, 0, -2147, 2147, -65536, 65535, 1, -3]
    seed = rng.integers((1 << 24) - 4096, 1 << 24, 4096).astype(np.int32)
    seed[:4] = [0, 1, (1 << 24) - 1, 1013 * 7]
    ref = np.asarray(jg._perlin_hash2(*(jnp.asarray(a) for a in (ix, iy, seed))))
    port = pg._perlin_hash2(*(torch.as_tensor(a, dtype=torch.int64) for a in (ix, iy, seed)))
    np.testing.assert_array_equal(port.numpy(), ref.astype(np.int64))
    assert (ref < 0).any() and (ref > 0).any()  # wraps both ways


def test_coef_round_trip_and_per_env_rows():
    """``coef``/``from_coef`` move between the object and the vector
    envs carry; row b of a per-env ground queries as the shared ground
    b does."""
    for kind in ("fourier", "perlin", "stairs"):
        _, gc = _reference_grounds(kind)
        g = _port_ground(kind, gc)
        assert torch.equal(type(g).from_coef(g.coef(), g).coef(), g.coef())
        xy = torch.as_tensor(_points(30, True))
        h, n = g.query(xy)
        for b in range(B):
            hb, nb = _port_ground(kind, gc[b]).query(xy[b])
            assert torch.equal(hb, h[b]) and torch.equal(nb, n[b])


def test_heightmap_query_matches_reference():
    rng = np.random.default_rng(5)
    z = rng.uniform(-0.2, 0.2, (40, 30)).astype(np.float32)
    args = dict(x0=-1.5, y0=-1.0, dx=0.1, dy=0.07)
    xy = rng.uniform(-3.0, 3.0, (B, 50, 2)).astype(np.float32)  # partly off the grid
    hj, nj = jg.HeightmapGround.create(z, **args).query(jnp.asarray(xy))
    hp, np_ = pg.HeightmapGround.create(z, device="cpu", **args).query(torch.as_tensor(xy))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), atol=1e-6, rtol=0)


def _grids():
    """(reference, port) heightmaps of each generator and combinator."""
    kw = dict(size=2.0, resolution=0.1)
    a = (jt.perlin_ground(seed=3, flat_radius=0.5, **kw),
         pt.perlin_ground(seed=3, flat_radius=0.5, device="cpu", **kw))
    b = (jt.stairs_ground(step_width=0.3, step_height=0.1, n_steps=4, **kw),
         pt.stairs_ground(step_width=0.3, step_height=0.1, n_steps=4, device="cpu", **kw))
    c = (jt.stairs_ground(axis=1, **kw), pt.stairs_ground(axis=1, device="cpu", **kw))
    return {
        "perlin": a, "stairs": b, "stairs_y": c,
        "sum": (jt.sum_ground(a[0], b[0]), pt.sum_ground(a[1], b[1])),
        "merge": (jt.merge_ground(a[0], c[0]), pt.merge_ground(a[1], c[1])),
        "discretize": (jt.discretize_ground(a[0], 0.05), pt.discretize_ground(a[1], 0.05)),
    }


@pytest.mark.parametrize("name", ["perlin", "stairs", "stairs_y", "sum", "merge", "discretize"])
def test_terrain_matches_reference(name):
    ref, port = _grids()[name]
    np.testing.assert_array_equal(port.z.numpy(), np.asarray(ref.z))
    for f in ("x0", "y0", "dx", "dy"):
        assert float(getattr(port, f)) == float(getattr(ref, f))
    assert np.asarray(ref.z).std() > 0.0


def test_terrain_rejects_mismatched_grids():
    a = pt.stairs_ground(size=1.0, device="cpu")
    with pytest.raises(ValueError, match="identical grids"):
        pt.sum_ground(a, pt.stairs_ground(size=2.0, device="cpu"))


def test_random_processes_match_reference():
    """PCG32's stream and the table-based Perlin noise, to the bit."""
    a, b = jr.PCG32(7), pr.PCG32(7)
    assert [a.uint32() for _ in range(64)] == [b.uint32() for _ in range(64)]
    np.testing.assert_array_equal(pr.PCG32(9).normal_vec(16), jr.PCG32(9).normal_vec(16))
    x = np.linspace(-3.3, 5.1, 37)
    for period in (None, 4):
        j, p = jr.PerlinNoise(5, period), pr.PerlinNoise(5, period)
        np.testing.assert_array_equal(p(x), j(x))
        np.testing.assert_array_equal(p(x, x[::-1]), j(x, x[::-1]))
        np.testing.assert_array_equal(p(x, x, 0.5 * x), j(x, x, 0.5 * x))
        np.testing.assert_array_equal(p.octaves(x, x, n=3), j.octaves(x, x, n=3))


def test_fourier_sampler_statistics():
    gen = torch.Generator().manual_seed(0)
    g = pg.sample_fourier_ground(gen, n_terms=24, amplitude=0.12, batch_shape=(3,))
    assert g.gc.shape == (3, 96) and g.gc.dtype == torch.float32
    ref = jg.sample_fourier_ground(jax.random.PRNGKey(0), n_terms=24, amplitude=0.12)
    np.testing.assert_allclose(g.amp[0].numpy(), np.asarray(ref.amp), rtol=1e-6)
    xs = torch.linspace(-20.0, 20.0, 200)
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    pts = torch.stack([X.ravel(), Y.ravel()], -1)
    for b in range(3):  # process std ≈ amplitude/√2
        h, _ = pg.FourierGround(g.gc[b]).query(pts)
        assert 0.4 * 0.12 < float(h.std()) < 1.2 * 0.12
    k = torch.hypot(g.kx, g.ky)  # wave numbers in the octave bands
    k0 = 2 * np.pi / 2.0 * 2.0 ** (torch.arange(24) % 3)
    assert bool(((k >= 0.75 * k0 - 1e-5) & (k <= 1.25 * k0 + 1e-5)).all())
    h, _ = g.query(torch.tensor([[1.0, 2.0]]).expand(3, 2))
    assert float(h.std()) > 1e-3  # per-env grounds differ


def test_perlin_sampler_statistics():
    gen = torch.Generator().manual_seed(1)
    g = pg.sample_perlin_ground(gen, amplitude=0.08, wavelength=1.5, batch_shape=(3,))
    ref = jg.sample_perlin_ground(jax.random.PRNGKey(1), amplitude=0.08, wavelength=1.5)
    assert g.gc[:, 1].eq(float(ref.freq)).all() and g.gc[:, 2].eq(float(ref.amp)).all()
    seeds = g.seed
    assert bool((seeds == seeds.round()).all() and (seeds >= 0).all() and (seeds < 2**24).all())
    assert len(set(seeds.tolist())) == 3
    xs = torch.linspace(-30.0, 30.0, 150)
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    pts = torch.stack([X.ravel(), Y.ravel()], -1)
    for b in range(3):  # the fBm sum is normalized to std ≈ amplitude
        h, _ = pg.PerlinGround(g.gc[b], 3).query(pts)
        assert 0.5 * 0.08 < float(h.std()) < 1.5 * 0.08
