"""The port's sensor suite against jiminy_tpu's.

ANYmal's suite (1 IMU on the base frame, 12 encoders, 12 effort and 4
contact sensors, sampled every 5 ms) is built by both packages with the
flagship's sensor configuration (delay 0.004 s, IMU noise 0.02, encoder
noise 0.005); the port's suite is held field for field against the
reference's ``robot.sensors``. Then, on seeded numpy states of ANYmal
(B = 3, one of them turned half a turn about z so that the IMU
quaternion comes from the z candidate with w near 0), the measurements
of all five types (``force`` on a suite of its own), ``update`` with the
reference's ``sample_eps`` draws handed to the port, ``reset``, ``read``
at a delay of 0.004 s (0.8 of a period) and of exactly one period, and
the flat buffer layout. The reference runs vmapped on the CPU.

Tolerances: float32 measurements atol 2e-5 on values up to ~10³ with
rtol 1e-5 (reassociation); ``update``, ``reset`` and ``read`` run in
float64 on both sides (``jax_enable_x64``) at 1e-9, so that a slot or
weight error cannot hide under float32 noise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.hardware import sensors as jsensors
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.hardware import sensors
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.models.quadruped import make_anymal

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 3
PERIOD = 5e-3
FLAGSHIP = dict(sensor_period=PERIOD, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)


@pytest.fixture(scope="module")
def suites():
    jrobot = j_make_anymal(**FLAGSHIP)
    _, _, suite = make_anymal(device="cpu", **FLAGSHIP)
    return jrobot, suite


def _delayed_suites(jtree, tree):
    """Both packages' ANYmal suites with the IMU and the efforts 0.004 s
    late (0.8 of a period) and the encoders and contacts exactly one
    period late, and a distinct bias per sensor and dim (so that the eps
    layout shows)."""
    d, one = 0.004, PERIOD
    specs = [sensors.imu_spec("base_frame", delay=d, noise_std=0.02,
                              bias=np.linspace(0.0, 0.08, 9))]
    specs += [sensors.encoder_spec(n, delay=one, noise_std=0.005, bias=(0.001 * i, -0.002 * i))
              for i, n in enumerate(tree.joint_name[1:])]
    specs += [sensors.effort_spec(n, delay=d, bias=0.1 * i) for i, n in enumerate(tree.joint_name[1:])]
    specs += [sensors.contact_spec(n, delay=one, noise_std=1.0) for n in tree.contact_frame_name]
    return (jsensors.SensorSuite.build(jtree, specs, PERIOD),
            sensors.SensorSuite.build(tree, specs, PERIOD))


def _states(jtree, seed, dtype=np.float32):
    """(q, v, a, contact forces, τ) around the stand pose; env 0 turned
    half a turn (±1–11 mrad) about z."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(j_stand_q(jtree), np.float64), (B, 1))
    q[:, 7:] += rng.uniform(-0.3, 0.3, (B, 12))
    yaw = np.pi + np.sign(rng.uniform(-1, 1, B)) * rng.uniform(1e-3, 1.1e-2, B)
    yaw[1:] = rng.uniform(-0.5, 0.5, B - 1)
    tilt = rng.uniform(-0.1, 0.1, (B, 2))
    quat = np.stack([tilt[:, 0], tilt[:, 1], np.sin(yaw / 2), np.cos(yaw / 2)], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.standard_normal((B, 18))
    a = 50.0 * rng.standard_normal((B, 18))
    f = 100.0 * rng.standard_normal((B, 4, 3))
    tau = 20.0 * rng.standard_normal((B, 18))
    return [x.astype(dtype) for x in (q, v, a, f, tau)]


def _t(x):
    return torch.as_tensor(np.asarray(x))


SUITE_FIELDS = ("type", "target", "name", "buf_len", "delay", "bias", "noise_std")


@pytest.mark.parametrize("field", SUITE_FIELDS)
def test_anymal_suite_matches_reference(suites, field):
    jrobot, suite = suites
    jgroups = jrobot.sensors.groups
    assert [g.type for g in suite.groups] == ["imu", "encoder", "effort", "contact"]
    assert len(suite.groups) == len(jgroups)
    assert suite.period == jrobot.sensors.period
    for g, jg in zip(suite.groups, jgroups):
        a, b = getattr(g, field), getattr(jg, field)
        if field in ("type", "target", "name", "buf_len"):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the flagship's sizes: buf_len 3 where delayed, 2 without delay
    assert (suite.n_buf, suite.n_eps) == (1 * 3 * 10 + 12 * 3 * 2 + 12 * 2 * 1 + 4 * 2 * 3, 57)


def test_matrix_to_quat_matches_reference():
    """Random rotations plus the knife edges: half turns about x, y and z
    (w = 0 exactly: the sign rule) and near them, ties between
    candidates (the first maximum wins)."""
    rng = np.random.default_rng(0)
    quats = [rng.standard_normal(4) for _ in range(64)]
    for axis in range(3):
        for w in (0.0, 1e-3, -1e-3, 0.3):
            qq = np.zeros(4)
            qq[axis], qq[3] = 1.0, w
            quats.append(qq)
    quats += [np.array([1.0, 1.0, 0.0, 0.0]), np.array([1.0, 1.0, 1.0, 1.0]), np.array([0, 0, 0, 1.0])]
    quats = np.stack([q / np.linalg.norm(q) for q in quats]).astype(np.float32)
    R = np.array(jax.vmap(jso3.quat_to_matrix)(jnp.asarray(quats)))
    ref = np.asarray(jax.vmap(jso3.matrix_to_quat)(jnp.asarray(R)))
    out = so3.matrix_to_quat(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert (out[:, 3] >= 0).all()


def test_body_accelerations_match_reference(suites):
    jrobot, suite = suites
    q, v, a, _, _ = _states(jrobot.tree, seed=1)
    ref = jax.jit(jax.vmap(lambda *x: jalgos.body_accelerations(jrobot.tree, *x)))(q, v, a)
    xw, vel, acc = algos.body_accelerations(suite.tree, _t(q), _t(v), _t(a))
    jxw, jvel, jacc = ref
    for i in range(suite.tree.nb):
        np.testing.assert_allclose(xw[i].rot.numpy(), np.asarray(jxw[i].rot), atol=1e-6, rtol=0)
        np.testing.assert_allclose(xw[i].pos.numpy(), np.asarray(jxw[i].pos), atol=1e-6, rtol=0)
        np.testing.assert_allclose(vel[i].numpy(), np.asarray(jvel[i]), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(acc[i].numpy(), np.asarray(jacc[i]), atol=2e-4, rtol=1e-6)


def test_measure_all_every_type_matches_reference(suites):
    """imu, encoder, effort and contact on ANYmal's suite, and force (the
    foot wrench at each foot frame) on a suite of its own."""
    jrobot, suite = suites
    jtree, tree = jrobot.tree, suite.tree
    force_specs = [sensors.force_spec(n) for n in tree.contact_frame_name]
    pairs = [
        (jrobot.sensors, suite),
        (jsensors.SensorSuite.build(jtree, force_specs, PERIOD),
         sensors.SensorSuite.build(tree, force_specs, PERIOD)),
    ]
    q, v, a, f, tau = _states(jtree, seed=2)
    seen = []
    for jsuite, psuite in pairs:
        ref = jax.jit(jax.vmap(jsuite.measure_all))(q, v, a, f, tau)
        out = psuite.measure_all(*(_t(x) for x in (q, v, a, f, tau)))
        for g, r, o in zip(psuite.groups, ref, out):
            assert o.shape == (B, g.ns, g.dim)
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=1e-5)
            seen.append(g.type)
    assert sorted(seen) == sorted(sensors.SENSOR_DIMS)
    # env 0's base is half a turn about z: its IMU quaternion has w ≈ 0
    quat = suite.measure_all(*(_t(x) for x in (q, v, a, f, tau)))[0][:, 0, :4]
    assert 0 < abs(float(quat[0, 3])) < 0.02


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def test_reset_update_read_match_reference(x64, suites):
    """reset, then three updates, each with the reference's sample_eps
    draws handed to the port as eps; read after each. float64 on both
    sides."""
    jrobot, psuite = suites
    jsuite, suite = _delayed_suites(jrobot.tree, psuite.tree.to(dtype=torch.float64))
    assert [g.buf_len for g in suite.groups] == [g.buf_len for g in jsuite.groups] == [3] * 4
    q, v, a, f, tau = _states(jrobot.tree, seed=3, dtype=np.float64)
    keys = _keys(4)
    jb = jax.jit(jax.vmap(lambda k, q_, v_: jsuite.reset(k, q_, v_)))(keys, q, v)
    sample = jax.jit(jax.vmap(jsuite.sample_eps))
    update = jax.jit(jax.vmap(jsuite.update))
    read = jax.jit(jax.vmap(jsuite.read))
    eps = np.asarray(sample(keys))
    pb = suite.reset(_t(eps), _t(q), _t(v))
    for j, p in zip(jb, pb):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-9, rtol=0)
    rng = np.random.default_rng(5)
    for step in range(3):
        keys = _keys(10 + step)
        q = q + 0.05 * rng.standard_normal(q.shape)
        v, a, f, tau = (x + rng.standard_normal(x.shape) for x in (v, a, f, tau))
        jb = update(jb, keys, q, v, a, f, tau)
        eps = np.asarray(sample(keys))
        pb = suite.update(pb, _t(eps), *(_t(x) for x in (q, v, a, f, tau)))
        for j, p in zip(jb, pb):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-9, rtol=0)
        jr = read(jb)
        pr = suite.read(pb)
        for typ in jr:
            np.testing.assert_allclose(pr[typ].numpy(), np.asarray(jr[typ]), atol=1e-9, rtol=0)
    # 0.8 of a period puts the read between slots 0 and 1 (the weights
    # are 0.8 rounded to float32, as the reference rounds them), one
    # period exactly on slot 1
    np.testing.assert_allclose(pr["effort"].numpy(),
                               (0.2 * pb[2][:, :, 0] + 0.8 * pb[2][:, :, 1]).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(pr["encoder"].numpy(), pb[1][:, :, 1].numpy())
    np.testing.assert_array_equal(pr["contact"].numpy(), pb[3][:, :, 1].numpy())


def test_flatten_buffers_matches_reference(suites):
    jrobot, suite = suites
    rng = np.random.default_rng(6)
    bufs = tuple(rng.standard_normal((B, g.ns, g.buf_len, g.dim)).astype(np.float32)
                 for g in suite.groups)
    ref = np.asarray(jax.vmap(jrobot.sensors.flatten_buffers)(tuple(jnp.asarray(b) for b in bufs)))
    flat = suite.flatten_buffers(tuple(_t(b) for b in bufs))
    assert flat.shape == (B, suite.n_buf)
    np.testing.assert_array_equal(flat.numpy(), ref)
    for b, u in zip(bufs, suite.unflatten_buffers(flat)):
        np.testing.assert_array_equal(u.numpy(), b)
    zeros = suite.flatten_buffers(suite.init_buffers(B))
    assert zeros.shape == (B, suite.n_buf) and not zeros.any()


def test_sample_eps_layout(suites):
    """Noise-free, sample_eps is the bias (plus the per-env bias_extra)
    in the reference's [group][sensor][dim] layout; with noise, its
    spread per entry is noise_std."""
    jrobot, psuite = suites
    jsuite, suite = _delayed_suites(jrobot.tree, psuite.tree)
    rng = np.random.default_rng(7)
    extra = [rng.standard_normal((B, g.ns, g.ndim)).astype(np.float32) for g in suite.groups]
    quiet = [dataclasses.replace(g, noise_std=0.0 * g.noise_std) for g in suite.groups]
    jquiet = [jg.replace(noise_std=0.0 * jg.noise_std) for jg in jsuite.groups]
    ref = np.asarray(jax.jit(jax.vmap(
        jsensors.SensorSuite(jsuite.tree, jquiet, PERIOD).sample_eps
    ))(_keys(8), tuple(jnp.asarray(e) for e in extra)))
    out = sensors.SensorSuite(suite.tree, quiet, PERIOD).sample_eps(
        torch.Generator().manual_seed(0), B, tuple(_t(e) for e in extra))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7, rtol=0)
    big = suite.sample_eps(torch.Generator().manual_seed(1), 20000)
    std = torch.cat([g.noise_std.reshape(-1) for g in suite.groups])
    bias = torch.cat([g.bias.reshape(-1) for g in suite.groups])
    torch.testing.assert_close(big.std(0), std, atol=0.03 * float(std.max()), rtol=0.03)
    torch.testing.assert_close(big.mean(0), bias, atol=0.03 * float(std.max()), rtol=0)
