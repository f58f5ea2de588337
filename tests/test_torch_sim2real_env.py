"""The full sim-to-real ANYmal env (per-env model randomization on top of
the terrain, pushes and sensors): the port against jiminy_tpu's, and the
randomization hooks.

The slice's env, ``ANYmalEnv(terrain="fourier", push_magnitude=100,
push_duration=0.2, observe="sensors", sensor_delay=0.004, imu_noise=0.02,
encoder_noise=0.005, model_randomization=ModelRandomization(mass_scale=
(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2), motor_gain=(0.9,
1.1)))`` (``anymal_sim2real_run5``: examples/train.py with
``--randomize 0.2``), with ``push_prob=0.5``, is built by both packages.
One ``step_no_reset`` from the same state: tests/test_torch_terrain_env.py's
start (numpy-made joints, velocities, bases over ±2 m of one numpy-made
16-term Fourier ground per env, a push state) with each env's model
parameters made with numpy at the slice's ranges (armature and friction
scales too) and per-env sensor offsets of ±0.05 (the calibration axis,
``info["sensor_bias"]``, which both envs add to every corruption draw),
carried across by ``env_state_from_arrays``; the reference's own noise
and push draws handed to the port through ``_sensor_eps`` (the offsets
added by the port's own ``_sensor_bias`` hook) and ``_push_draws``. The
reference runs its chunked fallback on its ``"xla"`` engine (the
parameters through ``apply_to_tree`` / ``apply_to_motors``); the port its
fused path (K2's plain version with the sensor stage, the ground
coefficients and the packed parameters) and its chunked fallback.
Tolerances are tests/test_torch_terrain_env.py's (q, v 1e-4; the buffers
reading by reading; obs 1e-4, the scaled accelerometer 2e-3; reward 1e-4).

Then, on the port alone at B = 4 on the CPU: the auto-reset draws fresh
parameters where an episode ends and keeps the others; ``sensor_bias``
shifts the noise-free readings by each env's own offsets; halved masses
move the env (the reference's tests/test_model_randomization.py checks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.ground import FourierGround as JFourierGround
from jiminy_tpu.engine.randomization import ModelParams as JModelParams
from jiminy_tpu.engine.randomization import ModelRandomization as JModelRandomization
from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.randomization import ModelParams, ModelRandomization
from jiminy_tpu_torch.envs import ANYmalEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B, K = 4, 16
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
RANDOMIZE = dict(mass_scale=(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2),
                 motor_gain=(0.9, 1.1))
SLICE = dict(terrain="fourier", push_magnitude=100.0, push_duration=0.2, observe="sensors",
             sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, step_dt=0.02,
             sim_dt=5e-3, pgs_iters=8)
ATOL_READING = {
    "imu": [1e-4] * 4 + [2e-4] * 3 + [4e-2] * 3,
    "encoder": [2e-4, 2e-4],
    "effort": [5e-4],
    "contact": [4e-2] * 3,
}


def _coef(ground) -> np.ndarray:
    return np.concatenate([np.asarray(x) for x in (ground.amp, ground.kx, ground.ky, ground.phase)],
                          -1)


class _Ref:
    """The reference env on its fallback path, its jitted step, a
    template state, and its draws for a step (the noise without the
    offsets)."""

    def __init__(self):
        self.env = env = JANYmalEnv(push_prob=0.5,
                                    model_randomization=JModelRandomization(**RANDOMIZE), **SLICE)
        assert env.engine._solver_backend == "xla"
        env._fused_sensors = False
        # step_no_reset: an auto-reset's fresh info would lack the offsets
        # this test carries in (the slice's sensor_bias is 0)
        self.step = jax.jit(jax.vmap(env.step_no_reset))
        self.flat = jax.jit(jax.vmap(env.sensors.flatten_buffers))
        self.template = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), B))

        def draws(rng):
            suite, n = env.sensors, env.n_obs_updates
            _, _, k_info, k_sens = jax.random.split(rng, 4)
            keys = jax.random.split(k_sens, n)
            eps = jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])
            k1, k2 = jax.random.split(k_info)
            onset = jax.random.bernoulli(k1, env.push_prob)
            theta = jax.random.uniform(k2, (), minval=0.0, maxval=2 * jnp.pi)
            return eps, onset, theta

        self.draws = jax.jit(jax.vmap(draws))

    def arrays(self, state) -> dict:
        info = {}
        for k, x in state.info.items():
            if k == "model_params":
                info[k] = {f: np.asarray(getattr(x, f)) for f in ModelParams.FIELDS}
            elif k == "sensor_bias":
                info[k] = [np.asarray(g) for g in x]
            elif k == "ground":
                info[k] = _coef(x)
            else:
                info[k] = np.asarray(self.flat(x)) if isinstance(x, tuple) else np.asarray(x)
        return {
            "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
            "obs": np.asarray(state.obs), "reward": np.asarray(state.reward),
            "terminated": np.asarray(state.terminated), "truncated": np.asarray(state.truncated),
            "steps": np.asarray(state.steps), "info": info,
        }


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _start(ref, seed):
    rng = np.random.default_rng(seed)
    t, env = ref.template, ref.env
    octave = np.arange(K) % 3
    amp = 0.5**octave / np.sqrt(np.bincount(octave)[octave])
    amp *= 0.08 / np.sqrt(np.sum(0.25 ** np.arange(3)))
    theta = rng.uniform(0, 2 * np.pi, (B, K))
    mag = 2 * np.pi / 1.5 * 2.0**octave * rng.uniform(0.75, 1.25, (B, K))
    gc = np.concatenate([np.tile(amp, (B, 1)), mag * np.cos(theta), mag * np.sin(theta),
                         rng.uniform(0, 2 * np.pi, (B, K))], 1).astype(np.float32)
    q = np.array(t.sim.q, np.float64)
    q[:, 0:2] = rng.uniform(-2.0, 2.0, (B, 2))
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    h, _ = pg.FourierGround(torch.as_tensor(gc, dtype=torch.float64)).query(torch.as_tensor(q[:, :2]))
    q[:, 2] = float(env._q_stand[2]) + h.numpy() + rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    action = rng.uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    nb, nv, nm = env.tree.nb, env.tree.nv, 12

    def u(shape, lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    params = JModelParams(
        mass_scale=u((B, nb), 0.8, 1.2), com_offset=u((B, nb, 3), -0.02, 0.02),
        inertia_scale=u((B, nb), 0.8, 1.2), armature_scale=u((B, nv), 0.7, 1.3),
        motor_gain=u((B, nm), 0.9, 1.1), motor_friction_scale=u((B, nm), 0.5, 2.0))
    bias = tuple(u((B,) + g.bias.shape, -0.05, 0.05) for g in env.sensors.groups)
    ang = rng.uniform(0, 2 * np.pi, B)
    force = 100.0 * np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], 1)
    info = {**t.info, "model_params": params, "sensor_bias": bias,
            "ground": JFourierGround(*(jnp.asarray(gc[:, i * K:(i + 1) * K]) for i in range(4))),
            "push_force": jnp.asarray(force, jnp.float32),
            "push_steps_left": jnp.asarray([5, 1, 0, 0], jnp.int32)}
    sim = t.sim.replace(q=jnp.asarray(q, jnp.float32), v=jnp.asarray(v, jnp.float32),
                        lam=jnp.asarray(lam, jnp.float32))
    return t.replace(sim=sim, info=info, steps=jnp.asarray([3, 7, 11, 0], jnp.int32)), action


def _close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chunked"])
def test_step_no_reset_matches_reference(ref, fused):
    jst, action = _start(ref, seed=0)
    eps, onset, theta = (np.asarray(x) for x in ref.draws(jst.rng))
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)))
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    env = ANYmalEnv(push_prob=0.5, model_randomization=ModelRandomization(**RANDOMIZE),
                    device="cpu", **SLICE)
    assert env.engine.backend == "substep" and env._fused_sensors
    env._fused_sensors = fused
    seen = []

    def sensor_eps(generator, batch_size, n_updates, bias_extra=None):
        seen.append(bias_extra)
        offsets = torch.cat([b.reshape(batch_size, -1) for b in bias_extra], 1)
        return torch.as_tensor(eps) + offsets.repeat(1, n_updates)

    env._sensor_eps = sensor_eps
    env._push_draws = lambda generator, batch_size: (torch.as_tensor(onset), torch.as_tensor(theta))
    tst = env_state_from_arrays(ref.arrays(jst), torch.Generator().manual_seed(0), device="cpu",
                                engine=env.engine)
    assert tst.info["model_params"].shape == (B, 10 * 13 + 18 + 2 * 12)
    assert tst.info["sensor_bias"].shape == (B, env.sensors.n_eps)
    tnext = env.step_no_reset(tst, torch.as_tensor(action))
    assert len(seen) == 1 and seen[0] is not None  # the offsets reached the draws

    sim = jnext["sim"]
    assert np.abs(sim["lam"][:, 12:]).max() > 0.05  # feet on the terrain
    _close(tnext.sim.q, sim["q"], 1e-4)
    _close(tnext.sim.v, sim["v"], 1e-4)
    suite = env.sensors
    for g, p, r in zip(suite.groups, suite.unflatten_buffers(tnext.info["sensor_bufs"]),
                       suite.unflatten_buffers(torch.as_tensor(jnext["info"]["sensor_bufs"]))):
        assert not ((p - r).abs() > torch.tensor(ATOL_READING[g.type])).any(), g.type
    _close(tnext.obs[:, :6], jnext["obs"][:, :6], 1e-4)
    _close(tnext.obs[:, 6:9], jnext["obs"][:, 6:9], 2e-3)  # 0.05 · accelerometer
    _close(tnext.obs[:, 9:], jnext["obs"][:, 9:], 1e-4)
    _close(tnext.reward, jnext["reward"], 1e-4)
    np.testing.assert_array_equal(tnext.terminated.numpy(), jnext["terminated"])
    # the per-env parameters ride along unchanged
    assert torch.equal(tnext.info["model_params"], tst.info["model_params"])
    assert torch.equal(tnext.info["sensor_bias"], tst.info["sensor_bias"])


def _port_env(**kw):
    return ANYmalEnv(device="cpu", **{**SLICE, "model_randomization": ModelRandomization(**RANDOMIZE),
                                      **kw})


def test_auto_reset_draws_fresh_parameters():
    env = _port_env(observe="state")
    st = env.reset(torch.Generator().manual_seed(3), B)
    m0 = env.tree.inertia_mass
    scale = env._model_params(st.info)[:, :13][:, m0 > 0] / m0[m0 > 0]
    assert float(scale.min()) >= 0.8 - 1e-6 and float(scale.max()) <= 1.2 + 1e-6
    assert float(scale.std()) > 0.05  # per env and per body
    st = env.step(st, torch.zeros(B, 12))
    q = st.sim.q.clone()
    q[0, 2] = -1.0  # env 0 below its ground: terminated
    st = st.replace(sim=type(st.sim)(**{**st.sim.__dict__, "q": q}))
    before = st.info["model_params"].clone()
    nxt = env.step(st, torch.zeros(B, 12))
    assert nxt.terminated.tolist() == [True, False, False, False]
    assert not torch.equal(nxt.info["model_params"][0], before[0])  # a fresh draw
    assert torch.equal(nxt.info["model_params"][1:], before[1:])
    assert env._model_params(nxt.info).shape == (B, env.engine.substep_spec.n_mp)


def test_sensor_bias_shifts_readings():
    """Noise-free sensors with ±0.1 offsets: each env's fresh buffers
    read its own measurement plus its own offsets; another seed, other
    offsets."""
    env = _port_env(terrain=None, push_magnitude=0.0, imu_noise=0.0, encoder_noise=0.0,
                    sensor_delay=0.0,
                    model_randomization=ModelRandomization(
                        mass_scale=(1.0, 1.0), com_offset=0.0, inertia_scale=(1.0, 1.0),
                        motor_gain=(1.0, 1.0), sensor_bias=0.1))
    st = env.reset(torch.Generator().manual_seed(3), B)
    suite = env.sensors
    bias = st.info["sensor_bias"]
    assert bias.shape == (B, suite.n_eps) and float(bias.abs().max()) > 0.05
    offsets = dict(zip((g.type for g in suite.groups), suite._split_eps(bias)))
    bufs = dict(zip((g.type for g in suite.groups),
                    suite.unflatten_buffers(st.info["sensor_bufs"])))
    enc = next(g for g in suite.groups if g.type == "encoder")
    q_enc = st.sim.q[:, [env.tree.q_off[j] for j in enc.target]]
    torch.testing.assert_close(bufs["encoder"][:, :, 0, 0] - q_enc, offsets["encoder"][..., 0],
                               atol=1e-6, rtol=0)
    other = env.reset(torch.Generator().manual_seed(4), B)
    assert float((other.info["sensor_bias"] - bias).abs().max()) > 1e-4
    state_env = _port_env(observe="state", model_randomization=ModelRandomization(sensor_bias=0.1))
    assert "sensor_bias" not in state_env.reset(torch.Generator(), B).info


def test_halved_masses_move_the_env():
    heavy = _port_env(observe="state", terrain=None, push_magnitude=0.0,
                      model_randomization=ModelRandomization(mass_scale=(0.5, 0.5)))
    nominal = _port_env(observe="state", terrain=None, push_magnitude=0.0,
                        model_randomization=None)
    a = heavy.reset(torch.Generator().manual_seed(0), B)
    b = nominal.reset(torch.Generator().manual_seed(0), B)
    a = a.replace(sim=b.sim)
    assert torch.equal(heavy._model_params(a.info)[:, :13],
                       (0.5 * heavy.tree.inertia_mass).expand(B, -1))
    for _ in range(3):
        a = heavy.step_no_reset(a, torch.zeros(B, 12))
        b = nominal.step_no_reset(b, torch.zeros(B, 12))
    assert float((a.sim.q - b.sim.q).abs().max()) > 1e-3
    assert bool(torch.isfinite(a.sim.q).all())
    two = type(a.sim)(**{k: getattr(a.sim, k)[:2] for k in a.sim.FIELDS})
    with pytest.raises(ValueError, match=r"model parameters mp of shape \(4, 172\)"):
        heavy.engine.step(two, torch.zeros(2, 12), model_params=heavy._model_params(a.info))


def test_heightmap_env_randomizes_on_the_chain_kernel_path():
    """A heightmap is outside the whole-substep kernels: the randomized
    env resolves to ``"kernel"`` and steps the plain physics on each env's
    inertials; the same state with other parameters steps elsewhere."""
    env = _port_env(terrain="perlin_grid", observe="state", push_magnitude=0.0)
    assert env.engine.backend == "kernel"
    st = env.reset(torch.Generator().manual_seed(5), B)
    one = type(st.sim)(**{k: getattr(st.sim, k)[:1].expand_as(getattr(st.sim, k)).clone()
                          for k in st.sim.FIELDS})
    nxt = env.step_no_reset(st.replace(sim=one), torch.zeros(B, 12))
    assert bool(torch.isfinite(nxt.sim.q).all())
    assert float((nxt.sim.v[1:] - nxt.sim.v[:1]).abs().max()) > 1e-3
