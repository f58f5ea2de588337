"""The ANYmal env on per-env terrain with pushes: the port against
jiminy_tpu's, and the terrain and push hooks.

The slice's env, ``ANYmalEnv(terrain="fourier", push_magnitude=100,
push_duration=0.2, observe="sensors", sensor_delay=0.004, imu_noise=0.02,
encoder_noise=0.005)`` (step_dt 0.02, sim_dt 5e-3, 8 sweeps; the settings
of ``anymal_sim2real_run5`` without model randomization), with
``push_prob=0.5`` so that onsets occur among B = 4 envs, is built by both
packages. One ``step_no_reset`` from the same state: the reference's reset
states with numpy-made joints, velocities and bases spread over ±2 m and
raised by the height under them, one numpy-made 16-term Fourier ground
per env, a push state with one env mid-push, one on its last push step
and two free; the reference's own sensor eps and push draws (its keys,
handed to the port through ``_sensor_eps`` and ``_push_draws``). The
reference runs its chunked fallback on its ``"xla"`` engine; the port its
fused path (K2's plain version with the sensor stage and the ground
coefficients) and its chunked fallback. Tolerances are
tests/test_torch_sensor_env.py's (q, v 1e-4; the buffers reading by
reading; obs 1e-4, the scaled accelerometer 2e-3; reward 1e-4); the push
state exactly (its force to 1e-5).

Then, on the port alone at B = 4 on the CPU: the push schedule (onset,
magnitude, count-down, no restart mid-push, a shove that moves the base,
the world force rotated into the base frame), the auto-reset picking each
env's ground and push state, the termination and spawn height measured
against each env's own ground, and the ``"perlin_grid"`` heightmap (the
reference's grid to the bit) on the chain-kernel path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.ground import FourierGround as JFourierGround
from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.envs import ANYmalEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B, K = 4, 16
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
SLICE = dict(terrain="fourier", push_magnitude=100.0, push_duration=0.2, observe="sensors",
             sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, step_dt=0.02,
             sim_dt=5e-3, pgs_iters=8)
# per reading, as tests/test_torch_sensor_env.py holds them
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
    template state, and its draws for a step."""

    def __init__(self):
        self.env = env = JANYmalEnv(push_prob=0.5, **SLICE)
        assert env.engine._solver_backend == "xla" and env.push_steps == 10
        env._fused_sensors = False
        self.step = jax.jit(jax.vmap(env.step))
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
            info[k] = (np.asarray(self.flat(x)) if isinstance(x, tuple)
                       else _coef(x) if k == "ground" else np.asarray(x))
        return {
            "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
            "obs": np.asarray(state.obs), "reward": np.asarray(state.reward),
            "terminated": np.asarray(state.terminated), "truncated": np.asarray(state.truncated),
            "steps": np.asarray(state.steps), "info": info,
        }


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _fourier_coefficients(rng):
    octave = np.arange(K) % 3
    amp = 0.5**octave / np.sqrt(np.bincount(octave)[octave])
    amp *= 0.08 / np.sqrt(np.sum(0.25 ** np.arange(3)))
    theta = rng.uniform(0, 2 * np.pi, (B, K))
    mag = 2 * np.pi / 1.5 * 2.0**octave * rng.uniform(0.75, 1.25, (B, K))
    return np.concatenate([np.tile(amp, (B, 1)), mag * np.cos(theta), mag * np.sin(theta),
                           rng.uniform(0, 2 * np.pi, (B, K))], 1).astype(np.float32)


def _start(ref, seed):
    rng = np.random.default_rng(seed)
    t = ref.template
    gc = _fourier_coefficients(rng)
    q = np.array(t.sim.q, np.float64)
    q[:, 0:2] = rng.uniform(-2.0, 2.0, (B, 2))
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    h, _ = pg.FourierGround(torch.as_tensor(gc, dtype=torch.float64)).query(torch.as_tensor(q[:, :2]))
    q[:, 2] = float(ref.env._q_stand[2]) + h.numpy() + rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    action = rng.uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    ground = JFourierGround(*(jnp.asarray(gc[:, i * K:(i + 1) * K]) for i in range(4)))
    ang = rng.uniform(0, 2 * np.pi, B)
    force = 100.0 * np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], 1)
    info = {**t.info, "ground": ground,
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
    env = ANYmalEnv(push_prob=0.5, device="cpu", **SLICE)
    assert env.engine.backend == "substep" and env._fused_sensors
    env._fused_sensors = fused
    env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: torch.as_tensor(eps)
    env._push_draws = lambda generator, batch_size: (torch.as_tensor(onset), torch.as_tensor(theta))
    tst = env_state_from_arrays(ref.arrays(jst), torch.Generator().manual_seed(0), device="cpu")
    assert tst.info["push_steps_left"].dtype == torch.int32
    tnext = env.step_no_reset(tst, torch.as_tensor(action))

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
    info = jnext["info"]
    np.testing.assert_array_equal(tnext.info["push_steps_left"].numpy(), info["push_steps_left"])
    _close(tnext.info["push_force"], info["push_force"], 1e-5)
    np.testing.assert_array_equal(tnext.info["ground"].numpy(), info["ground"])
    # env 0 counts down mid-push, env 1 ends its push; the free envs
    # started one where their onset drew True
    left = info["push_steps_left"]
    assert left[0] == 4 and left[1] == 0
    assert list(left[2:] == 10) == list(onset[2:])


def _port_env(**kw):
    return ANYmalEnv(device="cpu", **{**SLICE, **kw})


def test_push_schedule():
    """Onsets start 10-step pushes of the set magnitude in the drawn
    direction; a push counts down and cannot restart before it ends."""
    env = _port_env(push_magnitude=60.0, observe="state")
    st = env.reset(torch.Generator().manual_seed(0), B)
    assert st.info["push_steps_left"].eq(0).all() and st.info["push_force"].eq(0).all()
    assert env._base_wrench(st).eq(0).all()  # no push yet
    onset = torch.tensor([True, True, False, False])
    theta = torch.tensor([0.0, 1.0, 2.0, 3.0])
    env._push_draws = lambda generator, batch_size: (onset, theta)
    st = env.step_no_reset(st, torch.zeros(B, 12))
    assert st.info["push_steps_left"].tolist() == [10, 10, 0, 0]
    torch.testing.assert_close(st.info["push_force"].norm(dim=1),
                               torch.tensor([60.0, 60.0, 0.0, 0.0]), rtol=1e-5, atol=0)
    torch.testing.assert_close(st.info["push_force"][1], 60.0 * torch.tensor(
        [np.cos(1.0), np.sin(1.0), 0.0], dtype=torch.float32), rtol=1e-6, atol=1e-6)
    force = st.info["push_force"].clone()
    theta = torch.full((B,), 2.5)  # envs 0 and 1 draw an onset at every step
    for k in range(1, 11):
        st = env.step_no_reset(st, torch.zeros(B, 12))
        assert st.info["push_steps_left"].tolist() == [10 - k, 10 - k, 0, 0]
        assert torch.equal(st.info["push_force"], force)  # no restart mid-push
    st = env.step_no_reset(st, torch.zeros(B, 12))  # ended: a new onset restarts it
    assert st.info["push_steps_left"].tolist() == [10, 10, 0, 0]
    torch.testing.assert_close(st.info["push_force"][0], 60.0 * torch.tensor(
        [np.cos(2.5), np.sin(2.5), 0.0], dtype=torch.float32), rtol=1e-6, atol=1e-6)


def test_push_wrench_is_the_world_force_in_the_base_frame():
    env = _port_env(observe="state", terrain=None)
    st = env.reset(torch.Generator().manual_seed(1), B)
    yaw = torch.tensor([0.0, np.pi / 2, np.pi, -np.pi / 2])
    q = st.sim.q.clone()
    q[:, 3:7] = torch.stack([torch.zeros(B), torch.zeros(B), torch.sin(yaw / 2),
                             torch.cos(yaw / 2)], 1)
    info = {**st.info, "push_force": torch.tensor([[100.0, 0.0, 0.0]]).expand(B, 3),
            "push_steps_left": torch.tensor([3, 3, 3, 0], dtype=torch.int32)}
    w = env._base_wrench(st.replace(sim=type(st.sim)(**{**st.sim.__dict__, "q": q}), info=info))
    want = torch.tensor([[0.0, 0, 0, 100, 0, 0], [0, 0, 0, 0, -100, 0],
                         [0, 0, 0, -100, 0, 0], [0, 0, 0, 0, 0, 0]])
    torch.testing.assert_close(w, want, atol=1e-4, rtol=0)


def test_push_shoves_the_base():
    """200 N along +x for 0.5 s on a 28 kg robot (push_prob 0: the hook
    alone) moves the base forward by more than 0.2 m."""
    env = _port_env(observe="state", terrain=None, push_magnitude=200.0, push_prob=0.0)
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = st.replace(info={**st.info, "push_force": torch.tensor([[200.0, 0.0, 0.0]] * 2),
                          "push_steps_left": torch.full((2,), 25, dtype=torch.int32)})
    for _ in range(25):
        st = env.step_no_reset(st, torch.zeros(2, 12))
    assert bool((st.sim.q[:, 0] > 0.2).all())
    free = _port_env(observe="state", terrain=None, push_magnitude=0.0)
    assert "push_force" not in free.reset(torch.Generator(), 2).info
    assert free._base_wrench(free.reset(torch.Generator(), 2)) is None


@pytest.mark.parametrize("terrain", ["fourier", "perlin"])
def test_spawn_and_termination_on_each_envs_ground(terrain):
    """Fresh episodes spawn on their own ground (the stand height above
    it); the height check of the termination reads each env's own
    ground."""
    env = _port_env(terrain=terrain, terrain_amplitude=0.3)
    st = env.reset(torch.Generator().manual_seed(2), B)
    assert st.info["ground"].shape == (B, env.engine.substep_spec.n_gc)
    ground = env._episode_ground(st.info)
    h, _ = ground.query(st.sim.q[:, :2])
    stand_z = float(env._q_stand[2])
    torch.testing.assert_close(st.sim.q[:, 2] - h, torch.full((B,), stand_z), atol=1e-6, rtol=0)
    sim = type(st.sim)(**{**st.sim.__dict__})
    sim.q = sim.q.clone()
    sim.q[:, :2] = torch.tensor([0.37, -0.61])  # off the lattice (Perlin is 0 on it)
    h, _ = ground.query(sim.q[:, :2])
    assert float(h.std()) > 1e-3  # the envs stand on different grounds
    sim.q[:, 2] = h + torch.tensor([0.25, 0.35, 0.25, 0.35])  # min_height 0.3 above each ground
    assert env._terminated(sim, st.info).tolist() == [True, False, True, False]
    flat = env._terminated(sim, {})  # against the engine's single ground instead
    h0, _ = env.engine.ground.query(sim.q[:, :2])
    assert flat.tolist() == ((sim.q[:, 2] - h0) < 0.3).tolist()


def test_auto_reset_picks_ground_and_push_state():
    env = _port_env(observe="state", push_prob=1.0)
    gen = torch.Generator().manual_seed(3)
    st = env.reset(gen, B)
    st = env.step(st, torch.zeros(B, 12))  # every env starts a push
    assert st.info["push_steps_left"].eq(10).all()
    q = st.sim.q.clone()
    q[0, 2] = -1.0  # env 0 below its ground: terminated
    st = st.replace(sim=type(st.sim)(**{**st.sim.__dict__, "q": q}))
    before = st.info["ground"].clone()
    nxt = env.step(st, torch.zeros(B, 12))
    assert nxt.terminated.tolist() == [True, False, False, False]
    assert not torch.equal(nxt.info["ground"][0], before[0])  # a fresh ground
    assert torch.equal(nxt.info["ground"][1:], before[1:])
    assert nxt.info["push_steps_left"].tolist() == [0, 9, 9, 9]
    assert nxt.info["push_force"][0].eq(0).all() and nxt.sim.t[0] == 0
    h, _ = env._episode_ground(nxt.info).query(nxt.sim.q[:1, :2].expand(B, 2))
    assert abs(float(nxt.sim.q[0, 2] - h[0] - env._q_stand[2])) < 1e-6  # on its new ground


@pytest.mark.parametrize("terrain", ["fourier", "perlin", "stairs", "perlin_grid"])
def test_terrain_env_builds_and_steps(terrain):
    env = _port_env(terrain=terrain)
    want = "kernel" if terrain == "perlin_grid" else "substep"
    assert env.engine.backend == want and env._fused_sensors == (want == "substep")
    st = env.reset(torch.Generator().manual_seed(4), B)
    for _ in range(2):
        st = env.step(st, torch.rand(B, 12, generator=torch.Generator().manual_seed(5)) * 2 - 1)
    assert st.obs.shape == (B, 33) and bool(torch.isfinite(st.obs).all())
    assert bool(torch.isfinite(st.sim.q).all())
    if terrain == "perlin_grid":  # spawned over the map, raised by the grid's height
        assert float(st.sim.q[:, :2].abs().max()) > 0.5


def test_perlin_grid_is_the_reference_grid():
    ref = JANYmalEnv(terrain="perlin_grid", observe="state").engine.ground
    port = _port_env(terrain="perlin_grid", observe="state").engine.ground
    np.testing.assert_array_equal(port.z.numpy(), np.asarray(ref.z))
    assert float(port.dx) == float(ref.dx) and float(port.x0) == float(ref.x0)
    with pytest.raises(ValueError, match="unknown terrain"):
        _port_env(terrain="moon")
