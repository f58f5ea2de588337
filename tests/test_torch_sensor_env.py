"""The sensor-observing ANYmal env step of the port against jiminy_tpu's.

``ANYmalEnv(observe="sensors", sensor_delay=0.004)`` (sensors sampled
every 5 ms, so 4 updates per 20 ms env step and ring buffers of 3 slots
for the delayed IMU and encoders) is built by both packages. The
reference runs on its chunked fallback (``env._fused_sensors = False``,
as tests/test_sensor_kernel.py forces it; its engine is ``"xla"`` on the
CPU); the port runs its fused path (K2's plain version with the sensor
stage) and its own chunked fallback. States are the reference's reset
states plus numpy noise, handed to both through
``env_state_from_arrays``, the reference's ring buffers flattened by its
``flatten_buffers`` into the port's ``info["sensor_bufs"]`` layout; B = 4.

Without noise no random stream needs matching. With ``imu_noise=0.02``
and ``encoder_noise=0.005`` the reference's own draws (its ``sample_eps``
on the keys its step derives) go to the port through the env's eps hook
``_sensor_eps``.

Tolerances: q, v atol 1e-4 (as tests/test_torch_anymal_step.py); the
buffers reading by reading (``ATOL_READING``): the IMU quaternion 1e-4,
readings of intermediate substeps' v and q 2e-4, τ 5e-4, the
accelerometer (a = Δv/dt) and the contact forces (λ/dt) 4e-2; obs atol
1e-4 except the scaled accelerometer (obs[6:9] = 0.05·accel), 2e-3;
reward 1e-4; terminated, truncated and steps exact. The port's fused and chunked
paths run the same plain arithmetic on the CPU, so they are held equal
to the last bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.envs import ANYmalEnv, env_state_from_arrays
from jiminy_tpu_torch.envs.locomotion import WalkerEnv
from jiminy_tpu_torch.hardware import sensors as psensors
from jiminy_tpu_torch.models.quadruped import make_anymal, stand_q
from jiminy_tpu_torch.ops.substep_kernel import (
    SensorKernelSpec,
    substep_batched,
    substep_batched_multi,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
KW = dict(step_dt=0.02, sim_dt=5e-3, pgs_iters=8, sensor_delay=0.004)
NOISE = dict(imu_noise=0.02, encoder_noise=0.005)


class _Ref:
    """The reference env on its fallback path, its jitted steps and a
    template state."""

    def __init__(self, **kw):
        self.env = env = JANYmalEnv(observe="sensors", **KW, **kw)
        assert env.engine._solver_backend == "xla"
        env._fused_sensors = False
        assert env.n_obs_updates == 4 and env.n_substeps_per_obs == 1
        # one compiled program per env (a compile takes ~30 s here): an
        # env that does not finish its episode takes in `step` exactly
        # what `step_no_reset` gives it
        self.step = jax.jit(jax.vmap(env.step))
        self.flat = jax.jit(jax.vmap(env.sensors.flatten_buffers))
        self.template = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), B))

    def eps_of_step(self, state):
        """The corruption the reference's step_no_reset draws, per env:
        sample_eps on the keys its fallback splits from the state's rng."""
        suite, n = self.env.sensors, self.env.n_obs_updates

        def one(rng):
            k_sens = jax.random.split(rng, 4)[3]
            keys = jax.random.split(k_sens, n)
            return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

        return np.asarray(jax.jit(jax.vmap(one))(state.rng))

    def arrays(self, state) -> dict:
        info = {k: np.asarray(self.flat(x) if isinstance(x, tuple) else x)
                for k, x in state.info.items()}
        return {
            "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
            "obs": np.asarray(state.obs),
            "reward": np.asarray(state.reward),
            "terminated": np.asarray(state.terminated),
            "truncated": np.asarray(state.truncated),
            "steps": np.asarray(state.steps),
            "info": info,
        }


@pytest.fixture(scope="module")
def ref():
    return _Ref()


@pytest.fixture(scope="module")
def ref_noisy():
    return _Ref(**NOISE)


def _start(ref, seed, edit=None):
    """The reference's reset states with q, v, λ and steps perturbed by
    numpy noise, and an action."""
    rng = np.random.default_rng(seed)
    t = ref.template
    q = np.array(t.sim.q, np.float64)
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    q[:, 2] += rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    steps = rng.integers(0, 50, B)
    action = rng.uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    if edit is not None:
        q, v, steps = edit(q, v, steps)
    sim = t.sim.replace(q=jnp.asarray(q, jnp.float32), v=jnp.asarray(v, jnp.float32),
                        lam=jnp.asarray(lam, jnp.float32))
    return t.replace(sim=sim, steps=jnp.asarray(steps, jnp.int32)), action


def _port(fused, **kw):
    env = ANYmalEnv(observe="sensors", device="cpu", **KW, **kw)
    assert env._fused_sensors
    env._fused_sensors = fused
    return env


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), ref, atol=atol, rtol=0)


# per reading, from the tolerances of tests/test_torch_anymal_step.py:
# the final q and v are held at 1e-4, and the readings of the earlier
# substeps' states, where two float32 implementations have diverged by
# as much (observed ~1.2e-4 in v), at 2e-4; the readings derived from
# them by what the derivation gives: τ = kp·Δq + kd·Δv 5e-4, the
# accelerometer a = Δv/dt and the contact forces λ/dt 4e-2
ATOL_READING = {
    "imu": [1e-4] * 4 + [2e-4] * 3 + [4e-2] * 3,
    "encoder": [2e-4, 2e-4],
    "effort": [5e-4],
    "contact": [4e-2] * 3,
}


def _close_bufs(env, port_flat, ref_flat):
    """Each group of the flat buffers, every slot, each reading at its
    quantity's tolerance."""
    suite = env.sensors
    for g, p, r in zip(suite.groups, suite.unflatten_buffers(port_flat),
                       suite.unflatten_buffers(torch.as_tensor(ref_flat))):
        bad = (p - r).abs() > torch.tensor(ATOL_READING[g.type])
        assert not bad.any(), (g.type, float((p - r).abs().max()), torch.nonzero(bad)[:5])


def _close_obs(port, ref):
    _close(port[:, :6], ref[:, :6], 1e-4)
    _close(port[:, 6:9], ref[:, 6:9], 2e-3)  # 0.05 · accelerometer
    _close(port[:, 9:], ref[:, 9:], 1e-4)


def _step_no_reset(ref, jst, action):
    """The reference's step_no_reset, through its step on envs that do
    not finish."""
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)))
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    return jnext


def _check_step(env, tnext, jnext, rows=slice(None)):
    sim = jnext["sim"]
    _close(tnext.sim.q[rows], sim["q"][rows], 1e-4)
    _close(tnext.sim.v[rows], sim["v"][rows], 1e-4)
    _close_bufs(env, tnext.info["sensor_bufs"][rows], jnext["info"]["sensor_bufs"][rows])
    _close_obs(tnext.obs[rows], jnext["obs"][rows])
    _close(tnext.reward[rows], jnext["reward"][rows], 1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chunked"])
def test_step_no_reset_matches_reference(ref, fused):
    jst, action = _start(ref, seed=0)
    jnext = _step_no_reset(ref, jst, action)
    env = _port(fused)
    tst = env_state_from_arrays(ref.arrays(jst), torch.Generator().manual_seed(0), device="cpu")
    tnext = env.step_no_reset(tst, torch.as_tensor(action))
    assert np.abs(jnext["sim"]["lam"]).max() > 0.1  # contacts and bounds engaged
    _check_step(env, tnext, jnext)
    np.testing.assert_array_equal(tnext.terminated.numpy(), jnext["terminated"])
    # all 3 slots of the delayed lines were pushed this step
    before = tst.info["sensor_bufs"]
    assert (tnext.info["sensor_bufs"][:, :30] - before[:, :30]).abs().amax(1).min() > 1e-4


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chunked"])
def test_step_no_reset_with_noise_matches_reference(ref_noisy, fused):
    jst, action = _start(ref_noisy, seed=1)
    jnext = _step_no_reset(ref_noisy, jst, action)
    eps = torch.as_tensor(ref_noisy.eps_of_step(jst))
    env = _port(fused, **NOISE)
    assert eps.shape == (B, 4 * env.sensors.n_eps)
    env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: eps
    tst = env_state_from_arrays(ref_noisy.arrays(jst), torch.Generator().manual_seed(1),
                                device="cpu")
    tnext = env.step_no_reset(tst, torch.as_tensor(action))
    _check_step(env, tnext, jnext)


def _force_done(q, v, steps):
    q[0, 2] = 0.2  # env 0: base below min_height → terminated
    q[1, 3:7] = [np.sin(0.6), 0.0, 0.0, np.cos(0.6)]  # env 1: tilted 69° → terminated
    steps[2] = 999  # env 2: hits max_steps → truncated
    return q, v, steps


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chunked"])
def test_auto_reset_matches_reference(ref, fused):
    jst, action = _start(ref, seed=2, edit=_force_done)
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)))
    env = _port(fused)
    tst = env_state_from_arrays(ref.arrays(jst), torch.Generator().manual_seed(2), device="cpu")
    tnext = env.step(tst, torch.as_tensor(action))
    term, trunc = jnext["terminated"], jnext["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3] or trunc[3])
    np.testing.assert_array_equal(tnext.terminated.numpy(), term)
    np.testing.assert_array_equal(tnext.truncated.numpy(), trunc)
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])
    _close(tnext.reward, jnext["reward"], 1e-4)
    # the finished step's observation and buffers, before the reset
    _close_obs(tnext.info["final_obs"], jnext["info"]["final_obs"])
    _close_bufs(env, tnext.info["final_sensor_bufs"], jnext["info"]["final_sensor_bufs"])
    # the env that goes on is the reference's
    _check_step(env, tnext, jnext, rows=slice(3, 4))
    # the finished ones restarted from the port's own draws: buffers
    # filled with the measurement at the fresh state, obs read from them
    done = torch.as_tensor(term | trunc)
    suite = env.sensors
    q, v = tnext.sim.q[done], tnext.sim.v[done]
    fill = suite.flatten_buffers(suite.reset(torch.zeros(3, suite.n_eps), q, v))
    torch.testing.assert_close(tnext.info["sensor_bufs"][done], fill, atol=0, rtol=0)
    assert (tnext.sim.t[done] == 0).all() and (tnext.steps[done] == 0).all()
    torch.testing.assert_close(tnext.obs, env._make_obs(tnext.sim, tnext.info), atol=0, rtol=0)


def test_fused_equals_chunked_with_noise():
    """The port's fused plain path and its chunked fallback on the same
    eps: the same plain arithmetic in the same order, to the last bit;
    two steps, with auto-reset."""
    outs = []
    for fused in (True, False):
        env = _port(fused, **NOISE)
        gen = torch.Generator().manual_seed(5)
        st = env.reset(gen, B)
        for k in range(2):
            st = env.step(st, torch.full((B, 12), 0.3 * (k + 1)))
        outs.append(st)
    a, b = outs
    for x, y in ((a.sim.q, b.sim.q), (a.sim.v, b.sim.v), (a.obs, b.obs),
                 (a.info["sensor_bufs"], b.info["sensor_bufs"])):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_engine_k_obs2_fused_equals_chunked():
    """k_obs = 2 (the Ant schedule: a sensor update every other substep)
    at the engine level: one fused call of 4 substeps with 2 updates
    against 2 engine steps of 2 substeps, each followed by the suite's
    update, on the same eps."""
    tree, motors, suite = make_anymal(device="cpu", sensor_period=1e-2, sensor_delay=0.01,
                                      imu_noise=0.02, encoder_noise=0.005)
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                                     compute_solver_residual=False),
                 motors=motors, controller=PDController(80.0, 2.0), device="cpu")
    assert eng.sensor_fusion_ready(suite, 4, 2) and not eng.sensor_fusion_ready(suite, 3, 2)
    gen = torch.Generator().manual_seed(6)
    q = torch.as_tensor(stand_q(tree)).repeat(B, 1)
    q[:, 7:] += 0.2 * torch.rand(B, 12, generator=gen) - 0.1
    sim = eng.reset(q, 0.2 * torch.randn(B, 18, generator=gen))
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), sim.q, sim.v))
    eps = torch.cat([suite.sample_eps(gen, B) for _ in range(2)], 1)
    u = q[:, 7:] + 0.1
    fused, fbufs = eng.step_with_sensors(sim, u, 4, suite, bufs, eps, k_obs=2)
    tup = suite.unflatten_buffers(bufs)
    for e in eps.split(suite.n_eps, dim=1):
        sim = eng.step(sim, u, n_substeps=2)
        tup = suite.update(tup, e, sim.q, sim.v, sim.a, sim.contact_forces, sim.tau)
    torch.testing.assert_close(fused.q, sim.q, atol=0, rtol=0)
    torch.testing.assert_close(fbufs, suite.flatten_buffers(tup), atol=0, rtol=0)
    assert not torch.equal(fbufs, bufs)


def test_kernel_spec_packs_what_the_readings_need():
    """SensorKernelSpec.packed starts with what the readings need of each
    body: the IMU's body and its ancestors their world rotation, velocity
    and acceleration (3), the contacts' bodies and their ancestors their
    world rotation (1), any other body nothing (0); then one header per
    group and two ints per sensor."""
    tree, _, suite = make_anymal(device="cpu", sensor_period=5e-3)
    gi, _ = SensorKernelSpec(tree, suite, 1).packed("cpu")
    ng = len(suite.groups)
    chains = set()
    for b in tree.contact_body:
        while b >= 0:
            chains.add(b)
            b = tree.parent[b]
    imu = tree.frame_body[tree.frame_index("base_frame")]
    assert imu == 0 and chains == set(range(tree.nb))  # every leg carries a foot
    assert gi[:tree.nb].tolist() == [3] + [1] * (tree.nb - 1)
    heads = gi[tree.nb:tree.nb + 4 * ng].reshape(ng, 4).tolist()
    assert [h[0] for h in heads] == [0, 1, 2, 3]  # imu, encoder, effort, contact
    assert [h[1:3] for h in heads] == [[g.ns, g.buf_len] for g in suite.groups]
    assert gi.numel() == tree.nb + 4 * ng + 2 * sum(g.ns for g in suite.groups)
    encoders = psensors.SensorSuite.build(
        tree, [psensors.encoder_spec(n) for n in tree.joint_name[1:]], 5e-3)
    gi, _ = SensorKernelSpec(tree, encoders, 1).packed("cpu")
    assert gi[:tree.nb].tolist() == [0] * tree.nb


def test_force_sensor_takes_the_chunked_path():
    """A suite with a force sensor is outside the kernel's sensor stage:
    the env says so through _fused_sensors and steps on the chunked
    path, as the reference does."""
    tree, motors, suite = make_anymal(device="cpu", sensor_period=5e-3)
    specs = [psensors.imu_spec("base_frame"), psensors.force_spec("LF_FOOT")]
    specs += [psensors.encoder_spec(n) for n in tree.joint_name[1:]]
    forced = psensors.SensorSuite.build(tree, specs, 5e-3)
    env = WalkerEnv(tree, motors, stand_q(tree), step_dt=0.02, sim_dt=5e-3,
                    sensors=forced, device="cpu")
    assert env.engine.backend == "substep" and not env._fused_sensors
    with pytest.raises(ValueError, match="force"):
        SensorKernelSpec(env.tree, forced, 1)
    def launches():
        return (substep_batched.launches, substep_batched_multi.launches,
                substep_batched_multi.sensor_launches)

    before = launches()
    st = env.reset(torch.Generator().manual_seed(0), B)
    st = env.step(st, torch.zeros(B, 12))
    assert st.obs.shape == (B, 33) and bool(torch.isfinite(st.obs).all())
    assert launches() == before


def test_default_observes_through_sensors():
    env = ANYmalEnv(device="cpu")
    assert env.observe_mode == "sensors" and env._fused_sensors
    st = env.reset(torch.Generator().manual_seed(0), 2)
    assert st.obs.shape == (2, 33) and st.info["sensor_bufs"].shape == (2, env.sensors.n_buf)
    assert ANYmalEnv(observe="state", device="cpu").sensors is None


def test_sensor_period_must_divide_the_step():
    """The step must hold a whole number of sensor periods, each a whole
    number of substeps (the reference's validation)."""
    tree, motors, _ = make_anymal(device="cpu")
    odd = make_anymal(device="cpu", sensor_period=1.5e-2)[2]
    with pytest.raises(ValueError, match="multiple"):
        WalkerEnv(tree, motors, stand_q(tree), step_dt=0.02, sim_dt=5e-3, sensors=odd,
                  device="cpu")
