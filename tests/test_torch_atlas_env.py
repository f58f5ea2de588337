"""The port's Atlas env against jiminy_tpu's, and a trained Atlas policy on
the port.

``AtlasEnv`` at its defaults (20 ms env steps of 5 substeps of 4 ms, PD
kp 300, kd 15) is built by both packages, with and without its
self-collision pairs, on the state path and on the sensor path with
``atlas_sensors_run``'s sensing (4 ms delay, IMU noise 0.02, encoder
noise 0.005; 5 sensor updates per env step). As the Cassie env tests, the
comparison runs in float64: the reference with x64 on and its model
(tree, motors) copied to float64 in a fresh engine with the pairs
(ROADMAP C.3), the port with ``dtype=float64``; every field within 1e-9
(contact forces and a within 1e-9/dt).

Two reference programs serve every case (tests/test_torch_atlas.py
compiles none): the reference's sensor env with
its pairs built with ``reset_noise=0``, its reset and its
``step_no_reset`` on its chunked path (five engine steps of one substep,
each followed by the suite's update), vmapped and jitted once. The state
path's physics, reward and flags are the same function's; its
observation is the reference's privileged ``_observe`` of the
reference's state (run eagerly). The sensor noise of a step reaches the
port through the env's eps hook ``_sensor_eps``.

- Reset: the port's reset at ``reset_noise=0`` gives the reference's
  states (the stand pose at rest), and on the state path its observation.
- One step from the reference's reset states with the motor joints ±0.05
  rad and v + 0.3·N(0, 1), B = 4: with the pairs, the legs rolled inward
  and the arms brought to the torso (a pair row active in half the envs
  at least); without them, the arms out, no pair row active, so that the
  reference's step with its pairs is the port's without them (its pair
  impulses zero). Paths: state, and sensors fused (K2's plain version with
  the sensor stage) and chunked.
- One step with forced terminations and a truncation: the finished step's
  flags, reward and final observation within 1e-9, and the env that goes
  on as before.
- The engine on every backend (``"substep"``, ``"kernel"``, ``"inline"``;
  on the CPU the first two run the plain versions of their kernels):
  ``Engine.step`` over the env step's 5 substeps from the same states and
  commands against the reference env's engine (``constraint_solver=
  "xla"``, the reference's substep) on the same program, with the pairs
  (from the legs-together states) and without them (the arms-out states,
  where the reference's pair impulses are zero): q, v, λ and the residual
  within 1e-9, contact forces and a within 1e-9/dt. A separate program of
  one reference substep would double this file's compile time; the env
  step's five substeps in a row hold the same rows, with λ carried.
- A.23's policy check: the reference's trained Atlas policy with its
  self-collision pairs (``artifacts/atlas_selfcol_run5``, the newest
  checkpoint, restored with the reference's ``restore_raw``; state
  observations, which the port's env reproduces), converted with
  ``policy_params_from_arrays``: its actor gives the reference's
  ``mlp_apply`` on the port env's observations (float32, 1e-5), and
  through ``tools/evaluate.py --env atlas --self-collision`` on the CPU,
  greedy, 32 envs for 50 steps, no env falls and the forward speed is
  within ±25 % of the 0.30 m/s that its ``eval.json`` implies (2.98 m over
  495.9 steps of 20 ms). Statistics, not trajectories: float32 rollouts
  part ways between backends (ROADMAP C.2).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.envs.legged import AtlasEnv as JAtlasEnv
from jiminy_tpu.rl.networks import mlp_apply as j_mlp_apply
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS
from jiminy_tpu_torch.engine.collision import pair_rows
from jiminy_tpu_torch.envs import AtlasEnv, env_state_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 4
ATOL = 1e-9
SENSORS = dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                "friction_viscous", "friction_vel_eps")
SOLVERS = ("substep", "kernel", "inline")


class _Ref:
    """The reference's sensor env with its pairs in float64 (x64 on while
    it is built, reset and stepped), on its chunked sensor path: its jitted
    reset states and ``step_no_reset``."""

    def __init__(self):
        self.env = env = JAtlasEnv(self_collision=True, reset_noise=0.0, **SENSORS)
        tree, motors = env.engine.tree, env.robot.motors
        tree = tree.replace(**{k: jnp.asarray(np.asarray(getattr(tree, k)), jnp.float64)
                               for k in ARRAY_FIELDS})
        motors = motors.replace(**{k: jnp.asarray(np.asarray(getattr(motors, k)), jnp.float64)
                                   for k in MOTOR_PARAMS})
        e = env.engine
        env.engine = JEngine(tree, e.options, ground=e.ground, motors=motors,
                             controller=e.controller, collision_pairs=e.collision_pairs)
        env.tree, env.robot.motors = tree, motors
        env._fused_sensors = False
        assert env.engine._solver_backend == "xla" and env.n_substeps == 5
        self.step = jax.jit(jax.vmap(env.step_no_reset))
        self.template = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), B))

    def observe(self, sim) -> np.ndarray:
        """The privileged observation of ``sim`` (eager)."""
        return np.asarray(jax.vmap(lambda s: self.env._observe(s, None))(sim))

    def eps_of_step(self, state) -> np.ndarray:
        """The corruption the reference's fallback draws in a step, per
        env: sample_eps on the keys it splits from the state's rng."""
        suite, n = self.env.sensors, self.env.n_obs_updates

        def one(rng):
            keys = jax.random.split(jax.random.split(rng, 4)[3], n)
            return jnp.concatenate([suite.sample_eps(keys[u]) for u in range(n)])

        return np.asarray(jax.vmap(one)(state.rng))

    def arrays(self, state, observe) -> dict:
        flat = jax.vmap(self.env.sensors.flatten_buffers)
        info = {k: np.asarray(flat(x) if isinstance(x, tuple) else x)
                for k, x in state.info.items()}
        out = {
            "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
            **{k: np.asarray(getattr(state, k))
               for k in ("obs", "reward", "terminated", "truncated", "steps")},
            "info": info,
        }
        if observe == "state":
            out["obs"] = self.observe(state.sim)
            out["info"] = {}
        return out


@pytest.fixture(scope="module")
def ref():
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield _Ref()
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.config.update("jax_disable_most_optimizations", False)


def _port(observe, pairs, fused=True, **kw):
    env = AtlasEnv(device="cpu", dtype=torch.float64, self_collision=pairs,
                   **(SENSORS if observe == "sensors" else {"observe": "state"}), **kw)
    assert env.engine.backend == "substep" and env.engine.nc == (83 if pairs else 47)
    assert env._fused_sensors == (observe == "sensors")
    env._fused_sensors = fused
    return env


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("observe", ["state", "sensors"])
def test_reset_matches_reference(ref, observe):
    jax.config.update("jax_enable_x64", True)
    env = _port(observe, pairs=True, reset_noise=0.0)
    tst = env.reset(torch.Generator().manual_seed(0), B)
    want = ref.arrays(ref.template, "state")
    for k in ("t", "q", "v", "lam"):
        _close(getattr(tst.sim, k), want["sim"][k])
    np.testing.assert_array_equal(tst.steps.numpy(), want["steps"])
    assert not (tst.terminated | tst.truncated).any()
    assert tst.obs.shape == (B, 55) and bool(torch.isfinite(tst.obs).all())
    if observe == "state":
        _close(tst.obs, want["obs"])
    else:
        assert tst.info["sensor_bufs"].shape == ref.arrays(ref.template, "sensors")[
            "info"]["sensor_bufs"].shape


def _start(ref, env, seed, pairs, done=False):
    """The reference's reset states in float64 with the motor joints ±0.05
    rad and v + 0.3·N(0, 1); with ``pairs`` the hip and shoulder rolls
    turned inward, else the shoulders out; and an action. With ``done``
    env 0 below the minimum height, env 1 tilted past the limit and env 2
    at the step limit."""
    rng = np.random.default_rng(seed)
    t, tree = ref.template, env.tree
    sim = {k: np.array(getattr(t.sim, k), np.float64) for k in SIM_FIELDS}
    q = sim["q"]
    q[:, list(env.motors.q_idx)] += rng.uniform(-0.05, 0.05, (B, 23))
    qi = {n: tree.q_off[tree.joint_index(n)] for n in tree.joint_name[1:]}
    if pairs:
        q[:, qi["l_leg_hpx"]] = -rng.uniform(0.05, 0.3, B)
        q[:, qi["r_leg_hpx"]] = rng.uniform(0.05, 0.3, B)
        q[:, qi["l_arm_shx"]] = -rng.uniform(0.2, 0.5, B)
        q[:, qi["r_arm_shx"]] = rng.uniform(0.2, 0.5, B)
    else:
        q[:, qi["l_arm_shx"]] = 0.4
        q[:, qi["r_arm_shx"]] = -0.4
    sim["v"] += 0.3 * rng.standard_normal(sim["v"].shape)
    steps = rng.integers(0, 50, B)
    if done:
        q[0, 2] = 0.3
        q[1, 3:7] = [np.sin(0.6), 0.0, 0.0, np.cos(0.6)]
        steps[2] = 999
    state = t.replace(sim=t.sim.replace(**{k: jnp.asarray(x) for k, x in sim.items()}),
                      obs=jnp.asarray(t.obs, jnp.float64), steps=jnp.asarray(steps, jnp.int32))
    return state, rng.uniform(-1.2, 1.2, (B, 23))


def _pair_share(env, q) -> float:
    """Share of envs with a pair row active (depth > −margin) at q."""
    spec, o = env.engine.substep_spec, env.engine.options
    xw = algos.forward_kinematics(spec.tree, q)
    act = pair_rows(spec.pairs, spec.tree, xw, spec.dt, spec.alpha_c_over_dt, o.contact_margin,
                    o.contact_slop, o.contact_max_correction_vel)[2]
    return float((act > 0).any(dim=1).double().mean())


def _step(ref, observe, pairs, fused, seed, done):
    """The reference's step without reset and the port's step from the
    same state → (port state after, reference arrays after)."""
    jax.config.update("jax_enable_x64", True)
    env = _port(observe, pairs, fused)
    jst, action = _start(ref, env, seed, pairs, done)
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)), observe)
    start = ref.arrays(jst, observe)
    if observe == "sensors":
        eps = torch.as_tensor(ref.eps_of_step(jst))
        n_eps = env.sensors.n_eps
        assert n_eps == 9 + 3 * 23 and eps.shape == (B, 5 * n_eps)
        # a step asks for its 5 updates; the auto-reset's fill for one
        env._sensor_eps = lambda generator, batch_size, n_updates, bias_extra: \
            eps[:, :n_updates * n_eps]
    if not pairs:  # the port's rows end before the pairs'
        start["sim"]["lam"] = start["sim"]["lam"][:, :47]
        assert not jnext["sim"]["lam"][:, 47:].any()
        jnext["sim"]["lam"] = jnext["sim"]["lam"][:, :47]
    tst = env_state_from_arrays(start, torch.Generator().manual_seed(seed), device="cpu",
                                dtype=torch.float64)
    if pairs:
        assert _pair_share(env, tst.sim.q) >= 0.5
    return env.step(tst, torch.as_tensor(action)), jnext


def _check_sim(tnext, jnext, rows=slice(None)):
    for k in SIM_FIELDS:
        tol = ATOL / 4e-3 if k in ("contact_forces", "a") else ATOL
        _close(getattr(tnext.sim, k)[rows], jnext["sim"][k][rows], tol)
    _close(tnext.obs[rows], jnext["obs"][rows])
    _close(tnext.reward[rows], jnext["reward"][rows])
    if "sensor_bufs" in jnext["info"]:
        _close(tnext.info["sensor_bufs"][rows], jnext["info"]["sensor_bufs"][rows])


# (observe, pairs, fused): the state and the sensor paths, with and without the pairs
PATHS = [("state", True, True), ("state", False, True), ("sensors", True, True),
         ("sensors", True, False), ("sensors", False, True)]


@pytest.mark.parametrize("observe, pairs, fused", PATHS,
                         ids=["state-pairs", "state", "sensors-pairs-fused",
                              "sensors-pairs-chunked", "sensors-fused"])
def test_step_matches_reference(ref, observe, pairs, fused):
    tnext, jnext = _step(ref, observe, pairs, fused, seed=0, done=False)
    assert not (jnext["terminated"] | jnext["truncated"]).any()
    _check_sim(tnext, jnext)
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])


@pytest.mark.parametrize("observe", ["state", "sensors"])
def test_auto_reset_matches_reference(ref, observe):
    tnext, jnext = _step(ref, observe, pairs=True, fused=True, seed=1, done=True)
    term, trunc = jnext["terminated"], jnext["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3] or trunc[3])
    np.testing.assert_array_equal(tnext.terminated.numpy(), term)
    np.testing.assert_array_equal(tnext.truncated.numpy(), trunc)
    np.testing.assert_array_equal(tnext.steps.numpy(), np.where(term | trunc, 0, jnext["steps"]))
    _close(tnext.reward, jnext["reward"])
    _close(tnext.info["final_obs"], jnext["obs"])  # the reference's step keeps these
    if observe == "sensors":
        _close(tnext.info["final_sensor_bufs"], jnext["info"]["sensor_bufs"])
    _check_sim(tnext, jnext, rows=slice(3, 4))  # the env that goes on


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "apart"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_engine_step_matches_reference(ref, solver, pairs):
    jax.config.update("jax_enable_x64", True)
    env = AtlasEnv(device="cpu", dtype=torch.float64, observe="state", self_collision=pairs,
                   constraint_solver=solver)
    eng, nc = env.engine, (83 if pairs else 47)
    assert eng.backend == solver and eng.nc == nc
    jst, action = _start(ref, env, 2, pairs)
    jnext = ref.arrays(ref.step(jst, jnp.asarray(action)), "state")["sim"]
    start = ref.arrays(jst, "state")["sim"]
    sim = eng.reset(torch.as_tensor(start["q"]), torch.as_tensor(start["v"]))
    sim.t, sim.lam = torch.as_tensor(start["t"]), torch.as_tensor(start["lam"][:, :nc])
    if pairs:
        assert _pair_share(env, sim.q) >= 0.5
        assert np.abs(jnext["lam"][:, 47:]).max() > 1e-3  # the pairs push
    else:
        assert not jnext["lam"][:, 47:].any()  # no pair impulse where they stand apart
    u = env._action_to_command(torch.as_tensor(action), sim)
    out = eng.step(sim, u, n_substeps=env.n_substeps)
    for k in SIM_FIELDS:  # within 1e-9 of each field's scale (λ reaches ~4e3 here)
        want = jnext[k][:, :nc] if k == "lam" else jnext[k]
        scale = max(1.0, float(np.abs(want).max()))
        _close(getattr(out, k), want,
               scale * (ATOL / 4e-3 if k in ("contact_forces", "a") else ATOL))


def test_trained_atlas_policy_walks(tmp_path, monkeypatch, capsys):
    from jiminy_tpu.checkpoint import restore_raw as j_restore_raw
    from jiminy_tpu_torch.checkpoint import CheckpointManager
    from jiminy_tpu_torch.rl import MLPPolicy, policy_params_from_arrays
    from jiminy_tpu_torch.tools import evaluate as tool_evaluate

    run = REPO / "artifacts" / "atlas_selfcol_run5"
    raw = j_restore_raw(run / "ckpt")
    arrays = raw[0] if isinstance(raw, (list, tuple)) else raw["0"]
    params = policy_params_from_arrays(arrays)
    assert [W.shape for W, _ in params["actor"]] == [(55, 256), (256, 256), (256, 23)]
    env = AtlasEnv(observe="state", self_collision=True, device="cpu")
    obs = env.reset(torch.Generator().manual_seed(5), 8).obs
    want = j_mlp_apply(jax.tree_util.tree_map(jnp.asarray, arrays["actor"]),
                       jnp.asarray(obs.numpy()))
    pol = MLPPolicy(env.observation_size, env.action_size, hidden=(256, 256))
    torch.testing.assert_close(pol.action_dist(params, obs)[0],
                               torch.as_tensor(np.asarray(want)), rtol=1e-5, atol=1e-5)

    CheckpointManager(tmp_path / "ckpt").save(4000, (params,))
    n_steps = 50
    monkeypatch.setattr(sys, "argv", [
        "evaluate", "--env", "atlas", "--self-collision", "--run", str(tmp_path),
        "--n-envs", "32", "--n-steps", str(n_steps), "--seed", "0", "--device", "cpu",
        "--out", str(tmp_path / "stats.json")])
    tool_evaluate.main()
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert json.loads(capsys.readouterr().out) == stats
    assert stats["fall_fraction"] == 0.0 and stats["alive_at_end"] == 1.0
    assert stats["length_mean"] == n_steps
    trained = json.loads((run / "eval.json").read_text())
    implied = trained["forward_displacement_mean"] / (trained["length_mean"] * 0.02)
    speed = stats["forward_displacement_mean"] / (n_steps * 0.02)
    assert abs(speed / implied - 1.0) <= 0.25, (speed, implied, stats)
