"""The slice as a whole: one ANYmal env step of the port against
jiminy_tpu's.

States are the stand pose plus numpy noise, handed to both the JAX
``ANYmalEnv(observe="state")`` (whose engine runs
``constraint_solver="xla"`` on the CPU) and the port at B = 8, through
``env_state_from_arrays``. One env step (4 substeps of 5 ms, 8 PGS
sweeps). Tolerances: q, v, λ and τ atol 1e-4; contact forces 2e-2 N and
the acceleration a 2e-2 (the λ and v tolerances ÷ dt); obs and reward
1e-4; terminated and truncated exact.
All three of the port's backends run: ``"substep"`` (the env's default,
the whole-substep kernels; on the CPU their plain versions), ``"kernel"``
(the chain kernel; on the CPU its plain version) and ``"inline"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.envs import ANYmalEnv, env_state_from_arrays
from jiminy_tpu_torch.ops import solve_batched
from jiminy_tpu_torch.ops.substep_kernel import substep_batched, substep_batched_multi

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")


def _to_arrays(state) -> dict:
    return {
        "sim": {k: np.asarray(getattr(state.sim, k)) for k in SIM_FIELDS},
        "obs": np.asarray(state.obs),
        "reward": np.asarray(state.reward),
        "terminated": np.asarray(state.terminated),
        "truncated": np.asarray(state.truncated),
        "steps": np.asarray(state.steps),
        "info": {k: np.asarray(v) for k, v in state.info.items()},
    }


@pytest.fixture(scope="module")
def jax_env():
    env = JANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8)
    assert env.engine._solver_backend == "xla"
    template = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), B))
    return env, jax.jit(jax.vmap(env.step)), template


def _start_state(env, template, seed, edit=None):
    """JAX EnvState at the stand pose plus numpy noise (q, v, λ, steps)."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(j_stand_q(env.tree)), (B, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    q[:, 2] += rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    steps = rng.integers(0, 50, B)
    action = rng.uniform(-1.2, 1.2, (B, 12))
    if edit is not None:
        q, v, steps = edit(q, v, steps)
    sim = template.sim.replace(
        q=jnp.asarray(q, jnp.float32), v=jnp.asarray(v, jnp.float32),
        lam=jnp.asarray(lam, jnp.float32),
    )
    st = template.replace(sim=sim, steps=jnp.asarray(steps, jnp.int32))
    return st, action.astype(np.float32)


def _run_both(jax_env, solver, seed, edit=None):
    env, jstep, template = jax_env
    jst, action = _start_state(env, template, seed, edit)
    jnext = _to_arrays(jstep(jst, jnp.asarray(action)))
    port = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8,
                     constraint_solver=solver, device="cpu")
    tst = env_state_from_arrays(_to_arrays(jst), torch.Generator().manual_seed(seed), device="cpu")
    tnext = port.step(tst, torch.as_tensor(action))
    return port, tst, tnext, jnext


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("solver", ["substep", "kernel", "inline"])
def test_env_step_matches_reference(jax_env, solver):
    _, _, tnext, jnext = _run_both(jax_env, solver, seed=0)
    sim = jnext["sim"]
    assert np.abs(sim["lam"]).max() > 0.1  # contacts and bounds engaged
    _close(tnext.sim.q, sim["q"], 1e-4)
    _close(tnext.sim.v, sim["v"], 1e-4)
    _close(tnext.sim.lam, sim["lam"], 1e-4)
    _close(tnext.sim.contact_forces, sim["contact_forces"], 2e-2)
    _close(tnext.sim.a, sim["a"], 2e-2)  # (v⁺ − v)/dt: the v tolerance ÷ dt
    _close(tnext.sim.tau, sim["tau"], 1e-4)
    _close(tnext.sim.t, sim["t"], 1e-6)
    _close(tnext.obs, jnext["obs"], 1e-4)
    _close(tnext.reward, jnext["reward"], 1e-4)
    np.testing.assert_array_equal(tnext.terminated.numpy(), jnext["terminated"])
    np.testing.assert_array_equal(tnext.truncated.numpy(), jnext["truncated"])
    np.testing.assert_array_equal(tnext.steps.numpy(), jnext["steps"])
    _close(tnext.info["final_obs"], jnext["info"]["final_obs"], 1e-4)


def test_env_step_on_cpu_launches_no_kernel(jax_env):
    def counts():
        return (solve_batched.launches, substep_batched.launches,
                substep_batched_multi.launches)

    before = counts()
    _run_both(jax_env, "kernel", seed=1)
    _run_both(jax_env, "substep", seed=1)
    assert counts() == before


def _force_done(q, v, steps):
    q[0, 2] = 0.2  # env 0: base below min_height → terminated
    q[1, 3:7] = [np.sin(0.6), 0.0, 0.0, np.cos(0.6)]  # env 1: tilted 69° → terminated
    steps[2] = 999  # env 2: hits max_steps → truncated
    return q, v, steps


@pytest.mark.parametrize("solver", ["substep", "kernel", "inline"])
def test_auto_reset_matches_reference(jax_env, solver):
    port, tst, tnext, jnext = _run_both(jax_env, solver, seed=2, edit=_force_done)
    term, trunc = jnext["terminated"], jnext["truncated"]
    assert term[0] and term[1] and trunc[2] and not (term[3:] | trunc[3:]).any()
    np.testing.assert_array_equal(tnext.terminated.numpy(), term)
    np.testing.assert_array_equal(tnext.truncated.numpy(), trunc)
    _close(tnext.reward, jnext["reward"], 1e-4)
    # final_obs is the terminal observation of the finished step
    _close(tnext.info["final_obs"], jnext["info"]["final_obs"], 1e-4)
    done = term | trunc
    # the finished envs restarted: step 0, t 0, fresh stand-pose states
    assert (tnext.steps.numpy()[done] == 0).all() and (jnext["steps"][done] == 0).all()
    assert (tnext.sim.t.numpy()[done] == 0).all()
    assert not tnext.sim.lam[torch.as_tensor(done)].any()
    stand = torch.as_tensor(j_stand_q(port.tree))
    dq = (tnext.sim.q[torch.as_tensor(done)] - stand).abs()
    assert dq.max() <= port.reset_noise + 1e-6
    assert dq[:, :7].max() == 0  # base pose exactly the stand pose
    np.testing.assert_allclose(
        tnext.obs.numpy()[done], port._observe(tnext.sim).numpy()[done], atol=0
    )
    # the others continued, as in the reference
    keep = ~done
    _close(tnext.sim.q[torch.as_tensor(keep)], jnext["sim"]["q"][keep], 1e-4)
    _close(tnext.sim.v[torch.as_tensor(keep)], jnext["sim"]["v"][keep], 1e-4)
    _close(tnext.obs[torch.as_tensor(keep)], jnext["obs"][keep], 1e-4)


def test_reset_is_seeded():
    env = ANYmalEnv(observe="state", device="cpu")
    a = env.reset(torch.Generator().manual_seed(7), 4)
    b = env.reset(torch.Generator().manual_seed(7), 4)
    torch.testing.assert_close(a.sim.q, b.sim.q, atol=0, rtol=0)
    torch.testing.assert_close(a.obs, b.obs, atol=0, rtol=0)
    assert a.obs.shape == (4, 33) and not a.done.any()


@pytest.mark.parametrize(
    "kwargs, item",
    [
        ({"constraints": (object(),)}, "not a kinematic constraint"),
        ({"reward_fn": object()}, "A.17"),
        ({"termination_fn": object()}, "A.17"),
    ],
)
def test_unported_options_raise(kwargs, item):
    """Options still to port raise NotImplementedError naming their
    ROADMAP item; a constraint that is none of the kinematic constraints
    TypeError (every kind is ported, and reaches the engine:
    ``test_constraints_pass_through``)."""
    err = TypeError if "constraints" in kwargs else NotImplementedError
    with pytest.raises(err, match=item):
        ANYmalEnv(device="cpu", **kwargs)


def test_engine_options_replace_the_env_s():
    """``engine_options`` replaces the env's own options as a whole, as in
    the reference: its dt sets the substeps per step, and with the
    reference's default contact model the env runs the continuous path
    (penalty contacts and bounds, no solve)."""
    from jiminy_tpu_torch.engine import EngineOptions

    opts = EngineOptions(dt=1e-3, compute_solver_residual=False)
    env = ANYmalEnv(observe="state", engine_options=opts, device="cpu")
    eng = env.engine
    assert eng.options is opts and env.n_substeps == 20
    assert eng.backend == "inline" and not eng.impulse and eng.nc == 0
    assert eng.substep_spec.bounds_mode == "penalty" and eng.contact_m_eff.shape == (4,)
    st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.zeros(2, 12))
    assert bool(torch.isfinite(st.sim.q).all()) and st.sim.lam.shape == (2, 0)
    assert 0.45 < float(st.sim.q[:, 2].min()) and float(st.sim.q[:, 2].max()) < 0.6


def test_constraints_pass_through():
    """A frame constraint reaches the engine: its six rows ahead of the
    bounds and contacts, ``"auto"`` on the chain kernel, the state's λ as
    wide as the engine's rows."""
    from jiminy_tpu_torch.engine.constraints import FrameConstraint

    env = ANYmalEnv(observe="state", device="cpu", constraints=(FrameConstraint(0),))
    assert env.engine.constraints == (FrameConstraint(0),)
    assert env.engine.backend == "kernel" and env.engine.nc == 30
    st = env.reset(torch.Generator().manual_seed(0), 2)
    assert st.sim.lam.shape == (2, 30)


def test_collision_pairs_pass_through():
    """``collision_pairs`` (ported, ROADMAP A.13) reach the engine: a pair
    of foot spheres adds its contact rows after the ground's."""
    from jiminy_tpu_torch.engine.collision import CollisionPair, Sphere

    pair = CollisionPair(Sphere("LF_SHANK", (0, 0, -0.2), 0.05),
                         Sphere("RF_SHANK", (0, 0, -0.2), 0.05))
    env = ANYmalEnv(observe="state", collision_pairs=(pair,), device="cpu")
    assert env.engine.collision_pairs == (pair,) and env.engine.nc == 24 + 3
    assert env.engine.backend == "substep"
    st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.zeros(2, 12))
    assert bool(torch.isfinite(st.obs).all())


def test_env_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ANYmalEnv()  # default device: cuda
