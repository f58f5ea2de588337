"""The port's randomized substep against jiminy_tpu's, per-env model
parameters on flat ground and on per-env Fourier grounds.

ANYmal, B = 4. Each env's ``ModelParams`` is made with numpy from a seed
at the slice's ranges widened to the armature and the friction (mass and
inertia 0.8–1.2, centre-of-mass offsets ±0.02 m, armature 0.7–1.3, motor
gain 0.9–1.1, friction 0.5–2.0; tests/test_substep_multi.py's draw) and
handed to both packages, with the inputs of
tests/test_torch_ground_substep.py (perturbed stand poses, velocities,
warm starts, PD targets, a root wrench; on the Fourier ground the bases
spread over ±2 m and raised by the height under the feet, one numpy-made
16-term ground per env).

The reference engine (``constraint_solver="xla"``, which applies the
parameters with ``apply_to_tree`` / ``apply_to_motors``) steps each env
over a whole env step (4 substeps) in float64 (jax x64 on), its model's
float32 constants cast to float64 so that the perturbed inertials (which
``apply_to_tree`` computes in the tree's dtype) are float64 too. Against
it:

- the port in float64 on every backend: ``"substep"`` fused
  (``substep_multi_reference`` with the packed row ``mp``: τ scaled by
  the motor tail as the kernel's `_compute_tau`), ``"substep"`` unfused
  (``substep_reference`` with ``mp``, τ from the motors scaled by the
  motor tail),
  ``"kernel"`` and ``"inline"``: tests/test_torch_ground_substep.py's
  float64 tolerances (q 4e-9; v, λ, residual 4e-7; contact forces and a
  4e-7/dt; τ 2e-6);
- the port in float32, fused and unfused: the tolerances of the
  reference's own randomized tests (tests/test_substep_kernel.py:307,
  tests/test_substep_multi.py:94: q 2e-4, v 2e-2).
- Identical states with different parameters step differently (v apart
  by more than 1e-3, the reference's check), and the nominal parameters
  give the unrandomized step to 1e-12 in float64.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine import ground as jg
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.engine.randomization import ModelParams as JModelParams
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.contact import contact_points_world
from jiminy_tpu_torch.engine.randomization import ModelParams
from jiminy_tpu_torch.hardware.motors import motors_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
DT = 5e-3
KP, KD = 80.0, 2.0
K = 16
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
ATOL64 = {"t": 1e-12, "tau": 2e-6, "q": 4e-9, "v": 4e-7, "lam": 4e-7, "solver_residual": 4e-7,
          "contact_forces": 4e-7 / DT, "a": 4e-7 / DT}


@pytest.fixture(scope="module")
def robot():
    jrobot = j_make_anymal()
    tree = tree_from_arrays(
        {k: np.asarray(getattr(jrobot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS},
        device="cpu",
    )
    motors = motors_from_arrays(
        {k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS}, device="cpu"
    )
    return jrobot, tree, motors


def _params(tree, nm, seed) -> dict:
    rng = np.random.default_rng(seed)

    def u(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32).astype(np.float64)

    return {
        "mass_scale": u((B, tree.nb), 0.8, 1.2), "com_offset": u((B, tree.nb, 3), -0.02, 0.02),
        "inertia_scale": u((B, tree.nb), 0.8, 1.2), "armature_scale": u((B, tree.nv), 0.7, 1.3),
        "motor_gain": u((B, nm), 0.9, 1.1), "motor_friction_scale": u((B, nm), 0.5, 2.0),
    }


def _fourier(seed):
    rng = np.random.default_rng(seed)
    octave = np.arange(K) % 3
    amp = 0.5**octave / np.sqrt(np.bincount(octave)[octave])
    amp *= 0.08 / np.sqrt(np.sum(0.25 ** np.arange(3)))
    theta = rng.uniform(0, 2 * np.pi, (B, K))
    mag = 2 * np.pi / 1.5 * 2.0**octave * rng.uniform(0.75, 1.25, (B, K))
    return np.concatenate([np.tile(amp, (B, 1)), mag * np.cos(theta), mag * np.sin(theta),
                           rng.uniform(0, 2 * np.pi, (B, K))], 1)


def _inputs(jrobot, tree, gc, seed, same=False):
    """Perturbed stand poses (on the terrain when ``gc``), the base
    raised by the mean height under its feet and dropped 1 cm so that the
    feet load; ``same``: every env the state of env 0."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (B, 1)).astype(np.float64)
    if gc is not None:
        q[:, 0:2] = rng.uniform(-2.0, 2.0, (B, 2))
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    if gc is not None:
        t64 = tree.to(dtype=torch.float64)
        qt = torch.as_tensor(q)
        xw, vel = algos.kinematics(t64, qt, torch.zeros(B, t64.nv, dtype=torch.float64))
        feet = contact_points_world(t64, xw, vel)[0]
        q[:, 2] += pg.FourierGround(torch.as_tensor(gc)).query(feet[..., :2])[0].mean(1).numpy()
    q[:, 2] += rng.uniform(-0.02, 0.0, B)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    u = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    arrays = [q, v, lam, u, wrench]
    return [np.repeat(a[:1], B, 0) for a in arrays] if same else arrays


def _f64(tree):
    """The reference's model with its float arrays in float64."""
    return jax.tree.map(
        lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _jax_step(jrobot, gc, params, arrays, dtype=jnp.float64):
    q, v, lam, u, wrench = (jnp.asarray(a, dtype) for a in arrays)
    mps = JModelParams(**{k: jnp.asarray(x, dtype) for k, x in params.items()})
    grounds = None
    if gc is not None:
        g = jnp.asarray(gc, dtype)
        grounds = jg.FourierGround(*(g[:, i * K:(i + 1) * K] for i in range(4)))
    eng = JEngine(
        _f64(jrobot.tree),
        JEngineOptions(contact_model="constraint", constraint_solver="xla", dt=DT,
                       pgs_iters=8, compute_solver_residual=True),
        ground=jax.tree.map(lambda x: x[0], grounds) if grounds is not None else None,
        motors=_f64(jrobot.motors),
        controller=JPDController(KP, KD),
    )
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    if grounds is None:
        step = jax.jit(jax.vmap(lambda s, uu, w, p: eng.step(
            s, uu, n_substeps=4, base_wrench=w, model_params=p)))
        out = step(states, u, wrench, mps)
    else:
        step = jax.jit(jax.vmap(lambda s, uu, w, g, p: eng.step(
            s, uu, n_substeps=4, base_wrench=w, ground=g, model_params=p)))
        out = step(states, u, wrench, grounds, mps)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _port_engine(tree, motors, gc, solver, dtype, fusion=True):
    opts = EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8,
                         compute_solver_residual=True,
                         constraint_solver=solver, substep_fusion=fusion)
    ground = pg.FourierGround(torch.as_tensor(gc[0], dtype=dtype)) if gc is not None else None
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(KP, KD), ground=ground, device="cpu")


def _port_step(engine, gc, params, arrays, dtype):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    state = engine.reset(q, v)
    state.lam = lam
    mp = None if params is None else engine._pack_model_params(ModelParams(
        *(torch.as_tensor(params[k], dtype=dtype) for k in ModelParams.FIELDS)))
    ground = pg.FourierGround(torch.as_tensor(gc, dtype=dtype)) if gc is not None else None
    out = engine.step(state, u, n_substeps=4, base_wrench=wrench, ground=ground, model_params=mp)
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


@pytest.mark.parametrize("terrain", ["flat", "fourier"])
def test_randomized_step_matches_reference(robot, terrain):
    jrobot, tree, motors = robot
    gc = _fourier(1) if terrain == "fourier" else None
    params = _params(tree, motors.nm, seed=5)
    arrays = _inputs(jrobot, tree, gc, seed=0)
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    ref = _jax_step(jrobot, gc, params, arrays)
    assert ref["q"].dtype == np.float64
    assert np.abs(ref["lam"][:, 12:]).max() > 0.05  # contacts engaged
    for solver, fusion in (("substep", True), ("substep", False), ("kernel", True),
                           ("inline", True)):
        eng = _port_engine(tree, motors, gc, solver, torch.float64, fusion)
        out = _port_step(eng, gc, params, arrays, torch.float64)
        for k, tol in ATOL64.items():
            np.testing.assert_allclose(out[k], ref[k], atol=tol, rtol=0,
                                       err_msg=f"{solver} fusion={fusion} {k}")
    for fusion in (True, False):
        eng = _port_engine(tree, motors, gc, "substep", torch.float32, fusion)
        out = _port_step(eng, gc, params, arrays, torch.float32)
        np.testing.assert_allclose(out["q"], ref["q"], atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(out["v"], ref["v"], atol=2e-2, rtol=1e-2)


def test_parameters_move_the_physics(robot):
    """The same state in every env, different parameters: the envs step
    apart; the nominal parameters step as no parameters (float64)."""
    jrobot, tree, motors = robot
    arrays = _inputs(jrobot, tree, None, seed=3, same=True)
    eng = _port_engine(tree, motors, None, "substep", torch.float64)
    out = _port_step(eng, None, _params(tree, motors.nm, seed=6), arrays, torch.float64)
    for b in range(1, B):
        assert np.abs(out["v"][0] - out["v"][b]).max() > 1e-3
    nom_mp = ModelParams.nominal(tree, motors, B)
    nominal = {k: getattr(nom_mp, k).double().numpy() for k in ModelParams.FIELDS}
    nom = _port_step(eng, None, nominal, arrays, torch.float64)
    bare = _port_step(eng, None, None, arrays, torch.float64)
    for k in ("q", "v", "lam", "tau"):
        np.testing.assert_allclose(nom[k], bare[k], atol=1e-12, rtol=0, err_msg=k)
