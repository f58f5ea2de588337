"""Model randomization on Cassie, rigid and flexible, against jiminy_tpu
(ROADMAP C.6): scaled inertials with the pushrods' distance rows, the
shin springs and the SPHERICAL flexibility joints.

One substep (2 ms) of the rigid Cassie and one of the flexible one (a
SPHERICAL joint of 600 N·m/rad above each hip roll), B = 4 each, every
env with its own non-nominal ``ModelParams`` (mass and inertia scales
0.8–1.2, centre-of-mass offsets ±0.02 m, armature 0.7–1.3, motor gain
0.9–1.1, friction 0.5–2.0: tests/test_torch_randomized_substep.py's
draw) packed into the engine's row, from the perturbed stand poses of
tests/test_torch_cassie.py and tests/test_torch_flex.py (the loops open
by millimetres, the springs deflected, the hip quaternions turned
0.05–0.2 rad so that the feet still bear load, a root wrench). The reference's ``"xla"`` engine steps
both in float64 (x64 on) on a float64 copy of each model (ROADMAP C.3),
in one compiled program; the port's plain version in float64 on every
backend (``"substep"`` fused and unfused, ``"kernel"``, ``"inline"``)
is held to it within 1e-9 (contact forces and a within 1e-9/dt). The
parameters move the physics: env by env, the nominal row steps more than
1e-3 away in v.

The CUDA kernels are held against these plain versions on the card
(``chip_smoke.py``, tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.engine.randomization import ModelParams as JModelParams
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine.constraints import distance_constraint_from_arrays
from jiminy_tpu_torch.engine.randomization import ModelParams
from jiminy_tpu_torch.hardware.motors import motors_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 4
DT = 2e-3
KP, KD = 150.0, 6.0
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
CONSTRAINT_FIELDS = ("frame1", "frame2", "distance", "baumgarte_freq")
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
ATOL = {"t": 1e-12, "tau": 1e-9, "q": 1e-9, "v": 1e-9, "lam": 1e-9,
        "solver_residual": 1e-9, "contact_forces": 1e-9 / DT, "a": 1e-9 / DT}
MODELS = ("rigid", "flexible")


def _model(flexibility):
    robot, cons, stand = j_make_cassie(flexibility=flexibility)
    tree = tree_from_arrays(
        {k: np.asarray(getattr(robot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    motors = motors_from_arrays(
        {k: np.asarray(getattr(robot.motors, k)) for k in MOTOR_FIELDS}, device="cpu")
    pcons = tuple(distance_constraint_from_arrays(
        {k: np.asarray(getattr(c, k)) for k in CONSTRAINT_FIELDS}) for c in cons)
    return robot, cons, np.asarray(stand), tree, motors, pcons


def _axis_angle_quats(rng, n, angle):
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return np.concatenate([np.sin(angle / 2)[:, None] * axis, np.cos(angle / 2)[:, None]], 1)


def _inputs(model, seed):
    _, _, stand, tree, motors, _ = model
    rng = np.random.default_rng(seed)
    q = np.tile(stand, (B, 1)).astype(np.float64)
    qi = list(motors.q_idx)
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, 10))
    springs = [tree.q_off[tree.joint_index(n)] for n in ("L_shin_spring", "R_shin_spring")]
    q[:, springs] += rng.uniform(-0.05, 0.05, (B, 2))
    for qo in tree.sprung_spherical[1]:  # the flexible hips (none on the rigid Cassie)
        quat = _axis_angle_quats(rng, B, rng.uniform(0.05, 0.2, B))
        quat[rng.uniform(size=B) < 1 / 3] *= -1.0
        q[:, qo:qo + 4] = quat
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    v = 0.3 * rng.standard_normal((B, tree.nv))
    lam = np.abs(0.05 * rng.standard_normal((B, 28)))
    u = q[:, qi] + rng.uniform(-0.1, 0.1, (B, 10))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    return q, v, lam, u, wrench


def _params(tree, nm, seed) -> dict:
    rng = np.random.default_rng(seed)

    def u(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32).astype(np.float64)

    return {
        "mass_scale": u((B, tree.nb), 0.8, 1.2), "com_offset": u((B, tree.nb, 3), -0.02, 0.02),
        "inertia_scale": u((B, tree.nb), 0.8, 1.2), "armature_scale": u((B, tree.nv), 0.7, 1.3),
        "motor_gain": u((B, nm), 0.9, 1.1), "motor_friction_scale": u((B, nm), 0.5, 2.0),
    }


def _jax_engine(model):
    """The reference ``"xla"`` engine on a float64 copy of the model."""
    robot, cons = model[0], model[1]
    jtree = robot.tree.replace(**{k: jnp.asarray(np.asarray(getattr(robot.tree, k)), jnp.float64)
                                  for k in ARRAY_FIELDS})
    jmotors = robot.motors.replace(**{
        k: jnp.asarray(np.asarray(getattr(robot.motors, k)), jnp.float64)
        for k in MOTOR_FIELDS[3:]})
    return JEngine(jtree, JEngineOptions(contact_model="constraint", constraint_solver="xla",
                                         dt=DT, pgs_iters=8, compute_solver_residual=True),
                   motors=jmotors, controller=JPDController(KP, KD), constraints=cons)


@pytest.fixture(scope="module")
def case():
    """Both models, their inputs and parameters, and the reference's
    randomized substep of each, in float64, from one compiled program."""
    models = {m: _model(m == "flexible") for m in MODELS}
    inputs = {m: _inputs(models[m], seed=i) for i, m in enumerate(MODELS)}
    params = {m: _params(models[m][3], models[m][4].nm, seed=10 + i)
              for i, m in enumerate(MODELS)}
    jax.config.update("jax_enable_x64", True)
    try:
        engines = {m: _jax_engine(models[m]) for m in MODELS}

        def one(eng, arrays, p):
            q, v, lam, u, wrench = arrays
            states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
            out = jax.vmap(lambda s, uu, w, mp: eng.step(s, uu, n_substeps=1, base_wrench=w,
                                                         model_params=mp))(states, u, wrench, p)
            return {k: getattr(out, k) for k in SIM_FIELDS}

        program = jax.jit(lambda args: {m: one(engines[m], *args[m]) for m in MODELS})
        args = {m: (tuple(jnp.asarray(a, jnp.float64) for a in inputs[m]),
                    JModelParams(**{k: jnp.asarray(x, jnp.float64)
                                    for k, x in params[m].items()}))
                for m in MODELS}
        want = jax.tree.map(np.asarray, program(args))
    finally:
        jax.config.update("jax_enable_x64", False)
    return models, inputs, params, want


def _port_step(model, arrays, params, solver, fusion):
    _, _, _, tree, motors, pcons = model
    dt = torch.float64
    eng = Engine(tree.to(dtype=dt),
                 EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8,
                               compute_solver_residual=True, constraint_solver=solver,
                               substep_fusion=fusion),
                 motors=motors.to(dtype=dt), controller=PDController(KP, KD), constraints=pcons,
                 device="cpu")
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dt) for a in arrays)
    state = eng.reset(q, v)
    state.lam = lam
    mp = eng._pack_model_params(ModelParams(
        *(torch.as_tensor(params[k], dtype=dt) for k in ModelParams.FIELDS)))
    out = eng.step(state, u, n_substeps=1, base_wrench=wrench, model_params=mp)
    return eng, {k: getattr(out, k).numpy() for k in SIM_FIELDS}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("solver,fusion", [("substep", True), ("substep", False),
                                           ("kernel", True), ("inline", True)],
                         ids=["substep-fused", "substep-unfused", "kernel", "inline"])
def test_randomized_cassie_substep_matches_reference(case, model, solver, fusion):
    models, inputs, params, want = case
    eng, got = _port_step(models[model], inputs[model], params[model], solver, fusion)
    assert eng.backend == solver
    ref = want[model]
    assert ref["q"].dtype == np.float64
    assert np.abs(ref["lam"][:, 16:]).max() > 0.1  # the feet bear load (the 12 contact rows)
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=0,
                                   err_msg=f"{model} {solver} fusion={fusion} {k}")


@pytest.mark.parametrize("model", MODELS)
def test_parameters_move_cassie(case, model):
    models, inputs, params, _ = case
    tree, motors = models[model][3], models[model][4]
    nominal = ModelParams.nominal(tree, motors, B)
    nom = {k: getattr(nominal, k).double().numpy() for k in ModelParams.FIELDS}
    _, a = _port_step(models[model], inputs[model], params[model], "substep", True)
    _, b = _port_step(models[model], inputs[model], nom, "substep", True)
    assert (np.abs(a["v"] - b["v"]).max(axis=1) > 1e-3).all()
