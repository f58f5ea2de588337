"""The port's substep on per-env analytic grounds against jiminy_tpu's.

ANYmal, B = 4, one ground per env of each analytic kind, its coefficients
made with numpy from a seed and handed to both packages: Fourier (16
terms, amplitude 0.08, wavelength 1.5, the reference sampler's amplitude
ladder), Perlin ([seed, 1/1.5, 0.08], 3 octaves) and Stairs (env 0 and
env 2 with their front feet on a riser, so that their contact bases take
the steep switch, n_z < 0.9). Bases spread over a few metres of terrain,
raised by the mean height under the feet (feet penetrating, hovering and
clear), with random joints, velocities, warm starts, PD targets and a
root wrench (the inputs of tests/test_torch_substep.py).

The reference engine (``constraint_solver="xla"``) steps each env on its
own ground over a whole env step (4 substeps) in float64 (jax x64 on, as
tests/test_x64_parity.py runs it; one compiled program per ground kind,
~20 s each here). Against it:

- the port in float64, fused (``substep_multi_reference`` with the
  coefficients) and unfused (``substep_reference`` per substep): q 4e-9,
  v, λ and the residual 4e-7, contact forces and a 4e-7/dt, which is
  tests/test_torch_substep.py's float64 tolerance for one substep times
  the 4 substeps (its floor is the reference's float32 CRBA constants);
- the port in float32, fused: the tolerances of
  tests/test_substep_kernel.py's Fourier-ground test, q 2e-4, v 2e-2.
- Two envs on the same state and different grounds step differently;
  the same ground, identically.
- ``Engine`` takes a per-env ground of its own kind only, and a
  heightmap resolves ``"auto"`` to ``"kernel"``.

The Pallas kernel's own ground query (interpret mode) is held in
tests/test_torch_ground_interpret.py; the CUDA kernels in
tests/test_torch_cuda.py.
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
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.contact import contact_points_world
from jiminy_tpu_torch.engine.terrain import perlin_ground
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.ops.substep_kernel import substep_batched_multi

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
KINDS = ("fourier", "perlin", "stairs")


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


def _coefficients(kind, seed=0):
    """(B, n_gc) float64 coefficients of B grounds of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "fourier":
        octave = np.arange(K) % 3
        amp = 0.5**octave / np.sqrt(np.bincount(octave)[octave])
        amp *= 0.08 / np.sqrt(np.sum(0.25 ** np.arange(3)))
        theta = rng.uniform(0, 2 * np.pi, (B, K))
        mag = 2 * np.pi / 1.5 * 2.0**octave * rng.uniform(0.75, 1.25, (B, K))
        return np.concatenate([np.tile(amp, (B, 1)), mag * np.cos(theta), mag * np.sin(theta),
                               rng.uniform(0, 2 * np.pi, (B, K))], 1)
    if kind == "perlin":
        return np.stack([rng.integers(0, 1 << 24, B), np.full(B, 1 / 1.5), np.full(B, 0.08)], 1)
    # [w, H, n, ramp, x0]: envs 0 and 2 with their front feet (x ≈ 0.37)
    # on a ramp, envs 1 and 3 on treads and in the air behind
    return np.array([[0.4, 0.08, 10, 0.05, -0.05], [0.4, 0.08, 10, 0.05, 0.0],
                     [0.3, 0.06, 10, 0.05, -0.23], [0.4, 0.08, 10, 0.05, 0.2]])


def _jax_grounds(kind, gc, dtype):
    gc = jnp.asarray(gc, dtype)
    if kind == "fourier":
        return jg.FourierGround(*(gc[:, i * K:(i + 1) * K] for i in range(4)))
    if kind == "perlin":
        return jg.PerlinGround(seed=gc[:, 0], freq=gc[:, 1], amp=gc[:, 2], octaves=3)
    return jg.StairsGround(*(gc[:, i] for i in range(5)))


def _port_grounds(kind, gc, dtype):
    gc = torch.as_tensor(gc, dtype=dtype)
    return pg.PerlinGround(gc, 3) if kind == "perlin" else {
        "fourier": pg.FourierGround, "stairs": pg.StairsGround}[kind](gc)


def _feet(tree, q):
    xw, vel = algos.kinematics(tree, q, torch.zeros(q.shape[0], tree.nv, dtype=q.dtype))
    return contact_points_world(tree, xw, vel)[0]


def _inputs(jrobot, tree, kind, gc, seed, spread=2.0):
    """Perturbed stand poses over the terrain, the base raised by the
    mean height under its feet."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (B, 1)).astype(np.float64)
    q[:, 0:2] = rng.uniform(-spread, spread, (B, 2)) if kind != "stairs" else \
        rng.uniform(-0.01, 0.01, (B, 2))
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    feet = _feet(tree.to(dtype=torch.float64), torch.as_tensor(q))
    h, _ = _port_grounds(kind, gc, torch.float64).query(feet[..., :2])
    q[:, 2] += h.mean(1).numpy() + rng.uniform(-0.02, 0.01, B)
    v = 0.3 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    u = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate([5.0 * rng.standard_normal((B, 3)),
                             20.0 * rng.standard_normal((B, 3))], 1)
    return q, v, lam, u, wrench


def _jax_step(jrobot, kind, gc, arrays, n_substeps, dtype):
    q, v, lam, u, wrench = (jnp.asarray(a, dtype) for a in arrays)
    grounds = _jax_grounds(kind, gc, dtype)
    eng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="xla", dt=DT,
                       pgs_iters=8, compute_solver_residual=True),
        ground=jax.tree.map(lambda x: x[0], grounds),
        motors=jrobot.motors,
        controller=JPDController(KP, KD),
    )
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    step = jax.jit(jax.vmap(
        lambda s, uu, w, g: eng.step(s, uu, n_substeps=n_substeps, base_wrench=w, ground=g)
    ))
    out = step(states, u, wrench, grounds)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _port_engine(tree, motors, kind, gc, solver, dtype):
    opts = EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8,
                         compute_solver_residual=True,
                         constraint_solver=solver)
    return Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                  controller=PDController(KP, KD),
                  ground=_port_grounds(kind, gc[0], dtype), device="cpu")


def _port_step(engine, kind, gc, arrays, n_substeps, dtype):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    state = engine.reset(q, v)
    state.lam = lam
    out = engine.step(state, u, n_substeps=n_substeps, base_wrench=wrench,
                      ground=_port_grounds(kind, gc, dtype))
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


def _steep_contacts(tree, kind, gc, q):
    """Number of contacts whose ground normal takes the steep switch."""
    feet = _feet(tree.to(dtype=torch.float64), torch.as_tensor(q))
    _, n = _port_grounds(kind, gc, torch.float64).query(feet[..., :2])
    return int((n[..., 2] < 0.9).sum())


@pytest.mark.parametrize("kind", KINDS)
def test_env_step_matches_reference(robot, kind):
    jrobot, tree, motors = robot
    gc = _coefficients(kind)
    arrays = _inputs(jrobot, tree, kind, gc, seed=0)
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    ref = _jax_step(jrobot, kind, gc, arrays, 4, jnp.float64)
    assert ref["q"].dtype == np.float64
    assert np.abs(ref["lam"][:, 12:]).max() > 0.05  # contacts engaged
    if kind == "stairs":
        assert _steep_contacts(tree, kind, gc, arrays[0]) >= 2  # on the risers
        assert np.abs(ref["contact_forces"][:, :, 0]).max() > 1.0  # a riser pushes back in x
    atol = {"t": 1e-12, "tau": 2e-6, "q": 4e-9, "v": 4e-7, "lam": 4e-7,
            "solver_residual": 4e-7, "contact_forces": 4e-7 / DT, "a": 4e-7 / DT}
    for solver in ("substep", "inline"):  # fused, and one substep at a time
        eng = _port_engine(tree, motors, kind, gc, solver, torch.float64)
        out = _port_step(eng, kind, gc, arrays, 4, torch.float64)
        for k, tol in atol.items():
            np.testing.assert_allclose(out[k], ref[k], atol=tol, rtol=0, err_msg=f"{solver} {k}")
    eng = _port_engine(tree, motors, kind, gc, "substep", torch.float32)
    assert eng.backend == "substep" and eng.substep_spec.n_gc == gc.shape[1]
    out = _port_step(eng, kind, gc, arrays, 4, torch.float32)
    np.testing.assert_allclose(out["q"], ref["q"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(out["v"], ref["v"], atol=2e-2, rtol=0)


def test_each_env_steps_on_its_own_ground(robot):
    """The same state on two different Fourier grounds moves differently;
    on the same ground, identically (``substep_batched_multi`` on CPU
    tensors, the K2 entry point's plain version)."""
    jrobot, tree, motors = robot
    gc = _coefficients("fourier", seed=2)
    gc[2] = gc[0]
    q, v, lam, u, w = _inputs(jrobot, tree, "fourier", gc, seed=2, spread=0.0)
    same = [torch.as_tensor(np.repeat(a[:1], B, 0), dtype=torch.float32) for a in (q, v, u, lam, w)]
    eng = _port_engine(tree, motors, "fourier", gc, "substep", torch.float32)
    out = substep_batched_multi(eng.substep_spec, 4, *same,
                                gc=torch.as_tensor(gc, dtype=torch.float32))
    qn = out[0]
    assert torch.equal(qn[0], qn[2])
    assert (qn[0] - qn[1]).abs().max() > 1e-3 and (qn[0] - qn[3]).abs().max() > 1e-3


def test_engine_takes_grounds_of_its_own_kind(robot):
    _, tree, motors = robot
    gc = _coefficients("fourier")
    eng = _port_engine(tree, motors, "fourier", gc, "substep", torch.float32)
    state = eng.reset(torch.as_tensor(np.tile(j_stand_q(j_make_anymal().tree), (B, 1)),
                                      dtype=torch.float32))
    u = torch.zeros(B, 12)
    few = pg.FourierGround(torch.as_tensor(gc[:, :4 * 8], dtype=torch.float32))  # 8 terms
    perlin = _port_grounds("perlin", _coefficients("perlin"), torch.float32)
    for bad in (few, perlin, pg.FlatGround()):
        assert not eng._kernel_ground_ok(bad)
        with pytest.raises(ValueError, match="outside this engine's substep"):
            eng.step(state, u, ground=bad)
    with pytest.raises(ValueError, match="batch of 4"):
        eng.step(state, u, ground=_port_grounds("fourier", gc[:2], torch.float32))
    shared = eng.step(state, u, n_substeps=1)  # the engine's own ground, for every env
    per_env = eng.step(state, u, n_substeps=1,
                       ground=_port_grounds("fourier", np.repeat(gc[:1], B, 0), torch.float32))
    assert torch.equal(shared.q, per_env.q)
    spec = eng.substep_spec
    with pytest.raises(ValueError, match="needs its coefficients"):
        substep_batched_multi(spec, 1, state.q, state.v, u, state.lam, torch.zeros(B, 6))


def test_heightmap_runs_the_chain_kernel_path(robot):
    """A heightmap is outside the whole-substep kernels: ``"auto"`` picks
    ``"kernel"``, ``"substep"`` raises, and the plain substep queries the
    grid."""
    _, tree, motors = robot
    hm = perlin_ground(seed=1, size=3.0, resolution=0.1, amplitude=0.08, wavelength=1.5,
                       device="cpu")
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT), motors=motors,
                 controller=PDController(KP, KD),
                 ground=hm, device="cpu")
    assert eng.backend == "kernel" and eng.substep_spec.n_gc == 0
    with pytest.raises(ValueError, match="heightmap"):
        Engine(tree, EngineOptions(contact_model="constraint", dt=DT, constraint_solver="substep"),
               motors=motors,
               controller=PDController(KP, KD), ground=hm, device="cpu")
    assert not eng._kernel_ground_ok(perlin_ground(seed=1, size=3.0, device="cpu"))
    q = torch.as_tensor(np.tile(j_stand_q(j_make_anymal().tree), (B, 1)), dtype=torch.float32)
    q[:, 0] = torch.tensor([-1.0, 0.0, 1.0, 2.0])
    out = eng.step(eng.reset(q), torch.zeros(B, 12), n_substeps=2)
    assert bool(torch.isfinite(out.q).all())
