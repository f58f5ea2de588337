"""The port's model randomization against jiminy_tpu's.

Per-env scales are made with numpy from a seed (B = 5, ANYmal; the
slice's ranges widened to armature and friction: mass and inertia 0.8–1.2,
centre-of-mass offsets ±0.02 m, armature 0.7–1.3, motor gain 0.9–1.1,
friction 0.5–2.0) and handed to both packages; the model crosses as
numpy arrays (``tree_from_arrays``).

- ``ModelParams.apply_to_tree`` (each env's mass, h, origin inertia and
  armature) equals the reference's ``ModelParams.apply_to_tree`` of each
  env in float32 to 2e-6 relative to each field's largest entry (the two
  round the same float32 operations, XLA fusing some); the effort with
  each env's gain and friction scales (``Motors.compute_effort(...,
  mscale=)``) equals the reference's effort through its
  ``apply_to_motors`` to 1e-6 relative.
- The parallel-axis identity holds in float64: h' = m'·c', and the
  perturbed inertia less m'·(c'ᵀc'·E − c' c'ᵀ) is (s_I·s) times the
  nominal central inertia, to 1e-12.
- A massless body's inertials stay exactly the tree's under any scales.
- The nominal parameters give back the tree's inertials (to 1e-6
  relative: the central inertia is rebuilt, so not bit for bit) and, as
  unit scales, the unscaled effort bit for bit.
- The packed row (``Engine._pack_model_params``) equals the reference's
  ``Engine._pack_model_params`` of each env element by element (float32,
  2e-6 relative to the row's field), 172 floats for ANYmal, and the
  plain version's unpacking reads it back; the engine refuses rows of
  another batch.
- ``ModelRandomization.sample`` and ``sample_sensor_bias``: shapes,
  ranges, degenerate ranges exact, seeded.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.engine.randomization import ModelParams as JModelParams
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine.randomization import ModelParams, ModelRandomization
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models.quadruped import make_anymal
from jiminy_tpu_torch.ops.substep_kernel import unpack_model_params

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 5
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)


@pytest.fixture(scope="module")
def robot():
    jrobot = j_make_anymal()
    arrays = {k: np.asarray(getattr(jrobot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}
    motors = motors_from_arrays(
        {k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS}, device="cpu")
    return jrobot, arrays, motors


def _scales(tree, nm, seed=0) -> dict:
    """Per-env perturbations, float32, made with numpy."""
    rng = np.random.default_rng(seed)
    nb, nv = tree.nb, tree.nv

    def u(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return {
        "mass_scale": u((B, nb), 0.8, 1.2), "com_offset": u((B, nb, 3), -0.02, 0.02),
        "inertia_scale": u((B, nb), 0.8, 1.2), "armature_scale": u((B, nv), 0.7, 1.3),
        "motor_gain": u((B, nm), 0.9, 1.1), "motor_friction_scale": u((B, nm), 0.5, 2.0),
    }


def _port(sc, dtype=torch.float32) -> ModelParams:
    return ModelParams(*(torch.as_tensor(sc[k], dtype=dtype) for k in ModelParams.FIELDS))


def _ref(sc, b) -> JModelParams:
    return JModelParams(**{k: jnp.asarray(x[b]) for k, x in sc.items()})


def _rel_close(port, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, atol=rtol * scale, rtol=0,
                               err_msg=what)


def test_apply_to_tree_and_motors_match_reference(robot):
    jrobot, arrays, motors = robot
    tree = tree_from_arrays(arrays, device="cpu")
    sc = _scales(tree, motors.nm)
    mp = _port(sc)
    dyn = mp.apply_to_tree(tree)
    for b in range(B):
        jt = _ref(sc, b).apply_to_tree(jrobot.tree)
        _rel_close(dyn.mass[b], jt.inertia_mass, 2e-6, "mass")
        _rel_close(dyn.h[b], jt.inertia_h, 2e-6, "h")
        _rel_close(dyn.inertia[b], jt.inertia_mat, 2e-6, "inertia")
        _rel_close(dyn.armature[b], jt.armature, 2e-6, "armature")
    # each env's gain and friction scales in compute_effort, env by env
    # against the reference's effort through its randomized motor bank
    rng = np.random.default_rng(1)
    cmd = rng.uniform(-60, 60, (B, motors.nm)).astype(np.float32)
    v = rng.uniform(-12, 12, (B, tree.nv)).astype(np.float32)
    tau = motors.compute_effort(torch.as_tensor(cmd), torch.as_tensor(v),
                                (mp.motor_gain, mp.motor_friction_scale))
    for b in range(B):
        jm = _ref(sc, b).apply_to_motors(jrobot.motors)
        _rel_close(tau[b], jm.compute_effort(jnp.asarray(cmd[b]), jnp.asarray(v[b])), 1e-6, "tau")


def test_parallel_axis_identity(robot):
    _, arrays, motors = robot
    tree = tree_from_arrays(arrays, device="cpu", dtype=torch.float64)
    sc = _scales(tree, motors.nm, seed=2)
    mp = _port(sc, torch.float64)
    dyn = mp.apply_to_tree(tree)
    m = tree.inertia_mass
    c = tree.inertia_h / m[:, None]
    c2 = c + mp.com_offset
    torch.testing.assert_close(dyn.h, dyn.mass[..., None] * c2, atol=1e-12, rtol=0)

    def central(I, mass, com):
        cc = (com * com).sum(-1)[..., None, None]
        return I - mass[..., None, None] * (cc * torch.eye(3, dtype=I.dtype)
                                             - com[..., :, None] * com[..., None, :])

    want = (mp.inertia_scale * mp.mass_scale)[..., None, None] * central(tree.inertia_mat, m, c)
    torch.testing.assert_close(central(dyn.inertia, dyn.mass, c2), want, atol=1e-12, rtol=0)
    torch.testing.assert_close(dyn.armature, tree.armature * mp.armature_scale, atol=0, rtol=0)


def test_massless_bodies_stay_untouched(robot):
    _, arrays, motors = robot
    tree = tree_from_arrays(arrays, device="cpu")
    k = 3  # a leg link made massless
    z = {f: getattr(tree, f).clone() for f in ("inertia_mass", "inertia_h", "inertia_mat")}
    z["inertia_mass"][k] = 0.0
    z["inertia_h"][k] = 0.0
    z["inertia_mat"][k] = torch.diag(torch.tensor([1e-3, 2e-3, 3e-3]))
    tree = dataclasses.replace(tree, **z)
    dyn = _port(_scales(tree, motors.nm, seed=3)).apply_to_tree(tree)
    assert torch.equal(dyn.mass[:, k], torch.zeros(B))
    assert torch.equal(dyn.h[:, k], torch.zeros(B, 3))
    assert torch.equal(dyn.inertia[:, k], z["inertia_mat"][k].expand(B, 3, 3))
    assert not torch.equal(dyn.mass[:, k + 1], tree.inertia_mass[k + 1].expand(B))


def test_nominal_is_the_identity(robot):
    _, arrays, motors = robot
    tree = tree_from_arrays(arrays, device="cpu")
    nom = ModelParams.nominal(tree, motors, B)
    dyn = nom.apply_to_tree(tree)
    _rel_close(dyn.mass, tree.inertia_mass.expand(B, -1), 1e-6, "mass")
    _rel_close(dyn.h, tree.inertia_h.expand(B, -1, -1), 1e-6, "h")
    _rel_close(dyn.inertia, tree.inertia_mat.expand(B, -1, -1, -1), 1e-6, "inertia")
    assert torch.equal(dyn.armature, tree.armature.expand(B, -1))
    rng = np.random.default_rng(5)
    cmd = torch.as_tensor(rng.uniform(-60, 60, (B, motors.nm)).astype(np.float32))
    v = torch.as_tensor(rng.uniform(-12, 12, (B, tree.nv)).astype(np.float32))
    assert torch.equal(motors.compute_effort(cmd, v, (nom.motor_gain, nom.motor_friction_scale)),
                       motors.compute_effort(cmd, v))


def test_packed_row_matches_reference(robot):
    jrobot, arrays, motors = robot
    tree = tree_from_arrays(arrays, device="cpu")
    jeng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="pallas_substep", dt=5e-3),
        motors=jrobot.motors, controller=JPDController(80.0, 2.0),
    )
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=5e-3), motors=motors,
                 controller=PDController(80.0, 2.0),
                 device="cpu")
    spec = eng.substep_spec
    assert spec.n_mp == 10 * tree.nb + tree.nv + 2 * motors.nm == 172
    sc = _scales(tree, motors.nm, seed=4)
    row = eng._pack_model_params(_port(sc))
    assert row.shape == (B, spec.n_mp) and row.dtype == torch.float32 and row.is_contiguous()
    nb, nv, nm = tree.nb, tree.nv, motors.nm
    fields = {"mass": (0, nb), "h": (nb, 4 * nb), "inertia": (4 * nb, 10 * nb),
              "armature": (10 * nb, 10 * nb + nv), "gain": (10 * nb + nv, 10 * nb + nv + nm),
              "friction": (10 * nb + nv + nm, spec.n_mp)}
    for b in range(B):
        ref = np.asarray(jeng._pack_model_params(_ref(sc, b)))
        assert ref.shape == (spec.n_mp,)
        for name, (lo, hi) in fields.items():
            _rel_close(row[b, lo:hi], ref[lo:hi], 2e-6, name)
    # the plain version reads it back: the inertia symmetric from xx, yy, zz, xy, xz, yz
    inertials, (gain, fric) = unpack_model_params(spec, row)
    dyn = _port(sc).apply_to_tree(tree)
    assert torch.equal(inertials.mass, dyn.mass) and torch.equal(inertials.h, dyn.h)
    torch.testing.assert_close(inertials.inertia, dyn.inertia, atol=0, rtol=0)
    assert torch.equal(gain, _port(sc).motor_gain) and torch.equal(fric, _port(sc).motor_friction_scale)
    four = eng.reset(torch.zeros(4, tree.nq))
    with pytest.raises(ValueError, match=r"model parameters mp of shape \(5, 172\)"):
        eng.step(four, torch.zeros(4, motors.nm), model_params=row)


def test_sample_shapes_and_ranges():
    tree, motors, suite = make_anymal(device="cpu", sensor_delay=0.004, imu_noise=0.02)
    mr = ModelRandomization(mass_scale=(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2),
                            motor_gain=(0.9, 1.1), sensor_bias=0.05)
    mp = mr.sample(torch.Generator().manual_seed(0), tree, motors, 256)
    want = {"mass_scale": (256, tree.nb), "com_offset": (256, tree.nb, 3),
            "inertia_scale": (256, tree.nb), "armature_scale": (256, tree.nv),
            "motor_gain": (256, motors.nm), "motor_friction_scale": (256, motors.nm)}
    ranges = {"mass_scale": (0.8, 1.2), "com_offset": (-0.02, 0.02),
              "inertia_scale": (0.8, 1.2), "motor_gain": (0.9, 1.1)}
    for k, shape in want.items():
        x = getattr(mp, k)
        assert tuple(x.shape) == shape and x.dtype == tree.dtype, k
        lo, hi = ranges.get(k, (1.0, 1.0))
        assert float(x.min()) >= lo and float(x.max()) <= hi, k
        if lo < hi:
            assert float(x.max() - x.min()) > 0.9 * (hi - lo), k  # spread over the range
    # the degenerate default ranges (armature, friction) are exactly one
    assert torch.equal(mp.armature_scale, torch.ones(256, tree.nv))
    assert torch.equal(mp.motor_friction_scale, torch.ones(256, motors.nm))
    again = mr.sample(torch.Generator().manual_seed(0), tree, motors, 256)
    assert all(torch.equal(getattr(again, k), getattr(mp, k)) for k in ModelParams.FIELDS)
    bias = mr.sample_sensor_bias(torch.Generator().manual_seed(1), suite, 256)
    assert [tuple(b.shape) for b in bias] == [(256, g.ns, g.ndim) for g in suite.groups]
    flat = torch.cat([b.reshape(256, -1) for b in bias], 1)
    assert flat.shape == (256, suite.n_eps)
    assert float(flat.abs().max()) <= 0.05 and float(flat.abs().max()) > 0.04
