"""The port's Atlas humanoid against jiminy_tpu's.

- ``make_atlas()`` field for field: the tree against ``tree_from_arrays``
  of the reference's tree (integers exact, floats to the bit: the same
  float32 arithmetic), rigid and with ``humanoid_hardware``'s torso
  flexibility (the reference's ``build_robot`` of its URDF and that
  hardware); the motor bank, the sensor suite (types, targets, delays,
  noise, buffer lengths, period) and the stand pose; the invariants of
  tests/test_legged_envs.py's ``TestAtlasModel`` (23 motors, nv 29, nq 30,
  8 contact points, the base ~0.96 m) and the rows of the solve (nc 47;
  83 with the pairs, six PGS colors), each model taken by the
  whole-substep kernels.
- ``atlas_self_collision_pairs()`` on the port's tree: the generators
  (two ``seg``, two ``ptbox`` of 5 points) and ``contacts_per_pair``
  against the reference's on its tree.

No JAX program is compiled here: the Atlas physics is held against the
reference in tests/test_torch_atlas_env.py, on one reference program.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jiminy_tpu.engine import collision as jc
from jiminy_tpu.models.humanoid import atlas_self_collision_pairs as j_atlas_pairs
from jiminy_tpu.models.humanoid import atlas_stand_q as j_stand_q
from jiminy_tpu.models.humanoid import humanoid_hardware as j_hardware
from jiminy_tpu.models.humanoid import humanoid_urdf
from jiminy_tpu.models.humanoid import make_atlas as j_make_atlas
from jiminy_tpu.robot import build_robot
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import collision as pc
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models import atlas_self_collision_pairs, atlas_stand_q, make_atlas

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SENSOR_KW = dict(sensor_period=4e-3, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)


@pytest.fixture(scope="module")
def models():
    """{variant: (reference robot, port tree, motors, sensors)}."""
    flex = build_robot(humanoid_urdf(), hardware=j_hardware(flexibility=True, sensor_delay=0.004,
                                                            imu_noise=0.02, encoder_noise=0.005),
                       freeflyer=True, sensor_period=4e-3, name="atlas")
    return {
        "rigid": (j_make_atlas(**SENSOR_KW), *make_atlas(device="cpu", **SENSOR_KW)),
        "flexible": (flex, *make_atlas(device="cpu", flexibility=True, **SENSOR_KW)),
    }


@pytest.mark.parametrize("variant", ["rigid", "flexible"])
def test_tree_matches_reference(models, variant):
    jrobot, tree, _, _ = models[variant]
    want = tree_from_arrays({k: np.asarray(getattr(jrobot.tree, k))
                             for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    for k in STATIC_FIELDS:
        assert getattr(tree, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        a, b = getattr(tree, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert (tree.nb, tree.nq, tree.nv) == {"rigid": (24, 30, 29), "flexible": (25, 34, 32)}[variant]


@pytest.mark.parametrize("variant", ["rigid", "flexible"])
def test_motors_sensors_and_stand_pose_match_reference(models, variant):
    jrobot, tree, motors, sensors = models[variant]
    want = motors_from_arrays({k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS},
                              device="cpu")
    for k in MOTOR_FIELDS:
        a, b = getattr(motors, k), getattr(want, k)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        else:
            assert tuple(a) == tuple(b), k
    js = jrobot.sensors
    assert sensors.period == pytest.approx(float(js.period))
    assert [g.type for g in sensors.groups] == [g.type for g in js.groups] == [
        "imu", "encoder", "effort"]
    for g, h in zip(sensors.groups, js.groups):
        assert tuple(g.target) == tuple(h.target) and tuple(g.name) == tuple(h.name)
        assert g.buf_len == h.buf_len
        np.testing.assert_array_equal(np.asarray(g.delay), np.asarray(h.delay))
        np.testing.assert_array_equal(g.noise_std.numpy(), np.asarray(h.noise_std))
        np.testing.assert_array_equal(g.bias.numpy(), np.asarray(h.bias))
    assert sensors.n_buf == js.flatten_buffers(js.init_buffers()).shape[0]
    if variant == "rigid":
        stand = atlas_stand_q(tree)
        assert stand.dtype == np.float32 and stand.shape == (tree.nq,)
        np.testing.assert_array_equal(stand, np.asarray(j_stand_q(jrobot.tree)))


def test_build_invariants(models):
    _, tree, motors, _ = models["rigid"]
    assert motors.nm == 23 and tree.nv == 29 and tree.nq == 30 and tree.ncp == 8
    assert abs(atlas_stand_q(tree)[2] - 0.96) < 0.05
    for pairs, nc, colors in (((), 47, 2), (atlas_self_collision_pairs(), 83, 6)):
        eng = Engine(tree, EngineOptions(contact_model="constraint", dt=4e-3),
                     motors=motors, controller=PDController(300.0, 15.0),
                     collision_pairs=pairs, device="cpu")
        spec = eng.substep_spec
        assert eng.nc == nc and len(spec.cfg.contact_colors) == colors
        assert eng.backend == "substep" and spec.warp_workspace().W == 4
        spec.check_kernel_caps("atlas")  # the whole-substep kernels take it


def test_self_collision_pairs_match_reference(models):
    jrobot, tree, _, _ = models["rigid"]
    want = jc.CollisionPairSet(jrobot.tree, j_atlas_pairs(), 1.0)
    got = pc.CollisionPairSet(tree, atlas_self_collision_pairs(), 1.0)
    assert got.n == want.n == 4 and got.total_contacts == want.total_contacts == 12
    assert got.contacts_per_pair == want.contacts_per_pair == [1, 1, 5, 5]
    assert [k for k, _ in got.gens] == [k for k, _ in want.gens] == ["seg", "seg", "ptbox",
                                                                      "ptbox"]
    for (_, g), (_, w) in zip(got.gens, want.gens, strict=True):
        assert set(g) == set(w)
        for k, x in w.items():
            np.testing.assert_array_equal(np.asarray(g[k], np.float64),
                                          np.asarray(x, np.float64), err_msg=k)
