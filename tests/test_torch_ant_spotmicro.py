"""The port's Ant and Spotmicro models against jiminy_tpu's.

``make_ant()`` and ``make_spotmicro()`` field for field: the tree
against ``tree_from_arrays`` of the reference's tree (integers exact,
floats atol 1e-7), the motor banks, the sensor suites (types, targets,
delays, noise, buffer lengths, period) and the stand poses (Ant's from
the port's own forward kinematics, within 1e-7 m). The reference builds
Spotmicro through its URDF pipeline and the Ant with its tree builder;
the port builds both directly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jiminy_tpu.models.ant import make_ant as j_make_ant
from jiminy_tpu.models.quadruped import SPOTMICRO as J_SPOTMICRO
from jiminy_tpu.models.quadruped import make_spotmicro as j_make_spotmicro
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models import SPOTMICRO, make_ant, make_spotmicro, stand_q

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SENSOR_KW = dict(sensor_period=1e-3, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)


@pytest.fixture(scope="module")
def models():
    """{name: (reference robot, reference stand pose, port tree, motors,
    sensors, stand pose)}."""
    jant, jstand = j_make_ant()
    tree, motors, sensors, stand = make_ant(device="cpu")
    jspot = j_make_spotmicro(**SENSOR_KW)
    stree, smotors, ssensors = make_spotmicro(device="cpu", **SENSOR_KW)
    return {
        "ant": (jant, np.asarray(jstand), tree, motors, sensors, stand),
        "spotmicro": (jspot, np.asarray(j_stand_q(jspot.tree, J_SPOTMICRO)), stree, smotors,
                      ssensors, stand_q(stree, SPOTMICRO)),
    }


@pytest.mark.parametrize("name", ["ant", "spotmicro"])
def test_tree_matches_reference(models, name):
    jrobot, _, tree, _, _, _ = models[name]
    want = tree_from_arrays({k: np.asarray(getattr(jrobot.tree, k))
                             for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")
    for k in STATIC_FIELDS:
        assert getattr(tree, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        a, b = getattr(tree, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0, err_msg=k)
    assert (tree.nb, tree.nv) == {"ant": (9, 14), "spotmicro": (13, 18)}[name]


@pytest.mark.parametrize("name", ["ant", "spotmicro"])
def test_motors_and_stand_pose_match_reference(models, name):
    jrobot, jstand, tree, motors, _, stand = models[name]
    want = motors_from_arrays({k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS},
                              device="cpu")
    for k in MOTOR_FIELDS:
        a, b = getattr(motors, k), getattr(want, k)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0, err_msg=k)
        else:
            assert tuple(a) == tuple(b), k
    assert stand.dtype == np.float32 and stand.shape == (tree.nq,)
    np.testing.assert_allclose(stand, jstand, atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", ["ant", "spotmicro"])
def test_sensors_match_reference(models, name):
    jrobot, _, _, _, sensors, _ = models[name]
    js = jrobot.sensors
    assert sensors.period == pytest.approx(float(js.period))
    assert [g.type for g in sensors.groups] == [g.type for g in js.groups]
    for g, h in zip(sensors.groups, js.groups):
        assert tuple(g.target) == tuple(h.target) and tuple(g.name) == tuple(h.name)
        assert g.buf_len == h.buf_len
        np.testing.assert_array_equal(np.asarray(g.delay), np.asarray(h.delay))
        np.testing.assert_array_equal(g.noise_std.numpy(), np.asarray(h.noise_std))
        np.testing.assert_array_equal(g.bias.numpy(), np.asarray(h.bias))
    assert sensors.n_buf == js.flatten_buffers(js.init_buffers()).shape[0]
