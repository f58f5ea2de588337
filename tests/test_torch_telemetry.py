"""The port's telemetry logs and robot serialization against jiminy_tpu's.

- The binary log: the port's file is byte for byte the reference's
  (``TelemetryLog.write_binary``, its C++ codec or its Python encoder,
  which write the same bytes) for the same constants and columns; each
  package reads the other's; ``append_rows`` appends as the codec's
  ``jtpu_append_rows`` does (byte-identical files again) and the readers
  take the rows from the data block; ``read_log`` tells the binary and
  HDF5 formats apart; the HDF5 round trip (skipped without h5py) and the
  pandas view (skipped without pandas).
- ``robot_to_json``: string-equal to the reference's for the robots of
  ``data/`` built from their URDF and hardware TOML (ANYmal, Atlas with
  its torso flexibility, the Spotmicro), and ``build_robot_from_log``
  rebuilds each package's robot from the other's JSON with the tree, the
  motors and the sensors bit for bit.
- ``export_html``: the same text as the reference's for the same log.

No reference program compiles here (numpy and file I/O only).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from jiminy_tpu.io.serialization import build_robot_from_log as jbuild_from_log
from jiminy_tpu.io.serialization import robot_to_json as jrobot_to_json
from jiminy_tpu.plot import export_html as jexport_html
from jiminy_tpu.robot import build_robot as jbuild_robot
from jiminy_tpu.telemetry import TelemetryLog as JLog
from jiminy_tpu.telemetry import read_log as jread_log
from jiminy_tpu.telemetry import stack_log as jstack_log
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS
from jiminy_tpu_torch.io.serialization import build_robot_from_log, robot_to_json
from jiminy_tpu_torch.plot import export_html, group_columns
from jiminy_tpu_torch.robot import build_robot
from jiminy_tpu_torch.telemetry import TelemetryLog, append_rows, read_log, stack_log

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "data"
ROBOTS = {"anymal": True, "atlas": True, "spotmicro": True}  # name: freeflyer


def _arrays(rng):
    t = np.linspace(0, 1, 50, dtype=np.float32)
    return t, {"q": rng.normal(size=(50, 3)), "energy": t * 2.0,
               "contact_force": rng.normal(size=(50, 2, 3))}


def _logs():
    t, named = _arrays(np.random.default_rng(0))
    constants = {"robot_name": "toy", "nq": 3, "note": 'a "quoted" value, ü'}
    return stack_log(t, named, dict(constants)), jstack_log(t, named, dict(constants))


def test_binary_is_byte_identical_and_crosses(tmp_path):
    log, jlog = _logs()
    assert list(log.columns) == list(jlog.columns)
    log.write_binary(tmp_path / "port.jtpu")
    jlog.write_binary(tmp_path / "ref.jtpu")
    assert (tmp_path / "port.jtpu").read_bytes() == (tmp_path / "ref.jtpu").read_bytes()
    for back in (TelemetryLog.read_binary(tmp_path / "ref.jtpu"),
                 JLog.read_binary(tmp_path / "port.jtpu")):
        assert back.constants == {k: str(v) for k, v in log.constants.items()}
        assert list(back.columns) == list(log.columns)
        for k, col in log.columns.items():
            np.testing.assert_array_equal(back.columns[k], col)


def test_append_rows_as_the_codec(tmp_path):
    import ctypes

    from jiminy_tpu.native import load_codec

    log, jlog = _logs()
    _, data = log.as_matrix()
    extra = np.arange(5 * data.shape[1], dtype=np.float32).reshape(5, -1)
    log.write_binary(tmp_path / "port.jtpu")
    append_rows(tmp_path / "port.jtpu", extra)
    jlog.write_binary(tmp_path / "ref.jtpu")
    lib = load_codec()
    if lib is None:
        pytest.skip("no C++ toolchain for the reference's codec")
    rc = lib.jtpu_append_rows(str(tmp_path / "ref.jtpu").encode(),
                              extra.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 5,
                              data.shape[1])
    assert rc == 0
    assert (tmp_path / "port.jtpu").read_bytes() == (tmp_path / "ref.jtpu").read_bytes()
    back = read_log(tmp_path / "ref.jtpu")
    assert len(back) == 55
    np.testing.assert_array_equal(back.columns["energy"][-5:], extra[:, 4])
    assert len(jread_log(tmp_path / "port.jtpu")) == 55


def test_read_log_sniffs_and_hdf5_round_trip(tmp_path):
    pytest.importorskip("h5py")
    log, jlog = _logs()
    log.write_binary(tmp_path / "a.jtpu")
    log.write_hdf5(tmp_path / "a.h5")
    jlog.write_hdf5(tmp_path / "ref.h5")
    for path in (tmp_path / "a.jtpu", tmp_path / "a.h5", tmp_path / "ref.h5"):
        back = read_log(path)
        # HDF5 lists its datasets by name, in both packages
        assert len(back) == 50 and sorted(back.columns) == sorted(log.columns), path
        for k, col in log.columns.items():
            np.testing.assert_array_equal(back.columns[k], col)
        assert {k: str(v) for k, v in back.constants.items()} == \
            {k: str(v) for k, v in log.constants.items()}
    assert len(jread_log(tmp_path / "a.h5")) == 50
    (tmp_path / "x.bin").write_bytes(b"nope")
    with pytest.raises(ValueError):
        read_log(tmp_path / "x.bin")


def test_dataframe():
    pytest.importorskip("pandas")
    log, _ = _logs()
    df = log.to_dataframe()
    assert list(df.columns) == list(log.columns) and len(df) == 50


def _robots(name):
    urdf, hw = DATA / f"{name}.urdf", DATA / f"{name}_hardware.toml"
    return (build_robot(urdf, hw, freeflyer=ROBOTS[name], device="cpu"),
            jbuild_robot(urdf, hw, freeflyer=ROBOTS[name]))


def _same_robot(a, b):
    """Two port robots with the same tree, motors and sensors, bit for bit."""
    for k in STATIC_FIELDS:
        assert getattr(a.tree, k) == getattr(b.tree, k), k
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(a.tree, k), getattr(b.tree, k)), k
    assert (a.motors is None) == (b.motors is None)
    if a.motors is not None:
        assert a.motors.name == b.motors.name and a.motors.v_idx == b.motors.v_idx
        for k in ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                  "friction_viscous", "friction_vel_eps"):
            assert torch.equal(getattr(a.motors, k), getattr(b.motors, k)), k
    assert [g.name for g in a.sensors.groups] == [g.name for g in b.sensors.groups]
    for ga, gb in zip(a.sensors.groups, b.sensors.groups):
        assert ga.target == gb.target and ga.buf_len == gb.buf_len
        assert np.array_equal(ga.delay, gb.delay) and torch.equal(ga.bias, gb.bias)


@pytest.mark.parametrize("name", sorted(ROBOTS))
def test_robot_json_string_equal_and_rebuilt(name):
    robot, jrobot = _robots(name)
    text = robot_to_json(robot)
    assert text == jrobot_to_json(jrobot)
    log = TelemetryLog(constants={"robot": text})
    back = build_robot_from_log(log, device="cpu")
    _same_robot(back, robot)
    assert back.name == robot.name and robot_to_json(back) == text
    # each package rebuilds the other's
    jback = jbuild_from_log(JLog(constants={"robot": text}))
    assert jrobot_to_json(jback) == text
    with pytest.raises(KeyError):
        build_robot_from_log(TelemetryLog(), device="cpu")


def test_export_html_equals_reference(tmp_path):
    log, jlog = _logs()
    assert group_columns(log) == {"q": ["q.0", "q.1", "q.2"], "energy": ["energy"],
                                  "contact_force": [f"contact_force.{i}" for i in range(6)]}
    export_html(log, tmp_path / "port.html", title="squat")
    jexport_html(jlog, tmp_path / "ref.html", title="squat")
    assert (tmp_path / "port.html").read_text() == (tmp_path / "ref.html").read_text()
