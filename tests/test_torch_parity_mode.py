"""The port's parity run mode (``jiminy_tpu_torch.parity``) against
jiminy_tpu's harness.

The reference's harness cases (``tests/test_parity_harness.py``) on the
port: a fixture recorded by the port replays bit for bit; a perturbed one
fails; an open-loop torque table replays zero-order-hold; the wxyz
quaternion layout converts. Across the packages: a fixture recorded by
either one replays in the other within the fixture's tolerance (1e-6 in
q, 1e-5 in v; both integrate in float64: the reference program of this
file is the pendulum's RK4 scan, recorded and replayed). Every checked-in
fixture goes through the port's ``compare`` on the CPU with the
reference's verdict (``ok``, as ``test_checked_in_fixtures_pass`` holds
the reference), its drifts within its tolerances and the report naming
the CPU; a fixture whose replay takes more than 20 s here is ``slow``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jiminy_tpu import parity as jparity
from jiminy_tpu_torch import parity

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "parity" / "fixtures"
PENDULUM_URDF = """<?xml version="1.0"?>
<robot name="pendulum">
  <link name="base"/>
  <link name="arm">
    <inertial>
      <origin xyz="0 0 -0.5" rpy="0 0 0"/>
      <mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="pivot" type="revolute">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-6.3" upper="6.3" effort="50" velocity="20"/>
  </joint>
</robot>
"""
OPTS = {"dt": 1e-3, "solver": "runge_kutta_4", "enable_bounds": False}


@pytest.fixture
def urdf(tmp_path):
    p = tmp_path / "pendulum.urdf"
    p.write_text(PENDULUM_URDF)
    return p


def _record(fix, urdf, **kw):
    return parity.record(fix, urdf, q0=np.array([1.0]), engine_options=OPTS, device="cpu", **kw)


def test_roundtrip_bit_exact_and_across_packages(tmp_path, urdf):
    fix = _record(tmp_path / "port", urdf, duration=0.3)
    rep = parity.compare(fix, device="cpu")
    assert rep.ok and rep.max_drift_q == 0.0 and rep.max_drift_v == 0.0 and rep.device == "cpu"
    meta = json.loads((fix / "meta.json").read_text())
    assert meta["engine_options"] == OPTS and meta["source"] == "jiminy_tpu-self"
    # the reference replays the port's fixture, and the port the reference's
    jrep = jparity.compare(fix)
    assert jrep.ok, jrep
    jfix = jparity.record(tmp_path / "ref", urdf, duration=0.3, q0=np.array([1.0]),
                          engine_options=OPTS)
    rep2 = parity.compare(jfix, device="cpu")
    assert rep2.ok, rep2
    assert abs(rep2.max_drift_q - jrep.max_drift_q) < 1e-12
    print("port fixture in the reference:", jrep.json(), "reference fixture in the port:",
          rep2.json())


def test_drift_detection_fires(tmp_path, urdf):
    fix = _record(tmp_path / "fix", urdf, duration=0.2)
    data = dict(np.load(fix / "traj.npz"))
    data["q"][1:] += 1e-4  # sample 0 is the replay's start
    np.savez(fix / "traj.npz", **data)
    rep = parity.compare(fix, device="cpu")
    assert not rep.ok and rep.max_drift_q >= 9e-5


def test_open_loop_command_table(tmp_path, urdf):
    u = 0.5 * np.sin(np.linspace(0, 4, 200))[:, None]
    fix = _record(tmp_path / "fix", urdf, duration=0.2, u_table=u)
    rep = parity.compare(fix, device="cpu")
    assert rep.ok and rep.max_drift_q == 0.0
    passive = _record(tmp_path / "passive", urdf, duration=0.2)
    qa, qb = np.load(fix / "traj.npz")["q"], np.load(passive / "traj.npz")["q"]
    assert np.max(np.abs(qa - qb)) > 1e-4


def test_quat_conversion_wxyz():
    q = np.zeros((2, 8))
    q[:, 3] = 0.9
    q[:, 4:7] = [0.1, 0.2, 0.3]
    q[:, 7] = 5.0
    for conv in ("wxyz", "xyzw"):
        np.testing.assert_array_equal(parity._quat_to_xyzw(q, conv, True),
                                      jparity._quat_to_xyzw(q, conv, True))
    np.testing.assert_allclose(parity._quat_to_xyzw(q, "wxyz", True)[0, 3:7], [0.1, 0.2, 0.3, 0.9])
    with pytest.raises(ValueError):
        parity._quat_to_xyzw(q, "zyxw", True)


# each checked-in fixture's replay; past 20 s on one CPU thread, slow (the
# conical pendulum's 5,000 substeps ~43 s, the double pendulum's 2,000 RK4
# steps ~24 s, the wheel's 5,000 substeps ~75 s)
FIXTURE_CASES = [
    "anymal_drop_euler",
    "ball_drop_impact",
    pytest.param("conical_pendulum_loop", marks=pytest.mark.slow),
    pytest.param("double_pendulum_rk4", marks=pytest.mark.slow),
    pytest.param("wheel_roll_no_slip", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name", FIXTURE_CASES)
def test_checked_in_fixture_passes(name):
    rep = parity.compare(FIXTURES / name, device="cpu")
    assert rep.ok, rep
    assert rep.max_drift_q <= rep.tolerance_q and rep.max_drift_v <= rep.tolerance_v
    assert rep.device == "cpu" and rep.name == name


def test_cli_runs_the_fixtures(tmp_path, urdf, capsys):
    fix = _record(tmp_path / "fixtures" / "a", urdf, duration=0.05)
    assert parity.main(["run", str(tmp_path / "fixtures" / "*"), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report, summary = json.loads(lines[0]), json.loads(lines[-1])
    assert report["name"] == "a" and report["ok"] and report["device"] == "cpu"
    assert summary == {"metric": "cross_engine_parity", "fixtures": 1, "passed": 1,
                       "max_drift_q": 0.0, "max_drift_v": 0.0, "ok": True}
    assert fix.exists()
