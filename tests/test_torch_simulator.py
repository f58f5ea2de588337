"""The port's Simulator, Trajectory and options TOML against jiminy_tpu's.

- ``Simulator.simulate`` of the pendulum with an IMU at its tip and an
  effort sensor on its pivot (``record_sensors``, no noise, so no random
  stream needs matching; ``tests/test_sensor_recording.py``'s model), the
  bob out of the ground's reach: the reference runs it once, in float64
  (its one program here). The same columns in the same order and the same
  constants (the robot's JSON string-equal; the engine options equal once
  the reference's JAX scalars are read as floats); the columns within
  1e-5 of the port's float32 run and within 1e-6 of its float64 run (the
  log is float32 on both sides), the final state of the float64 runs
  within 1e-9.
- ``simulate_batch`` of the double pendulum (B = 4 seeded starts, a
  batched PD) against the reference's within 1e-5, and bit for bit a
  hand-written loop of ``Engine.step``.
- The options TOML written by either side and read by the other.
- ``Trajectory.at`` (Lie-group interpolation through ``algos.difference``
  and ``integrate``) and ``from_log`` on ANYmal's tree (a FREE joint)
  within 1e-9 in float64, the reference run eagerly.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.dynamics import Trajectory as JTrajectory
from jiminy_tpu.engine.engine import EngineOptions as JOptions
from jiminy_tpu.engine.ground import FlatGround as JFlat
from jiminy_tpu.hardware.sensors import SensorSuite as JSuite
from jiminy_tpu.hardware.sensors import effort_spec as jeffort
from jiminy_tpu.hardware.sensors import imu_spec as jimu
from jiminy_tpu.models.quadruped import make_anymal as jmake_anymal
from jiminy_tpu.models.toys import make_double_pendulum as jmake_double
from jiminy_tpu.models.toys import make_pendulum as jmake_pendulum
from jiminy_tpu.robot import Robot as JRobot
from jiminy_tpu.simulator import Simulator as JSimulator
from jiminy_tpu.telemetry import TelemetryLog as JLog
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.dynamics import Trajectory
from jiminy_tpu_torch.engine import EngineOptions
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.hardware.sensors import SensorSuite, effort_spec, imu_spec
from jiminy_tpu_torch.robot import Robot
from jiminy_tpu_torch.simulator import Simulator
from jiminy_tpu_torch.telemetry import TelemetryLog

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DT = 1e-3
T_END = 0.1


def port_tree(jtree, dtype=torch.float32):
    return tree_from_arrays({k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS},
                            device="cpu", dtype=dtype)


def _port_pendulum(dtype):
    tree = port_tree(jmake_pendulum(), dtype)
    suite = SensorSuite.build(tree, [imu_spec("tip"), effort_spec("pivot")], period=DT)
    sim = Simulator(Robot(tree, sensors=suite, name="pendulum"), options=EngineOptions(dt=DT),
                    ground=FlatGround(height=-5.0), device="cpu")
    return sim.simulate(T_END, q0=np.array([0.8]), v0=np.array([0.3]), record_sensors=True)


def _options(text: str) -> str:
    """The reference's engine options constant with its JAX scalars as
    floats (``Array(100000., dtype=float32)`` → ``100000.0``)."""
    return re.sub(r"Array\(([-0-9.e+]+), dtype=\w+\)", lambda m: repr(float(m.group(1))), text)


@pytest.fixture(scope="module")
def ref64():
    """The reference's float64 run with the sensors recorded."""
    with jax.enable_x64(True):
        jtree = jmake_pendulum()
        suite = JSuite.build(jtree, [jimu("tip"), jeffort("pivot")], period=DT)
        sim = JSimulator(JRobot(jtree, sensors=suite, name="pendulum"), options=JOptions(dt=DT),
                         ground=JFlat(height=jnp.float64(-5.0)))
        final, log = sim.simulate(T_END, q0=jnp.array([0.8], jnp.float64),
                                  v0=jnp.array([0.3], jnp.float64), record_sensors=True)
        return {k: np.asarray(getattr(final, k)) for k in ("t", "q", "v")}, log


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.float64, 1e-6)])
def test_simulate_matches_reference(ref64, dtype, atol):
    jfinal, jlog = ref64
    final, log = _port_pendulum(dtype)
    assert list(log.columns) == list(jlog.columns)
    assert "sensor_imu.9" in log.columns and "sensor_effort.0" in log.columns
    assert log.constants.keys() == jlog.constants.keys()
    for k, want in jlog.constants.items():
        got = log.constants[k]
        assert (got == _options(want)) if k == "engine_options" else (got == want), k
    assert len(log) == round(T_END / DT)
    for k, col in jlog.columns.items():
        np.testing.assert_allclose(log.columns[k], col, atol=atol, rtol=0, err_msg=k)
    if dtype == torch.float64:
        for k in ("t", "q", "v"):
            np.testing.assert_allclose(getattr(final, k)[0].numpy(), jfinal[k].reshape(-1),
                                       atol=1e-9, rtol=0, err_msg=k)


def test_simulate_batch_matches_reference_and_the_step_loop():
    rng = np.random.default_rng(0)
    q0 = rng.uniform(-0.6, 0.6, (4, 2)).astype(np.float32)
    v0 = rng.uniform(-0.5, 0.5, (4, 2)).astype(np.float32)
    opts = dict(dt=2e-3)
    jsim = JSimulator(JRobot(jmake_double()), options=JOptions(**opts),
                      ground=JFlat(height=jnp.float32(-10.0)))
    want = jsim.simulate_batch(0.1, jnp.asarray(q0), jnp.asarray(v0),
                               controller=lambda q, v, t: -4.0 * q - 0.5 * v, control_dt=1e-2)
    sim = Simulator(Robot(port_tree(jmake_double())), options=EngineOptions(**opts),
                    ground=FlatGround(height=-10.0), device="cpu")
    got = sim.simulate_batch(0.1, q0, v0, controller=lambda q, v, t: -4.0 * q - 0.5 * v,
                             control_dt=1e-2)
    for k in ("t", "q", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-5, rtol=0, err_msg=k)
    eng = sim.engine
    st = eng.reset(torch.as_tensor(q0), torch.as_tensor(v0))
    for _ in range(10):
        st = eng.step(st, -4.0 * st.q - 0.5 * st.v, n_substeps=5)
    for k in ("t", "q", "v", "lam"):
        assert torch.equal(getattr(st, k), getattr(got, k)), k


def test_options_toml_crosses_both_ways(tmp_path):
    opts = dict(dt=2.5e-3, contact_model="constraint", pgs_iters=12, substep_fusion=False)
    contacts = dict(friction=0.7, stiffness=2e4)
    jsim = JSimulator(JRobot(jmake_pendulum()), options=JOptions(**opts))
    jsim.engine.set_options({"contacts": contacts})
    sim = Simulator(Robot(port_tree(jmake_pendulum())), device="cpu")
    jsim.export_options(tmp_path / "ref.toml")
    sim.import_options(tmp_path / "ref.toml")
    got = sim.engine.options
    for k, x in opts.items():
        assert getattr(got, k) == x, k
    for k, x in contacts.items():
        assert getattr(got.contacts, k) == pytest.approx(x, rel=1e-7), k
    sim.export_options(tmp_path / "port.toml")
    jsim2 = JSimulator(JRobot(jmake_pendulum()))
    jsim2.import_options(tmp_path / "port.toml")
    mine = dataclasses.asdict(got)
    for k, x in dataclasses.asdict(jsim2.engine.options).items():
        if k == "contacts":
            for c, y in x.items():
                assert float(y) == pytest.approx(mine[k][c], rel=1e-7), c
        elif k != "constraint_solver":
            assert x == mine[k], k


def test_trajectory_interpolates_on_the_group():
    rng = np.random.default_rng(1)
    with jax.enable_x64(True):
        jtree = jmake_anymal().tree
        tree = port_tree(jtree, torch.float64)
        T = 5
        times = np.linspace(0.0, 0.4, T)
        qs = np.tile(np.asarray(tree.neutral_q(), np.float64), (T, 1))
        qs[:, :3] = rng.normal(size=(T, 3))
        quat = rng.normal(size=(T, 4))
        qs[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        qs[:, 7:] = rng.uniform(-0.5, 0.5, (T, 12))
        vs = rng.normal(size=(T, tree.nv))
        traj, jtraj = Trajectory(tree, times, qs, vs), JTrajectory(jtree, times, qs, vs)
        for t in (-0.1, 0.0, 0.037, 0.1, 0.2513, 0.4, 0.5):
            q, v = traj.at(t)
            jq, jv = jtraj.at(t)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-9, rtol=0)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-9, rtol=0)
        assert traj.duration == jtraj.duration and len(traj) == len(jtraj) == T
        # from a log's q.* / v.* columns
        cols = {"time": times.astype(np.float32)}
        cols.update({f"q.{i}": qs[:, i].astype(np.float32) for i in range(tree.nq)})
        cols.update({f"v.{i}": vs[:, i].astype(np.float32) for i in range(tree.nv)})
        a = Trajectory.from_log(tree, TelemetryLog(columns=cols))
        b = JTrajectory.from_log(jtree, JLog(columns=cols))
        for x, y in ((a.times, b.times), (a.qs, b.qs), (a.vs, b.vs)):
            np.testing.assert_array_equal(x, y)
        with pytest.raises(KeyError):
            Trajectory.from_log(tree, TelemetryLog(columns={"time": cols["time"]}))
