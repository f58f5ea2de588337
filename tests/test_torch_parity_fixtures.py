"""Parity-fixture replay through the port's engine (ROADMAP A.5).

``parity/fixtures/anymal_drop_euler`` (ANYmal dropped from the origin,
1 ms impulse substeps, 16 PGS sweeps, 0.5 s) and ``ball_drop_impact``
(a point-contact ball against the exact discrete closed form) are
replayed in float64 on the CPU with the recorded ``traj.npz`` as it is,
and held to each fixture's own tolerances, as ``jiminy_tpu/parity.py``
``compare`` holds the reference. The models cross from the reference's
URDF/hardware pipeline through ``tree_from_arrays`` and
``motors_from_arrays``; the command is zero, as in ``compare``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jiminy_tpu.robot import build_robot
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine.engine import Engine, EngineOptions
from jiminy_tpu_torch.hardware.motors import motors_from_arrays

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "parity" / "fixtures"
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)


def _replay(name: str, solver: str):
    fix = FIXTURES / name
    meta = json.loads((fix / "meta.json").read_text())
    robot = build_robot(
        fix / "robot.urdf", hardware=str(fix / "hardware.toml"),
        freeflyer=bool(meta["freeflyer"]),
    )
    f64 = dict(device="cpu", dtype=torch.float64)
    tree = tree_from_arrays(
        {k: np.asarray(getattr(robot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, **f64
    )
    motors = None
    if robot.motors is not None:
        motors = motors_from_arrays(
            {k: np.asarray(getattr(robot.motors, k)) for k in MOTOR_FIELDS}, **f64
        )
    opts = EngineOptions(**meta["engine_options"], constraint_solver=solver)
    engine = Engine(tree, opts, motors=motors, device="cpu")
    data = np.load(fix / "traj.npz")
    idx = np.rint(data["t"] / opts.dt).astype(int)
    assert np.allclose(idx * opts.dt, data["t"], atol=1e-9)
    state = engine.reset(torch.as_tensor(data["q"][:1]), torch.as_tensor(data["v"][:1]))
    u = torch.zeros(1, motors.nm if motors is not None else tree.nv, dtype=torch.float64)
    qs, vs = [state.q[0].numpy()], [state.v[0].numpy()]
    for _ in range(int(idx.max())):
        state = engine.step(state, u, n_substeps=1)
        qs.append(state.q[0].numpy())
        vs.append(state.v[0].numpy())
    dq = np.abs(np.asarray(qs)[idx] - data["q"]).max()
    dv = np.abs(np.asarray(vs)[idx] - data["v"]).max()
    return dq, dv, meta


@pytest.mark.parametrize(
    "name, solver",
    [
        ("anymal_drop_euler", "kernel"),
        ("ball_drop_impact", "kernel"),
        ("ball_drop_impact", "inline"),
    ],
)
def test_fixture_replay_within_tolerance(name, solver):
    dq, dv, meta = _replay(name, solver)
    assert dq <= meta["tolerance_q"], (dq, meta["tolerance_q"])
    assert dv <= meta["tolerance_v"], (dv, meta["tolerance_v"])
