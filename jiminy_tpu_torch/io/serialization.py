"""Robot serialization: the whole robot as JSON in a log's constants.

Counterpart of ``jiminy_tpu/io/serialization.py``. The tree's topology
and its arrays (as float32 lists), the motor bank and the sensor suite
go into one JSON string; :func:`robot_to_json` writes the reference's
string for the same robot, character for character, so a log written by
either package rebuilds its robot in the other
(:func:`build_robot_from_log`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, JointType, KinematicTree
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorGroup, SensorSuite
from jiminy_tpu_torch.robot import Robot

_MOTOR_PARAMS = ("reduction", "effort_limit", "velocity_limit", "friction_dry",
                 "friction_viscous", "friction_vel_eps")


def _f32_list(x) -> list:
    """A tensor or array as nested lists of float32 values, as the
    reference stores them."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).tolist()


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), dtype=dtype, device=device)


def tree_to_dict(tree: KinematicTree) -> dict:
    d = {}
    for k in STATIC_FIELDS:
        v = getattr(tree, k)
        if k == "joint_type":
            v = [int(t) for t in v]
        d[k] = list(v) if isinstance(v, tuple) else v
    for k in ARRAY_FIELDS:
        d[k] = _f32_list(getattr(tree, k))
    return d


def tree_from_dict(d: dict, device="cuda", dtype=torch.float32) -> KinematicTree:
    from jiminy_tpu_torch import resolve_device

    dev = resolve_device(device)
    kwargs = {}
    for k in STATIC_FIELDS:
        v = d[k]
        if k == "joint_type":
            v = tuple(JointType(t) for t in v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    for k in ARRAY_FIELDS:
        if k == "contact_radius" and k not in d:  # logs older than sphere sites
            kwargs[k] = torch.zeros(len(d["contact_body"]), dtype=dtype, device=dev)
            continue
        kwargs[k] = _tensor(d[k], dev, dtype)
    return KinematicTree(**kwargs)


def motors_to_dict(m: Motors) -> dict:
    return {"v_idx": list(m.v_idx), "q_idx": list(m.q_idx), "name": list(m.name),
            **{k: _f32_list(getattr(m, k)) for k in _MOTOR_PARAMS}}


def motors_from_dict(d: dict, device="cuda", dtype=torch.float32) -> Motors:
    return Motors.create(d["v_idx"], q_idx=d["q_idx"], names=list(d["name"]),
                         **{k: np.asarray(d[k], np.float32) for k in _MOTOR_PARAMS},
                         device=device, dtype=dtype)


def sensors_to_dict(s: SensorSuite) -> dict:
    return {
        "period": s.period,
        "groups": [
            {
                "type": g.type,
                "target": list(g.target),
                "name": list(g.name),
                "buf_len": g.buf_len,
                "delay": _f32_list(g.delay),
                "bias": _f32_list(g.bias),
                "noise_std": _f32_list(g.noise_std),
            }
            for g in s.groups
        ],
    }


def sensors_from_dict(d: dict, tree: KinematicTree) -> SensorSuite:
    kw = dict(device=tree.device, dtype=tree.dtype)
    groups = [
        SensorGroup(
            type=g["type"],
            target=tuple(g["target"]),
            name=tuple(g["name"]),
            buf_len=g["buf_len"],
            delay=np.asarray(g["delay"], np.float32),
            bias=_tensor(g["bias"], **kw),
            noise_std=_tensor(g["noise_std"], **kw),
        )
        for g in d["groups"]
    ]
    return SensorSuite(tree, groups, d["period"])


def robot_to_json(robot: Robot) -> str:
    d = {"name": robot.name, "tree": tree_to_dict(robot.tree)}
    if robot.motors is not None:
        d["motors"] = motors_to_dict(robot.motors)
    if robot.sensors is not None:
        d["sensors"] = sensors_to_dict(robot.sensors)
    return json.dumps(d)


def robot_from_json(s: str, device="cuda", dtype=torch.float32) -> Robot:
    d = json.loads(s)
    tree = tree_from_dict(d["tree"], device, dtype)
    motors = motors_from_dict(d["motors"], device, dtype) if "motors" in d else None
    sensors = sensors_from_dict(d["sensors"], tree) if "sensors" in d else None
    return Robot(tree, motors=motors, sensors=sensors, name=d["name"])


def build_robot_from_log(log, device="cuda", dtype=torch.float32) -> Robot:
    """The robot embedded in a telemetry log's constants, on ``device``."""
    if "robot" not in log.constants:
        raise KeyError("log has no embedded robot serialization")
    return robot_from_json(log.constants["robot"], device, dtype)
