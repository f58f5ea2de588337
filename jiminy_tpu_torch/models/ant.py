"""Ant: an 8-DoF quadruped with splayed legs, the classic RL benchmark.

Counterpart of ``jiminy_tpu/models/ant.py``, built with the port's
:class:`~jiminy_tpu_torch.core.tree.TreeBuilder` in the reference's
order: a FREE torso and four diagonal legs, each a hip about z at the
torso's rim and a knee about the leg's horizontal normal, a contact
point at each lower leg's tip. ``tests/test_torch_ant_spotmicro.py``
holds the tree, motors, sensors and stand pose against the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.engine.contact import contact_points_world
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite, encoder_spec, imu_spec

_UPPER = 0.2
_LOWER = 0.4
_KNEE_DOWN = 0.9  # the lower leg slopes down by this angle at the stand pose


def make_ant(
    sensor_period: float = 0.005, device="cuda", dtype=torch.float32,
) -> tuple[KinematicTree, Motors, SensorSuite, np.ndarray]:
    """(tree, motors, sensors, stand pose (nq,) numpy float32) of the Ant:
    8 motors (effort 10, velocity 20, dry friction 0.05, viscous 0.02),
    an IMU on the torso frame and the 8 encoders sampled every
    ``sensor_period`` s. The stand pose bends each knee by 0.9 rad and
    sets the torso 2 mm above the lowest foot, from the port's own FK in
    float32."""
    from jiminy_tpu_torch import resolve_device

    dev = resolve_device(device)
    b = TreeBuilder()
    torso = b.add_body("torso", -1, JointType.FREE, mass=1.5,
                       inertia=np.diag([0.02, 0.02, 0.03]), joint_name="root_joint")
    b.add_frame("torso_frame", torso)
    legs = {"fl": 45.0, "fr": -45.0, "bl": 135.0, "br": -135.0}
    motor_joints = []
    for name, deg in legs.items():
        a = np.deg2rad(deg)
        dir_xy = np.array([np.cos(a), np.sin(a), 0.0], np.float32)
        hip = b.add_body(
            f"{name}_upper", torso, JointType.REVOLUTE,
            placement=TreeBuilder.make_placement(pos=0.12 * dir_xy, rpy=(0, 0, a)),
            axis=(0, 0, 1), mass=0.2, com=(_UPPER / 2, 0, 0),
            inertia=np.diag([1e-4, 0.2 * _UPPER**2 / 12, 0.2 * _UPPER**2 / 12]),
            joint_name=f"{name}_hip", q_limits=(-0.6, 0.6), u_max=10.0, v_max=20.0, damping=0.05,
        )
        lower = b.add_body(
            f"{name}_lower", hip, JointType.REVOLUTE,
            placement=TreeBuilder.make_placement(pos=(_UPPER, 0, 0)),
            axis=(0, 1, 0), mass=0.2, com=(_LOWER / 2, 0, 0),
            inertia=np.diag([1e-4, 0.2 * _LOWER**2 / 12, 0.2 * _LOWER**2 / 12]),
            joint_name=f"{name}_knee", q_limits=(0.25, 1.4), u_max=10.0, v_max=20.0,
            damping=0.05,
        )
        b.add_contact_point(f"{name}_tip", lower, (_LOWER, 0, 0))
        motor_joints += [f"{name}_hip", f"{name}_knee"]
    tree = b.build(device="cpu", dtype=torch.float32)  # the stand pose's FK in float32

    q = np.zeros(tree.nq, np.float32)
    q[6] = 1.0
    for name in legs:
        q[tree.q_off[tree.joint_index(f"{name}_knee")]] = _KNEE_DOWN
    qt = torch.as_tensor(q)[None]
    xw, vel = algos.kinematics(tree, qt, torch.zeros(1, tree.nv))
    pts, _ = contact_points_world(tree, xw, vel)
    q[2] = -float(torch.min(pts[0, :, 2])) + 0.002

    joints = [tree.joint_index(j) for j in motor_joints]
    motors = Motors.create(
        [tree.v_off[j] for j in joints], q_idx=[tree.q_off[j] for j in joints],
        names=motor_joints, effort_limit=10.0, velocity_limit=20.0, friction_dry=0.05,
        friction_viscous=0.02, device=dev, dtype=dtype,
    )
    tree = tree.to(device=dev, dtype=dtype)
    sensors = SensorSuite.build(
        tree, [imu_spec("torso_frame")] + [encoder_spec(j) for j in motor_joints], sensor_period,
    )
    return tree, motors, sensors, q
