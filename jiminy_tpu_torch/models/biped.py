"""Cassie-class biped — closed kinematic loops and passive leg springs.

Counterpart of ``jiminy_tpu/models/biped.py``, built by the port itself
in the same body order with the same constants, so that
``tests/test_torch_cassie.py`` can hold the tree, the pushrod constraints
and the stand pose field for field against the reference's.

Morphology per leg (simplified Cassie): hip roll, yaw, pitch (motors) →
thigh → knee (motor) → shin upper → shin spring (a passive 1-DoF spring
of 1500 N·m/rad) → shin → tarsus (passive) → toe (motor) → foot (two
contact points). A rigid pushrod (a :class:`DistanceConstraint`) ties the
thigh to the tarsus, so knee motion drives the tarsus through the loop.
:func:`cassie_self_collision_pairs` declares the legs' self-collision
pairs (left against right thigh, shin and tarsus capsules).
``flexibility=True`` inserts a 3-DoF SPHERICAL flexibility joint (a
spring-damper toward the identity, −k·log(quat)) upstream of each hip
roll and mounts an IMU on each hip-roll body, below it.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.engine.collision import Capsule, CollisionPair
from jiminy_tpu_torch.engine.constraints import DistanceConstraint
from jiminy_tpu_torch.engine.contact import contact_points_world
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite, encoder_spec, imu_spec

# geometry (m)
_HIP_Y = 0.13
_THIGH = 0.35
_SHIN_UP = 0.06
_SHIN = 0.30
_TARSUS = 0.35
_FOOT_HALF = 0.09
# nominal pose of the pitch joints (rad)
_STAND = {"hip_pitch": -0.25, "knee": 0.55, "shin_spring": 0.0, "tarsus": -0.35, "toe": 0.05}
MOTOR_JOINTS = tuple(
    f"{side}_{j}" for side in ("L", "R") for j in ("hip_roll", "hip_yaw", "hip_pitch", "knee", "toe")
)


def _build_tree(device, dtype, flexibility=False, flex_stiffness=600.0,
                flex_damping=5.0) -> tuple[KinematicTree, dict]:
    """The tree and each side's pushrod frames (thigh, tarsus); with
    ``flexibility`` the hip IMU frames and the two flexibility joints."""
    place = TreeBuilder.make_placement
    b = TreeBuilder()
    pelvis = b.add_body("pelvis", -1, JointType.FREE, mass=10.0, inertia=np.diag([0.1] * 3),
                        joint_name="root_joint")
    b.add_frame("pelvis_frame", pelvis)
    rod_frames = {}
    for side, s in (("L", 1), ("R", -1)):
        hip_r = b.add_body(
            f"{side}_hip_roll", pelvis, JointType.REVOLUTE, placement=place((0, s * _HIP_Y, -0.05)),
            axis=(1, 0, 0), mass=0.8, inertia=np.diag([2e-3] * 3), joint_name=f"{side}_hip_roll",
            q_limits=(-0.4, 0.4), u_max=80.0, v_max=12.0,
        )
        hip_y = b.add_body(
            f"{side}_hip_yaw", hip_r, JointType.REVOLUTE, axis=(0, 0, 1), mass=0.8,
            inertia=np.diag([2e-3] * 3), joint_name=f"{side}_hip_yaw", q_limits=(-0.4, 0.4),
            u_max=80.0, v_max=12.0,
        )
        thigh = b.add_body(
            f"{side}_thigh", hip_y, JointType.REVOLUTE, axis=(0, 1, 0), mass=3.0,
            com=(0, 0, -_THIGH / 2), inertia=np.diag([3.0 * _THIGH**2 / 12] * 2 + [1e-3]),
            joint_name=f"{side}_hip_pitch", q_limits=(-1.5, 1.2), u_max=120.0, v_max=12.0,
        )
        shin_up = b.add_body(
            f"{side}_shin_upper", thigh, JointType.REVOLUTE, placement=place((0, 0, -_THIGH)),
            axis=(0, 1, 0), mass=0.6, com=(0, 0, -_SHIN_UP / 2), inertia=np.diag([2e-3] * 3),
            joint_name=f"{side}_knee", q_limits=(-0.3, 2.2), u_max=120.0, v_max=12.0,
        )
        shin = b.add_body(
            f"{side}_shin", shin_up, JointType.REVOLUTE, placement=place((0, 0, -_SHIN_UP)),
            axis=(0, 1, 0), mass=0.6, com=(0, 0, -_SHIN / 2),
            inertia=np.diag([0.6 * _SHIN**2 / 12] * 2 + [5e-4]),
            joint_name=f"{side}_shin_spring", q_limits=(-0.35, 0.35), stiffness=1500.0,
            damping=3.0,
        )
        tarsus = b.add_body(
            f"{side}_tarsus", shin, JointType.REVOLUTE, placement=place((0, 0, -_SHIN)),
            axis=(0, 1, 0), mass=0.8, com=(0, 0, -_TARSUS / 2),
            inertia=np.diag([0.8 * _TARSUS**2 / 12] * 2 + [5e-4]),
            joint_name=f"{side}_tarsus", q_limits=(-1.6, 0.3), damping=0.2,
        )
        foot = b.add_body(
            f"{side}_foot", tarsus, JointType.REVOLUTE, placement=place((0, 0, -_TARSUS)),
            axis=(0, 1, 0), mass=0.3, inertia=np.diag([1e-3] * 3), joint_name=f"{side}_toe",
            q_limits=(-1.0, 1.0), u_max=40.0, v_max=12.0,
        )
        # pushrod attachment frames: the thigh near the knee ↔ mid-tarsus
        rod_frames[side] = (
            b.add_frame(f"{side}_rod_thigh", thigh, place((0.03, 0, -_THIGH + 0.05))),
            b.add_frame(f"{side}_rod_tarsus", tarsus, place((0.03, 0, -0.12))),
        )
        b.add_contact_point(f"{side}_toe_front", foot, (_FOOT_HALF, 0, -0.02))
        b.add_contact_point(f"{side}_toe_back", foot, (-_FOOT_HALF, 0, -0.02))
        if flexibility:  # an IMU on the hip, below its flexibility joint
            b.add_frame(f"{side}_hip_imu", hip_r)
    if flexibility:
        for side in ("L", "R"):
            b.insert_flexibility(f"{side}_hip_roll", stiffness=flex_stiffness,
                                 damping=flex_damping, inertia=1e-3)
    return b.build(device=device, dtype=dtype), rod_frames


def cassie_self_collision_pairs(radius: float = 0.04) -> tuple[CollisionPair, ...]:
    """The legs' declared self-collision pairs: the left against the right
    thigh, shin and tarsus, each a capsule of ``radius`` along its body's
    −z axis over the segment's length (the segments that cross first when
    a gait collapses inward)."""

    def seg(side, body, length):
        return Capsule(f"{side}_{body}", (0.0, 0.0, 0.0), (0.0, 0.0, -length), radius)

    return tuple(
        CollisionPair(seg("L", body, length), seg("R", body, length))
        for body, length in (("thigh", _THIGH), ("shin", _SHIN), ("tarsus", _TARSUS))
    )


def make_cassie(
    sensor_period: float = 0.0025,
    sensor_delay: float = 0.0,
    imu_noise: float = 0.0,
    encoder_noise: float = 0.0,
    flexibility: bool = False,
    flex_stiffness: float = 600.0,
    flex_damping: float = 5.0,
    device="cuda",
    dtype=torch.float32,
) -> tuple[KinematicTree, Motors, SensorSuite, tuple, np.ndarray]:
    """(tree, motors, sensors, constraints, stand_q) of the biped:
    ``constraints`` the two pushrod distance constraints (their
    lengths measured at the stand pose, where the loops close), ``stand_q``
    the nominal configuration (nq,) as numpy float32 with the base raised
    so that the lowest toe point sits 2 mm above z = 0. The sensors,
    sampled every ``sensor_period`` s: one IMU on the pelvis and the 10
    motor joints' encoders (``sensor_delay``; Gaussian noise of std
    ``imu_noise`` and ``encoder_noise``). With ``flexibility`` a SPHERICAL
    flexibility joint of stiffness ``flex_stiffness`` and damping
    ``flex_damping`` per axis (inertia 1e-3) above each hip roll, and an
    IMU on each hip-roll body after the encoders (the suite's IMU group:
    pelvis, L hip, R hip). The stand pose and the rod lengths are computed
    in float32, as the reference computes them."""
    tree, rod_frames = _build_tree(device, dtype, flexibility, flex_stiffness, flex_damping)
    t32 = tree.to(dtype=torch.float32)
    q = tree.neutral_q()  # identity quaternions: the base and the flexibility joints
    for side in ("L", "R"):
        for key, value in _STAND.items():
            q[tree.q_off[tree.joint_index(f"{side}_{key}")]] = value

    def kin(qq):
        qt = torch.as_tensor(qq, device=t32.device)[None]
        return algos.kinematics(t32, qt, torch.zeros(1, tree.nv, device=t32.device))

    xw, vel = kin(q)
    pts, _ = contact_points_world(t32, xw, vel)
    q[2] = -float(pts[0, :, 2].min()) + 0.002
    xw, _ = kin(q)
    constraints = []
    for side in ("L", "R"):
        f1, f2 = rod_frames[side]
        c = DistanceConstraint(frame1=f1, frame2=f2)
        p1, p2 = c.points(t32, xw, xw[0].pos)
        d = float(torch.linalg.vector_norm(p1 - p2, dim=-1)[0])
        constraints.append(DistanceConstraint(frame1=f1, frame2=f2, distance=d,
                                              baumgarte_freq=20.0))
    v_idx = [tree.v_off[tree.joint_index(j)] for j in MOTOR_JOINTS]
    q_idx = [tree.q_off[tree.joint_index(j)] for j in MOTOR_JOINTS]
    motors = Motors.create(
        v_idx, q_idx=q_idx, names=MOTOR_JOINTS, effort_limit=[float(tree.u_max[i]) for i in v_idx],
        velocity_limit=12.0, friction_dry=0.3, friction_viscous=0.1, device=device, dtype=dtype,
    )
    specs = [imu_spec("pelvis_frame", delay=sensor_delay, noise_std=imu_noise)] + [
        encoder_spec(j, delay=sensor_delay, noise_std=encoder_noise) for j in MOTOR_JOINTS
    ]
    if flexibility:
        specs += [imu_spec(f"{side}_hip_imu", delay=sensor_delay, noise_std=imu_noise)
                  for side in ("L", "R")]
    sensors = SensorSuite.build(tree, specs, sensor_period)
    return tree, motors, sensors, tuple(constraints), q
