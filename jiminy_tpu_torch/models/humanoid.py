"""The Atlas-class humanoid.

Counterpart of ``jiminy_tpu/models/humanoid.py``. The reference writes
the robot as URDF text from its :class:`HumanoidParams` and runs it
through its URDF parser and hardware pipeline; the port builds the same
tree directly (:func:`make_atlas`), in the order that parser visits it
(depth-first from the pelvis, the joints of a link in document order,
the last-pushed link first), then the hardware description's pieces in
the pipeline's order: the flexibility joint, the sole contact points
(``contactPoints`` on the foot links), the motors' armature, the motor
bank and the sensor suite (the pelvis IMU, 23 encoders, 23 effort
sensors). ``tests/test_torch_atlas.py`` holds the tree, motors, sensors,
stand pose and self-collision pairs field for field against the
reference's. :func:`humanoid_urdf` writes the reference's URDF text, which
``robot.build_robot`` parses (``tests/test_torch_urdf.py``).

Morphology (23 actuated DoF): pelvis (floating) → torso (yaw, pitch,
roll); per leg {l, r}: hip yaw, roll, pitch, knee, ankle pitch, roll; per
arm {l, r}: shoulder pitch, roll, elbow pitch, wrist yaw. Each foot is
the body of its ankle roll with four sole-corner contact points: nb 24,
nq 30, nv 29, 8 contact points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite
from jiminy_tpu_torch.models.quadruped import _box_inertia
from jiminy_tpu_torch.robot import sensor_specs


@dataclasses.dataclass(frozen=True)
class HumanoidParams:
    name: str = "atlas"
    pelvis_mass: float = 12.0
    torso_mass: float = 25.0
    hip_mass: float = 2.5
    thigh_mass: float = 5.0
    shank_mass: float = 3.0
    foot_mass: float = 1.5
    upper_arm_mass: float = 2.5
    lower_arm_mass: float = 1.5
    hip_y: float = 0.11
    thigh_len: float = 0.40
    shank_len: float = 0.40
    ankle_h: float = 0.08
    foot_len: float = 0.24
    foot_w: float = 0.12
    shoulder_y: float = 0.25
    torso_h: float = 0.45
    upper_arm_len: float = 0.30
    lower_arm_len: float = 0.30
    leg_effort: float = 250.0
    arm_effort: float = 90.0
    velocity: float = 12.0
    armature: float = 0.15


ATLAS = HumanoidParams()


def _joint_names() -> list[str]:
    """The 23 actuated joints in the hardware description's order."""
    joints = ["back_bkz", "back_bky", "back_bkx"]
    for side in ("l", "r"):
        joints += [f"{side}_leg_{j}" for j in ("hpz", "hpx", "hpy", "kny", "aky", "akx")]
        joints += [f"{side}_arm_{j}" for j in ("shy", "shx", "ely", "wrz")]
    return joints


def _links_and_joints(p: HumanoidParams):
    """The URDF's links {name: (mass, com, diag inertia)} and joints
    [(name, parent, child, xyz, axis, lower, upper, effort)] in document
    order (every joint revolute)."""
    links = {
        "pelvis": (p.pelvis_mass, (0, 0, 0), _box_inertia(p.pelvis_mass, 0.25, 0.3, 0.2)),
        "torso_yaw_l": (0.5, (0, 0, 0), _box_inertia(0.5, 0.1, 0.1, 0.1)),
        "torso_pitch_l": (0.5, (0, 0, 0), _box_inertia(0.5, 0.1, 0.1, 0.1)),
        "torso": (p.torso_mass, (0, 0, p.torso_h / 2),
                  _box_inertia(p.torso_mass, 0.3, 0.35, p.torso_h)),
    }
    joints = [
        ("back_bkz", "pelvis", "torso_yaw_l", (0, 0, 0.1), (0, 0, 1), -0.7, 0.7, p.leg_effort),
        ("back_bky", "torso_yaw_l", "torso_pitch_l", (0, 0, 0), (0, 1, 0), -0.5, 0.6,
         p.leg_effort),
        ("back_bkx", "torso_pitch_l", "torso", (0, 0, 0), (1, 0, 0), -0.5, 0.5, p.leg_effort),
    ]
    for side, s in (("l", 1), ("r", -1)):
        hipy, hipr, thigh = f"{side}_hip_yaw_l", f"{side}_hip_roll_l", f"{side}_thigh"
        shank, anklep, foot = f"{side}_shank", f"{side}_ankle_l", f"{side}_foot"
        links[hipy] = (0.8, (0, 0, 0), _box_inertia(0.8, 0.1, 0.1, 0.1))
        links[hipr] = (p.hip_mass, (0, 0, 0), _box_inertia(p.hip_mass, 0.12, 0.12, 0.12))
        links[thigh] = (p.thigh_mass, (0, 0, -p.thigh_len / 2),
                        _box_inertia(p.thigh_mass, 0.08, 0.08, p.thigh_len))
        links[shank] = (p.shank_mass, (0, 0, -p.shank_len / 2),
                        _box_inertia(p.shank_mass, 0.06, 0.06, p.shank_len))
        links[anklep] = (0.3, (0, 0, 0), _box_inertia(0.3, 0.05, 0.05, 0.05))
        links[foot] = (p.foot_mass, (0.03, 0, -p.ankle_h / 2),
                       _box_inertia(p.foot_mass, p.foot_len, p.foot_w, p.ankle_h))
        leg = p.leg_effort
        joints += [
            (f"{side}_leg_hpz", "pelvis", hipy, (0, s * p.hip_y, -0.1), (0, 0, 1), -0.8, 0.8, leg),
            (f"{side}_leg_hpx", hipy, hipr, (0, 0, 0), (1, 0, 0), -0.6, 0.6, leg),
            (f"{side}_leg_hpy", hipr, thigh, (0, 0, 0), (0, 1, 0), -1.8, 0.6, leg),
            (f"{side}_leg_kny", thigh, shank, (0, 0, -p.thigh_len), (0, 1, 0), 0.0, 2.4, leg),
            (f"{side}_leg_aky", shank, anklep, (0, 0, -p.shank_len), (0, 1, 0), -1.0, 0.8, leg),
            (f"{side}_leg_akx", anklep, foot, (0, 0, 0), (1, 0, 0), -0.6, 0.6, leg),
        ]
        shp, shr = f"{side}_shoulder_p_l", f"{side}_upper_arm"
        elb, wrist = f"{side}_lower_arm", f"{side}_hand"
        links[shp] = (0.5, (0, 0, 0), _box_inertia(0.5, 0.08, 0.08, 0.08))
        links[shr] = (p.upper_arm_mass, (0, 0, -p.upper_arm_len / 2),
                      _box_inertia(p.upper_arm_mass, 0.06, 0.06, p.upper_arm_len))
        links[elb] = (p.lower_arm_mass, (0, 0, -p.lower_arm_len / 2),
                      _box_inertia(p.lower_arm_mass, 0.05, 0.05, p.lower_arm_len))
        links[wrist] = (0.5, (0, 0, 0), _box_inertia(0.5, 0.06, 0.06, 0.06))
        arm = p.arm_effort
        joints += [
            (f"{side}_arm_shy", "torso", shp, (0, s * p.shoulder_y, p.torso_h - 0.05), (0, 1, 0),
             -2.0, 2.0, arm),
            (f"{side}_arm_shx", shp, shr, (0, 0, 0), (1, 0, 0), -1.6, 1.6, arm),
            (f"{side}_arm_ely", shr, elb, (0, 0, -p.upper_arm_len), (0, 1, 0), -2.4, 0.0, arm),
            (f"{side}_arm_wrz", elb, wrist, (0, 0, -p.lower_arm_len), (0, 0, 1), -1.6, 1.6, arm),
        ]
    return links, joints


def humanoid_urdf(p: HumanoidParams = ATLAS) -> str:
    """The humanoid of ``p`` as URDF text, the reference's document to the
    character: the pelvis and the torso chain's links, the three back
    joints, then per side the leg's six links and joints and the arm's
    four links and joints."""
    links, joints = _links_and_joints(p)

    def link(name):
        mass, com, (ixx, iyy, izz) = links[name]
        return (f'  <link name="{name}"><inertial>'
                f'<origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>'
                f'<mass value="{mass}"/>'
                f'<inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" iyz="0" '
                f'izz="{izz}"/></inertial></link>')

    def joint(name, parent, child, xyz, axis, lo, hi, effort):
        return (f'  <joint name="{name}" type="revolute">'
                f'<origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="0 0 0"/>'
                f'<parent link="{parent}"/><child link="{child}"/>'
                f'<axis xyz="{" ".join(map(str, axis))}"/>'
                f'<limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="{p.velocity}"/>'
                f"</joint>")

    names = list(links)
    out = [f'<robot name="{p.name}">', *map(link, names[:4]), *(joint(*j) for j in joints[:3])]
    for s in range(2):  # per side: the leg's links and joints, then the arm's
        ln, jn = names[4 + 10 * s:14 + 10 * s], joints[3 + 10 * s:13 + 10 * s]
        out += [*map(link, ln[:6]), *(joint(*j) for j in jn[:6]),
                *map(link, ln[6:]), *(joint(*j) for j in jn[6:])]
    out.append("</robot>")
    return "\n".join(out)


def humanoid_hardware(
    p: HumanoidParams = ATLAS,
    sensor_delay: float = 0.0,
    imu_noise: float = 0.0,
    encoder_noise: float = 0.0,
    flexibility: bool = False,
) -> dict:
    """Motors, encoders and effort sensors on every joint, the IMU on the
    pelvis, the sole-corner contact points (the reference's hardware
    description, same schema as a ``*_hardware.toml``); with
    ``flexibility`` a 3-DoF flexibility joint at the torso (stiffness
    8000, damping 40, inertia 1e-3)."""
    joints = _joint_names()
    motors = {
        j: {
            "joint_name": j,
            "armature": p.armature,
            "frictionDry": 0.5,
            "frictionViscous": 0.1,
            "effortLimit": p.leg_effort if "_leg_" in j or "back" in j else p.arm_effort,
            "velocityLimit": p.velocity,
        }
        for j in joints
    }
    encoders = {j: {"joint_name": j, "delay": sensor_delay, "noiseStd": encoder_noise}
                for j in joints}
    efforts = {j: {"motor_name": j} for j in joints}
    contacts = {}
    for side in ("l", "r"):
        corners = [(cx, cy) for cx in (-p.foot_len / 2 + 0.03, p.foot_len / 2 + 0.03)
                   for cy in (-p.foot_w / 2, p.foot_w / 2)]
        for i, (cx, cy) in enumerate(corners):
            contacts[f"{side}_foot_corner{i}"] = {"frame_name": f"{side}_foot",
                                                  "pos": [cx, cy, -p.ankle_h]}
    hw_flex = {}
    if flexibility:
        hw_flex = {"Flexibility": {"torso_flex": {
            "joint_name": "back_bkz", "stiffness": 8000.0, "damping": 40.0, "inertia": 1e-3,
        }}}
    return {
        **hw_flex,
        "Global": {"contactFrameNames": [], "contactPoints": contacts},
        "Motor": {"SimpleMotor": motors},
        "Sensor": {
            "ImuSensor": {
                "pelvis_imu": {"frame_name": "pelvis_frame", "delay": sensor_delay,
                               "noiseStd": imu_noise}
            },
            "EncoderSensor": encoders,
            "EffortSensor": efforts,
        },
    }


def atlas_self_collision_pairs(p: HumanoidParams = ATLAS, leg_radius: float = 0.06,
                               arm_radius: float = 0.05) -> tuple[CollisionPair, ...]:
    """The humanoid's declared self-collision pairs: the left against the
    right thigh and shank capsules (the legs of a collapsing gait cross),
    and each lower arm's capsule against the torso box (its exact SDF
    against 5 points along the arm). 12 pair contacts: inside the
    whole-substep kernels' 24."""

    def leg_seg(side, link, length):
        return Capsule(f"{side}_{link}", (0.0, 0.0, 0.0), (0.0, 0.0, -length), leg_radius)

    torso = Box("torso", (0.0, 0.0, p.torso_h / 2), (0.16, 0.18, p.torso_h / 2))
    pairs = [
        CollisionPair(leg_seg("l", "thigh", p.thigh_len), leg_seg("r", "thigh", p.thigh_len)),
        CollisionPair(leg_seg("l", "shank", p.shank_len), leg_seg("r", "shank", p.shank_len)),
    ]
    for side in ("l", "r"):
        arm = Capsule(f"{side}_lower_arm", (0.0, 0.0, 0.0), (0.0, 0.0, -p.lower_arm_len),
                      arm_radius)
        pairs.append(CollisionPair(arm, torso))
    return tuple(pairs)


def make_atlas(
    device="cuda",
    dtype=torch.float32,
    sensor_period: float = 0.0025,
    sensor_delay: float = 0.0,
    imu_noise: float = 0.0,
    encoder_noise: float = 0.0,
    flexibility: bool = False,
) -> tuple[KinematicTree, Motors, SensorSuite]:
    """(tree, motors, sensors) of the humanoid. The sensors, sampled every
    ``sensor_period`` s: the pelvis IMU and the 23 encoders
    (``sensor_delay``; Gaussian noise of std ``imu_noise`` and
    ``encoder_noise``), then the 23 effort sensors (no delay, no noise).
    ``flexibility``: :func:`humanoid_hardware`'s torso flexibility joint
    (the reference's ``make_atlas`` builds without it)."""
    hw = humanoid_hardware(ATLAS, sensor_delay, imu_noise, encoder_noise, flexibility)
    links, joints = _links_and_joints(ATLAS)
    b = TreeBuilder()
    m, com, ine = links["pelvis"]
    root = b.add_body("pelvis", -1, JointType.FREE, mass=m, com=com, inertia=ine,
                      joint_name="root_joint")
    b.add_frame("pelvis_frame", root)
    body_of = {"pelvis": root}
    children = {}
    for j in joints:
        children.setdefault(j[1], []).append(j)
    stack = ["pelvis"]
    while stack:
        parent_link = stack.pop()
        for name, _, child, xyz, axis, lo, hi, effort in children.get(parent_link, []):
            m, com, ine = links[child]
            body_of[child] = b.add_body(
                child, body_of[parent_link], JointType.REVOLUTE,
                placement=TreeBuilder.make_placement(xyz), axis=axis, mass=m, com=com,
                inertia=ine, joint_name=name, q_limits=(lo, hi), u_max=effort,
                v_max=ATLAS.velocity,
            )
            b.add_frame(child + "_frame", body_of[child])
            stack.append(child)

    for cfg in hw.get("Flexibility", {}).values():
        b.insert_flexibility(cfg["joint_name"], stiffness=cfg["stiffness"],
                             damping=cfg["damping"], inertia=cfg["inertia"])
    for cname, cfg in hw["Global"]["contactPoints"].items():
        b.add_contact_point(cname, b.body_name.index(cfg["frame_name"]), cfg["pos"])
    cfgs = hw["Motor"]["SimpleMotor"]
    for cfg in cfgs.values():
        b.armature[b.joint_name.index(cfg["joint_name"])][:] = cfg["armature"]
    tree = b.build(device=device, dtype=dtype)

    joint_ids = [tree.joint_index(c["joint_name"]) for c in cfgs.values()]
    motors = Motors.create(
        v_idx=[tree.v_off[j] for j in joint_ids],
        q_idx=[tree.q_off[j] for j in joint_ids],
        names=list(cfgs),
        reduction=[c.get("mechanicalReduction", 1.0) for c in cfgs.values()],
        effort_limit=[c["effortLimit"] for c in cfgs.values()],
        velocity_limit=[c["velocityLimit"] for c in cfgs.values()],
        friction_dry=[c["frictionDry"] for c in cfgs.values()],
        friction_viscous=[c["frictionViscous"] for c in cfgs.values()],
        device=device,
        dtype=dtype,
    )
    return tree, motors, SensorSuite.build(tree, sensor_specs(hw), sensor_period)


def atlas_stand_q(tree: KinematicTree) -> np.ndarray:
    """Stand with slightly bent knees and matching hip and ankle pitch,
    the shoulders rolled in against the torso and the elbows bent; numpy
    float32 (nq,)."""
    p = ATLAS
    knee = 0.35
    hip = -knee / 2
    ankle = -knee / 2
    q = tree.neutral_q().astype(np.float32)
    height = 0.1 + p.thigh_len * np.cos(hip) + p.shank_len * np.cos(hip + knee) + p.ankle_h
    q[2] = height + 0.005
    for side in ("l", "r"):
        q[tree.q_off[tree.joint_index(f"{side}_leg_hpy")]] = hip
        q[tree.q_off[tree.joint_index(f"{side}_leg_kny")]] = knee
        q[tree.q_off[tree.joint_index(f"{side}_leg_aky")]] = ankle
        q[tree.q_off[tree.joint_index(f"{side}_arm_shx")]] = -0.2 if side == "l" else 0.2
        q[tree.q_off[tree.joint_index(f"{side}_arm_ely")]] = -0.5
    return q
