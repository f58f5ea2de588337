"""The quadruped family: ANYmal (the flagship) and Spotmicro.

Counterpart of ``jiminy_tpu/models/quadruped.py``. The reference writes
each robot as URDF text from its :class:`QuadrupedParams`
(:func:`quadruped_urdf`, which the port writes too, to the character)
and runs it through its URDF parser and hardware pipeline. The port
builds the bare-point-foot robots directly (:func:`make_quadruped`), in
the order that parser visits the URDF (depth-first from the base,
last-pushed leg first), with the feet fused into the shanks as fixed
frames and contact points at the foot frames, and the sensor suite from
the same hardware description. Capsule feet (``foot_radius > 0``: a
``<collision>`` capsule on each foot link, opted in through
``collisionBodyNames``, two end spheres per foot) come from the URDF
route, as in the reference: :func:`make_quadruped` then runs
``build_robot(quadruped_urdf(p), quadruped_hardware(p), freeflyer=True)``.
``tests/test_torch_model.py`` holds ANYmal's tree field for field against
``jiminy_tpu.models.make_anymal()``'s, ``tests/test_torch_sensors.py``
its suite against the reference's ``robot.sensors``,
``tests/test_torch_ant_spotmicro.py`` Spotmicro's tree, motors, sensors
and stand pose against ``make_spotmicro()``'s, and
``tests/test_torch_urdf.py`` the URDF text and the capsule-foot robot.

Morphology (12 actuated DoF): base (floating) → per leg {LF, RF, LH,
RH}: HAA (x-axis) → HFE (y) → KFE (y); feet are fixed links.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite
from jiminy_tpu_torch.robot import build_robot, sensor_specs

# leg name → (x sign, y sign)
_LEGS = {"LF": (1, 1), "RF": (1, -1), "LH": (-1, 1), "RH": (-1, -1)}


@dataclasses.dataclass(frozen=True)
class QuadrupedParams:
    """Morphology parameters. ``foot_radius > 0`` gives each foot link a
    ``<collision>`` capsule of that radius and length ``foot_len`` along
    y, which the hardware opts in through ``collisionBodyNames``: each foot
    touches the ground at its capsule's surface (two end spheres) and can
    rock and roll. 0: bare contact points (the default)."""

    name: str = "anymal"
    base_mass: float = 16.8
    base_dims: tuple = (0.53, 0.3, 0.24)
    hip_mass: float = 1.4
    thigh_mass: float = 1.1
    shank_mass: float = 0.3
    foot_mass: float = 0.1
    hip_x: float = 0.277
    hip_y: float = 0.116
    hfe_off_x: float = 0.0635
    hfe_off_y: float = 0.041
    thigh_len: float = 0.25
    shank_len: float = 0.33
    effort: float = 40.0
    velocity: float = 12.0
    armature: float = 0.07
    friction_dry: float = 0.2
    friction_viscous: float = 0.05
    stand_hfe: float = 0.4
    stand_kfe: float = -0.8
    foot_radius: float = 0.0
    foot_len: float = 0.0


ANYMAL = QuadrupedParams()
SPOTMICRO = QuadrupedParams(
    name="spotmicro",
    base_mass=1.2,
    base_dims=(0.25, 0.11, 0.07),
    hip_mass=0.12,
    thigh_mass=0.09,
    shank_mass=0.04,
    foot_mass=0.01,
    hip_x=0.093,
    hip_y=0.039,
    hfe_off_x=0.0,
    hfe_off_y=0.028,
    thigh_len=0.11,
    shank_len=0.13,
    effort=2.0,
    velocity=8.0,
    armature=0.002,
    friction_dry=0.02,
    friction_viscous=0.005,
)


def _box_inertia(m, x, y, z):
    return (
        m / 12.0 * (y * y + z * z),
        m / 12.0 * (x * x + z * z),
        m / 12.0 * (x * x + y * y),
    )


def quadruped_hardware(
    p: QuadrupedParams,
    sensor_delay: float = 0.0,
    imu_noise: float = 0.0,
    encoder_noise: float = 0.0,
) -> dict:
    """Motor, contact and sensor constants (the reference's hardware
    description, same schema as a ``*_hardware.toml``). With capsule feet
    the feet are ``collisionBodyNames`` and each contact sensor reads its
    foot's first end sphere."""
    motors, encoders, efforts = {}, {}, {}
    for leg in _LEGS:
        for j in ("HAA", "HFE", "KFE"):
            jn = f"{leg}_{j}"
            motors[jn] = {
                "joint_name": jn,
                "mechanicalReduction": 1.0,
                "armature": p.armature,
                "frictionDry": p.friction_dry,
                "frictionViscous": p.friction_viscous,
                "effortLimit": p.effort,
                "velocityLimit": p.velocity,
            }
            encoders[jn] = {"joint_name": jn, "delay": sensor_delay, "noiseStd": encoder_noise}
            efforts[jn] = {"motor_name": jn}
    if p.foot_radius > 0:
        global_cfg = {"collisionBodyNames": [f"{leg}_FOOT" for leg in _LEGS]}
        site = "_col0_a"
    else:
        global_cfg = {"contactFrameNames": [f"{leg}_FOOT" for leg in _LEGS]}
        site = ""
    return {
        "Global": global_cfg,
        "Motor": {"SimpleMotor": motors},
        "Sensor": {
            "ImuSensor": {
                "base_imu": {"frame_name": "base_frame", "delay": sensor_delay, "noiseStd": imu_noise}
            },
            "EncoderSensor": encoders,
            "EffortSensor": efforts,
            "ContactSensor": {
                f"{leg}_FOOT_SENSOR": {"frame_name": f"{leg}_FOOT{site}"} for leg in _LEGS
            },
        },
    }


def anymal_hardware(sensor_delay: float = 0.0, imu_noise: float = 0.0,
                    encoder_noise: float = 0.0) -> dict:
    """ANYmal's hardware description (:func:`quadruped_hardware` of
    :data:`ANYMAL`)."""
    return quadruped_hardware(ANYMAL, sensor_delay=sensor_delay, imu_noise=imu_noise,
                              encoder_noise=encoder_noise)


def _links_and_joints(p: QuadrupedParams):
    """The URDF's links {name: (mass, com, diag inertia)} and joints
    [(name, type, parent, child, xyz, axis, lower, upper)] in document
    order."""
    links = {"base": (p.base_mass, (0, 0, 0), _box_inertia(p.base_mass, *p.base_dims))}
    joints = []
    hip_w = p.base_dims[1] / 3.0
    for leg, (sx, sy) in _LEGS.items():
        links[f"{leg}_HIP"] = (
            p.hip_mass, (0, sy * 0.02, 0),
            _box_inertia(p.hip_mass, hip_w, hip_w, hip_w),
        )
        links[f"{leg}_THIGH"] = (
            p.thigh_mass, (0, 0, -p.thigh_len / 2),
            _box_inertia(p.thigh_mass, 0.04, 0.04, p.thigh_len),
        )
        links[f"{leg}_SHANK"] = (
            p.shank_mass, (0, 0, -p.shank_len / 2),
            _box_inertia(p.shank_mass, 0.03, 0.03, p.shank_len),
        )
        links[f"{leg}_FOOT"] = (p.foot_mass, (0, 0, 0), (1e-5, 1e-5, 1e-5))
        joints += [
            (f"{leg}_HAA", "revolute", "base", f"{leg}_HIP",
             (sx * p.hip_x, sy * p.hip_y, 0.0), (1, 0, 0), -0.72, 0.72),
            (f"{leg}_HFE", "revolute", f"{leg}_HIP", f"{leg}_THIGH",
             (sx * p.hfe_off_x, sy * p.hfe_off_y, 0.0), (0, 1, 0), -3.0, 3.0),
            (f"{leg}_KFE", "revolute", f"{leg}_THIGH", f"{leg}_SHANK",
             (0.0, 0.0, -p.thigh_len), (0, 1, 0), -3.0, 3.0),
            (f"{leg}_FOOT_JOINT", "fixed", f"{leg}_SHANK", f"{leg}_FOOT",
             (0.0, 0.0, -p.shank_len), None, None, None),
        ]
    return links, joints


def quadruped_urdf(p: QuadrupedParams) -> str:
    """The quadruped of ``p`` as URDF text, the reference's document to
    the character: the base link, then per leg its four links and four
    joints (the foot joint fixed); with capsule feet a ``<collision>``
    capsule on each foot link, its axis turned onto y."""
    links, joints = _links_and_joints(p)

    def link(name):
        mass, com, (ixx, iyy, izz) = links[name]
        extra = ""
        if name.endswith("_FOOT") and p.foot_radius > 0:
            extra = f"""
    <collision>
      <origin xyz="0 0 0" rpy="1.5707963267948966 0 0"/>
      <geometry><capsule radius="{p.foot_radius}" length="{p.foot_len}"/></geometry>
    </collision>"""
        return f"""  <link name="{name}">
    <inertial>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" iyz="0" izz="{izz}"/>
    </inertial>{extra}
  </link>"""

    def joint(name, jtype, parent, child, xyz, axis, lower, upper):
        ax = f'\n    <axis xyz="{" ".join(map(str, axis))}"/>' if axis else ""
        lim = ""
        if jtype == "revolute":
            lim = (f'\n    <limit lower="{lower}" upper="{upper}" effort="{p.effort}" '
                   f'velocity="{p.velocity}"/>')
        return f"""  <joint name="{name}" type="{jtype}">
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="0 0 0"/>
    <parent link="{parent}"/>
    <child link="{child}"/>{ax}{lim}
  </joint>"""

    names = list(links)
    parts = [f'<robot name="{p.name}">', link(names[0])]
    for k in range(len(_LEGS)):  # each leg's 4 links, then its 4 joints
        parts += [link(n) for n in names[1 + 4 * k:5 + 4 * k]]
        parts += [joint(*j) for j in joints[4 * k:4 * k + 4]]
    parts.append("</robot>")
    return "\n".join(parts)


def anymal_urdf() -> str:
    """The ANYmal-class instance of the family as URDF text."""
    return quadruped_urdf(ANYMAL)


def make_quadruped(
    params: QuadrupedParams,
    device="cuda",
    dtype=torch.float32,
    sensor_period: float = 0.0025,
    sensor_delay: float = 0.0,
    imu_noise: float = 0.0,
    encoder_noise: float = 0.0,
) -> tuple[KinematicTree, Motors, SensorSuite]:
    """(tree, motors, sensors) of the quadruped of ``params``. The
    sensors, sampled every ``sensor_period`` s: one IMU on the base frame
    and the 12 encoders (``sensor_delay``; Gaussian noise of std
    ``imu_noise`` and ``encoder_noise``), 12 effort sensors and the 4 foot
    contact sensors (no delay, no noise). Capsule feet (``foot_radius >
    0``) are built through the URDF route (``robot.build_robot``)."""
    hw = quadruped_hardware(params, sensor_delay, imu_noise, encoder_noise)
    if params.foot_radius > 0:
        robot = build_robot(quadruped_urdf(params), hw, freeflyer=True,
                            sensor_period=sensor_period, name=params.name, device=device,
                            dtype=dtype)
        return robot.tree, robot.motors, robot.sensors
    links, joints = _links_and_joints(params)
    b = TreeBuilder()
    carrier = {}  # link → (body index carrying it, 4×4 offset)
    frames = {}  # fixed link → frame index

    m, com, ine = links["base"]
    idx = b.add_body("base", -1, JointType.FREE, mass=m, com=com,
                     inertia=ine, joint_name="root_joint")
    carrier["base"] = (idx, np.eye(4, dtype=np.float32))
    b.add_frame("base_frame", idx)

    children = {}
    for j in joints:
        children.setdefault(j[2], []).append(j)
    stack = ["base"]
    while stack:
        parent_link = stack.pop()
        p_body, p_off = carrier[parent_link]
        for name, jtype, _, child, xyz, axis, lo, hi in children.get(parent_link, []):
            T = p_off @ TreeBuilder.make_placement(xyz)
            m, com, ine = links[child]
            if jtype == "fixed":
                frames[child] = b.fuse_fixed_body(
                    child, p_body, T, mass=m, com=com, inertia=ine
                )
                carrier[child] = (p_body, T)
            else:
                idx = b.add_body(
                    child, p_body, JointType.REVOLUTE, placement=T,
                    axis=axis, mass=m, com=com, inertia=ine, joint_name=name,
                    q_limits=(lo, hi), u_max=params.effort,
                    v_max=params.velocity,
                )
                carrier[child] = (idx, np.eye(4, dtype=np.float32))
                b.add_frame(child + "_frame", idx)
            stack.append(child)

    for cname in hw["Global"]["contactFrameNames"]:
        f = frames[cname]
        b.add_contact_point(cname, b.frame_body[f], b.fp[f][:3, 3])
    cfgs = hw["Motor"]["SimpleMotor"]
    for cfg in cfgs.values():
        b.armature[b.joint_name.index(cfg["joint_name"])][:] = cfg["armature"]
    tree = b.build(device=device, dtype=dtype)

    joint_ids = [tree.joint_index(c["joint_name"]) for c in cfgs.values()]
    motors = Motors.create(
        v_idx=[tree.v_off[j] for j in joint_ids],
        q_idx=[tree.q_off[j] for j in joint_ids],
        names=list(cfgs),
        reduction=[c["mechanicalReduction"] for c in cfgs.values()],
        effort_limit=[c["effortLimit"] for c in cfgs.values()],
        velocity_limit=[c["velocityLimit"] for c in cfgs.values()],
        friction_dry=[c["frictionDry"] for c in cfgs.values()],
        friction_viscous=[c["frictionViscous"] for c in cfgs.values()],
        device=device,
        dtype=dtype,
    )
    return tree, motors, SensorSuite.build(tree, sensor_specs(hw), sensor_period)


def make_anymal(device="cuda", dtype=torch.float32, sensor_period: float = 0.01,
                **kwargs) -> tuple[KinematicTree, Motors, SensorSuite]:
    """(tree, motors, sensors) of the ANYmal-class flagship quadruped
    (:func:`make_quadruped` of :data:`ANYMAL`)."""
    return make_quadruped(ANYMAL, device=device, dtype=dtype, sensor_period=sensor_period,
                          **kwargs)


def make_spotmicro(device="cuda", dtype=torch.float32, sensor_period: float = 0.0025,
                   **kwargs) -> tuple[KinematicTree, Motors, SensorSuite]:
    """(tree, motors, sensors) of the Spotmicro-class small quadruped
    (:func:`make_quadruped` of :data:`SPOTMICRO`)."""
    return make_quadruped(SPOTMICRO, device=device, dtype=dtype, sensor_period=sensor_period,
                          **kwargs)


STAND_HEIGHT = 0.57  # the reference's nominal base height, m


def stand_q(tree: KinematicTree, params: QuadrupedParams = ANYMAL) -> np.ndarray:
    """Nominal standing configuration (freeflyer + 12 joints), numpy f32."""
    q = np.zeros(tree.nq, dtype=np.float32)
    hfe, kfe = params.stand_hfe, params.stand_kfe
    q[2] = (
        params.thigh_len * np.cos(hfe)
        + params.shank_len * np.cos(hfe + kfe)
        + params.foot_radius  # capsule feet ride on their surface point
        + 0.01
    )
    q[6] = 1.0  # identity quaternion (xyzw)
    for leg, (sx, _sy) in _LEGS.items():
        q[tree.q_off[tree.joint_index(f"{leg}_HFE")]] = sx * hfe
        q[tree.q_off[tree.joint_index(f"{leg}_KFE")]] = sx * kfe
    return q
