"""Robot = model + hardware, built from a URDF and a hardware TOML.

Counterpart of ``jiminy_tpu/robot.py``. The hardware description (a
``*_hardware.toml`` path, the same schema as a dict, or None for
:func:`default_hardware`) uses the reference's sections:

    [Flexibility.<name>]  joint_name, stiffness, damping, inertia
    [JointSpring.<name>]  joint_name, stiffness, damping
    [Global]
    contactFrameNames = [...]        # links or frames: a contact point each
    collisionBodyNames = [...]       # links whose <collision> become sites
    contactSpheres.<name>  = {frame_name, center, radius}
    contactCapsules.<name> = {frame_name, p0, p1, radius}
    contactPoints.<name>   = {frame_name, pos}
    [Motor.SimpleMotor.<name>]  joint_name, mechanicalReduction, armature,
                                frictionDry, frictionViscous, effortLimit,
                                velocityLimit
    [Sensor.ImuSensor.<name>]      frame_name
    [Sensor.EncoderSensor.<name>]  joint_name
    [Sensor.EffortSensor.<name>]   motor_name
    [Sensor.ContactSensor.<name>]  frame_name   (a contact site's name)
    [Sensor.ForceSensor.<name>]    frame_name
    (each sensor section also takes delay, bias and noiseStd)

The pieces go in the reference's order: the flexibility joints first
(every body index the URDF's maps hold shifts past each), the springs,
the contact sites, the motors' armature folded into the tree before it
is built, then the motor bank and the sensor suite.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.hardware.sensors import SensorSuite
from jiminy_tpu_torch.io.urdf import parse_urdf


class Robot:
    """A built robot: kinematic tree, motor bank and sensor suite.

    ``visuals`` {body: [geometry dicts]} is the URDF's display geometry
    (None: none parsed); ``collision_shapes`` {link: (body, [geometry])}
    its parsed ``<collision>`` geometry, which
    ``engine.collision.shape_for_link`` turns into pair shapes."""

    def __init__(self, tree: KinematicTree, motors: Motors | None = None,
                 sensors: SensorSuite | None = None, name: str = "robot",
                 visuals: dict | None = None, collision_shapes: dict | None = None):
        self.tree = tree
        self.motors = motors
        self.sensors = sensors
        self.name = name
        self.visuals = visuals
        self.collision_shapes = collision_shapes or {}

    @property
    def nmotors(self) -> int:
        return self.motors.nm if self.motors is not None else 0


def default_hardware(builder, info) -> dict:
    """A motor, an encoder and an effort sensor on every REVOLUTE and
    PRISMATIC joint, and an IMU on the root body's frame (the reference's
    default hardware description)."""
    hw: dict = {"Global": {"contactFrameNames": []}, "Motor": {"SimpleMotor": {}},
                "Sensor": {}}
    enc, eff = {}, {}
    for jname, jtype in zip(builder.joint_name, builder.joint_type):
        if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
            hw["Motor"]["SimpleMotor"][jname] = {"joint_name": jname}
            enc[jname] = {"joint_name": jname}
            eff[jname] = {"motor_name": jname}
    hw["Sensor"]["EncoderSensor"] = enc
    hw["Sensor"]["EffortSensor"] = eff
    if builder.body_name:
        root = builder.body_name[0]
        hw["Sensor"]["ImuSensor"] = {root + "_imu": {"frame_name": root + "_frame"}}
    return hw


def _resolve(info, builder, name):
    """A URDF link or frame name as ("frame" | "body", index)."""
    if name in info:
        return info[name]
    if name in builder.frame_name:
        return ("frame", builder.frame_name.index(name))
    raise KeyError(f"unknown frame/link {name!r}")


def _on_body(info, builder, name, *points):
    """(body, the points) of a link or frame, the points given in its
    frame and returned in its body's."""
    kind, idx = _resolve(info, builder, name)
    if kind != "frame":
        return idx, points
    T = builder.fp[idx]
    return builder.frame_body[idx], tuple(T[:3, :3] @ p + T[:3, 3] for p in points)


def _shift(builder, info, i):
    """``info`` and the URDF's geometry maps past a body inserted at ``i``."""
    def up(b):
        return b + 1 if b >= i else b

    builder.urdf_collisions = {k: (up(b), g) for k, (b, g) in builder.urdf_collisions.items()}
    builder.urdf_visuals = {up(b): g for b, g in builder.urdf_visuals.items()}
    return {k: (kind, up(idx) if kind == "body" else idx) for k, (kind, idx) in info.items()}


# hardware section → (sensor type, key of its target), in the reference's order
_SENSOR_SECTIONS = {
    "ImuSensor": ("imu", "frame_name"),
    "EncoderSensor": ("encoder", "joint_name"),
    "EffortSensor": ("effort", None),
    "ContactSensor": ("contact", "frame_name"),
    "ForceSensor": ("force", "frame_name"),
}


def sensor_specs(hw: dict, frame_of=None) -> list[dict]:
    """The hardware description's sensors as ``SensorSuite.build`` specs:
    an effort sensor reads its motor's joint, a contact sensor the contact
    site of its ``frame_name``, an IMU or a force sensor the frame
    ``frame_of(frame_name)`` (None: the name as it is)."""
    specs = []
    for section, (typ, key) in _SENSOR_SECTIONS.items():
        for name, cfg in hw.get("Sensor", {}).get(section, {}).items():
            if key is None:
                target = hw["Motor"]["SimpleMotor"][cfg["motor_name"]]["joint_name"]
            else:
                target = cfg[key]
                if typ in ("imu", "force") and frame_of is not None:
                    target = frame_of(target)
            specs.append(dict(type=typ, name=name, target=target,
                              delay=float(cfg.get("delay", 0.0)),
                              bias=float(cfg.get("bias", 0.0)),
                              noise_std=float(cfg.get("noiseStd", 0.0))))
    return specs


def build_robot(urdf: str | Path, hardware: str | Path | dict | None = None,
                freeflyer: bool = False, sensor_period: float = 0.01,
                gravity=(0.0, 0.0, -9.81), name: str = "robot", device="cuda",
                dtype=torch.float32) -> Robot:
    """The :class:`Robot` of a URDF (a path or the XML text) and its
    hardware description (a TOML path, a dict of the same schema, or None
    for :func:`default_hardware`), its sensors sampled every
    ``sensor_period`` s, on ``device`` in ``dtype``."""
    builder, info = parse_urdf(urdf, freeflyer=freeflyer, gravity=gravity)
    if hardware is None:
        hw = default_hardware(builder, info)
    elif isinstance(hardware, dict):
        hw = hardware
    else:
        hw = tomllib.loads(Path(hardware).read_text())
    glob = hw.get("Global", {})

    for fname, cfg in hw.get("Flexibility", {}).items():
        i = builder.insert_flexibility(cfg.get("joint_name", fname),
                                       stiffness=cfg.get("stiffness", 100.0),
                                       damping=cfg.get("damping", 1.0),
                                       inertia=cfg.get("inertia", 1e-3))
        info = _shift(builder, info, i)

    for sname, cfg in hw.get("JointSpring", {}).items():
        j = builder.joint_name.index(cfg.get("joint_name", sname))
        builder.stiffness[j][:] = float(cfg.get("stiffness", 0.0))
        builder.damping[j][:] = np.maximum(builder.damping[j], float(cfg.get("damping", 0.0)))

    for cname in glob.get("contactFrameNames", []):
        body, (pos,) = _on_body(info, builder, cname, np.zeros(3, np.float32))
        if body < 0:
            raise ValueError(f"contact frame {cname!r} attached to the world")
        builder.add_contact_point(cname, body, pos)

    for lname in glob.get("collisionBodyNames", []):
        if lname not in builder.urdf_collisions:
            raise ValueError(f"collision body {lname!r}: no <collision> geometry in the URDF "
                             "for that link")
        body, geoms = builder.urdf_collisions[lname]
        if body < 0:
            raise ValueError(f"collision body {lname!r} fixed to the world")
        for gi, g in enumerate(geoms):
            base = f"{lname}_col{gi}"
            if g[0] == "sphere":
                builder.add_contact_sphere(base, body, g[1], radius=g[2])
            elif g[0] == "capsule":
                builder.add_contact_capsule(base, body, g[1], g[2], g[3])
            else:  # a mesh's support points, a box's corners
                tag = "v" if g[0] == "mesh" else "c"
                for ci, c in enumerate(g[1]):
                    builder.add_contact_point(f"{base}_{tag}{ci}", body, c)

    for cname, cfg in glob.get("contactSpheres", {}).items():
        body, (c,) = _on_body(info, builder, cfg["frame_name"],
                              np.asarray(cfg.get("center", (0.0, 0.0, 0.0)), np.float32))
        builder.add_contact_sphere(cname, body, c, radius=float(cfg["radius"]))
    for cname, cfg in glob.get("contactCapsules", {}).items():
        body, (p0, p1) = _on_body(info, builder, cfg["frame_name"],
                                  np.asarray(cfg["p0"], np.float32),
                                  np.asarray(cfg["p1"], np.float32))
        builder.add_contact_capsule(cname, body, p0, p1, float(cfg["radius"]))
    for cname, cfg in glob.get("contactPoints", {}).items():
        body, (pos,) = _on_body(info, builder, cfg["frame_name"],
                                np.asarray(cfg.get("pos", (0.0, 0.0, 0.0)), np.float32))
        if body < 0:
            raise ValueError(f"contact point {cname!r} attached to the world")
        builder.add_contact_point(cname, body, pos)

    motor_cfgs = hw.get("Motor", {}).get("SimpleMotor", {})
    for cfg in motor_cfgs.values():
        arm = float(cfg.get("armature", 0.0))
        if arm:
            builder.armature[builder.joint_name.index(cfg["joint_name"])][:] = arm

    tree = builder.build(device=device, dtype=dtype)

    motors = None
    if motor_cfgs:
        joints = [tree.joint_index(c["joint_name"]) for c in motor_cfgs.values()]
        v_idx = [tree.v_off[j] for j in joints]
        motors = Motors.create(
            v_idx,
            q_idx=[tree.q_off[j] for j in joints],
            names=list(motor_cfgs),
            reduction=[float(c.get("mechanicalReduction", 1.0)) for c in motor_cfgs.values()],
            effort_limit=[float(c.get("effortLimit", tree.u_max[vi]))
                          for c, vi in zip(motor_cfgs.values(), v_idx)],
            velocity_limit=[float(c.get("velocityLimit", tree.v_max[vi]))
                            for c, vi in zip(motor_cfgs.values(), v_idx)],
            friction_dry=[float(c.get("frictionDry", 0.0)) for c in motor_cfgs.values()],
            friction_viscous=[float(c.get("frictionViscous", 0.0)) for c in motor_cfgs.values()],
            device=device,
            dtype=dtype,
        )

    def frame_of(name):  # a link that is a moving body: its body's frame
        kind, idx = _resolve(info, builder, name)
        return tree.body_name[idx] + "_frame" if kind == "body" else name

    specs = sensor_specs(hw, frame_of)
    sensors = SensorSuite.build(tree, specs, sensor_period) if specs else None
    return Robot(tree, motors=motors, sensors=sensors, name=name,
                 visuals=builder.urdf_visuals or None,
                 collision_shapes=builder.urdf_collisions or None)
