"""ANYmal-class quadruped — the port's own builder of the flagship model.

Counterpart of ``jiminy_tpu/models/quadruped.py``. The reference writes
the robot as URDF text and runs it through its URDF parser and hardware
pipeline; the port builds the same tree directly, in the order that
parser visits it (depth-first from the base, last-pushed leg first), with
the feet fused into the shanks as fixed frames and contact points at the
foot frames. The test ``tests/test_torch_model.py`` holds the result
field for field against ``jiminy_tpu.models.make_anymal()``.

Morphology (ANYmal-B-like, 12 actuated DoF): base (floating) → per leg
{LF, RF, LH, RH}: HAA (x-axis) → HFE (y) → KFE (y); feet are fixed links.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.hardware.motors import Motors

# leg name → (x sign, y sign)
_LEGS = {"LF": (1, 1), "RF": (1, -1), "LH": (-1, 1), "RH": (-1, -1)}


@dataclasses.dataclass(frozen=True)
class QuadrupedParams:
    """Morphology parameters (the reference's, without the capsule-foot
    options: sphere/capsule sites are ROADMAP A.13)."""

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


ANYMAL = QuadrupedParams()


def _box_inertia(m, x, y, z):
    return (
        m / 12.0 * (y * y + z * z),
        m / 12.0 * (x * x + z * z),
        m / 12.0 * (x * x + y * y),
    )


def quadruped_hardware(p: QuadrupedParams) -> dict:
    """Motor and contact-frame constants (the reference's hardware
    description, minus the sensors this slice does not port)."""
    motors = {}
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
    return {
        "Global": {"contactFrameNames": [f"{leg}_FOOT" for leg in _LEGS]},
        "Motor": {"SimpleMotor": motors},
    }


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


def make_anymal(device="cuda", dtype=torch.float32) -> tuple[KinematicTree, Motors]:
    """(tree, motors) of the ANYmal-class flagship quadruped."""
    params = ANYMAL
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

    hw = quadruped_hardware(params)
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
    return tree, motors


def stand_q(tree: KinematicTree, params: QuadrupedParams = ANYMAL) -> np.ndarray:
    """Nominal standing configuration (freeflyer + 12 joints), numpy f32."""
    q = np.zeros(tree.nq, dtype=np.float32)
    hfe, kfe = params.stand_hfe, params.stand_kfe
    q[2] = (
        params.thigh_len * np.cos(hfe)
        + params.shank_len * np.cos(hfe + kfe)
        + 0.01
    )
    q[6] = 1.0  # identity quaternion (xyzw)
    for leg, (sx, _sy) in _LEGS.items():
        q[tree.q_off[tree.joint_index(f"{leg}_HFE")]] = sx * hfe
        q[tree.q_off[tree.joint_index(f"{leg}_KFE")]] = sx * kfe
    return q
