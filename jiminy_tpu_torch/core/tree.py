"""KinematicTree — the static robot model as a dataclass of tensors.

Counterpart of ``jiminy_tpu/core/tree.py``. Topology (parents, joint
types, q/v offsets, names) is plain Python data, so the rigid-body
algorithms loop over bodies in Python; numeric model data are unbatched
tensors shared by every env of a batch.

Models cross from the reference as numpy arrays: :func:`tree_from_arrays`
takes every field of the reference's ``KinematicTree`` as a numpy array
and returns the port's tree. :func:`merge_trees` joins robots into one
forest (several roots), the model of a multi-robot simulation whose
robots a ``CouplingForce`` ties together. :func:`map_configuration` and
:func:`map_velocity` carry a state between two trees by joint name (the
rigid ↔ flexible state maps). :class:`TreeBuilder` is the reference's
builder (moving bodies with their armature, damping and joint springs,
fixed-body fusion, frames, world-anchored frames included, contact
points, spheres and capsules, and spherical flexibility and revolute
backlash joints inserted upstream of a joint) on FREE, REVOLUTE,
PRISMATIC and SPHERICAL joints; the URDF parser (``io/urdf.py``) drives
it.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import torch

from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import SpatialInertia, Transform


class JointType(enum.IntEnum):
    """Same codes as the reference: FREE q=[pos, quat xyzw], v=[v_lin
    local, ω local]; REVOLUTE/PRISMATIC scalars; SPHERICAL q=quat,
    v=ω local."""

    FREE = 0
    REVOLUTE = 1
    PRISMATIC = 2
    SPHERICAL = 3


JOINT_NQ = {
    JointType.FREE: 7,
    JointType.REVOLUTE: 1,
    JointType.PRISMATIC: 1,
    JointType.SPHERICAL: 4,
}
JOINT_NV = {
    JointType.FREE: 6,
    JointType.REVOLUTE: 1,
    JointType.PRISMATIC: 1,
    JointType.SPHERICAL: 3,
}

# fields holding Python topology vs fields holding numeric tensors
STATIC_FIELDS = (
    "nb", "nq", "nv", "parent", "joint_type", "q_off", "v_off",
    "body_name", "joint_name", "frame_body", "frame_name",
    "contact_body", "contact_frame_name",
)
ARRAY_FIELDS = (
    "jp_rot", "jp_pos", "axis", "inertia_mass", "inertia_h",
    "inertia_mat", "armature", "damping", "stiffness", "q_min", "q_max",
    "v_max", "u_max", "gravity", "fp_rot", "fp_pos", "contact_pos",
    "contact_radius",
)


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    nb: int
    nq: int
    nv: int
    parent: tuple
    joint_type: tuple
    q_off: tuple
    v_off: tuple
    body_name: tuple
    joint_name: tuple
    frame_body: tuple
    frame_name: tuple
    contact_body: tuple
    contact_frame_name: tuple
    jp_rot: torch.Tensor  # (nb, 3, 3) joint frame in the parent body
    jp_pos: torch.Tensor  # (nb, 3)
    axis: torch.Tensor  # (nb, 3)
    inertia_mass: torch.Tensor  # (nb,)
    inertia_h: torch.Tensor  # (nb, 3) first moment m·c
    inertia_mat: torch.Tensor  # (nb, 3, 3) about the body origin
    armature: torch.Tensor  # (nv,)
    damping: torch.Tensor  # (nv,)
    stiffness: torch.Tensor  # (nv,)
    q_min: torch.Tensor  # (nq,)
    q_max: torch.Tensor  # (nq,)
    v_max: torch.Tensor  # (nv,)
    u_max: torch.Tensor  # (nv,)
    gravity: torch.Tensor  # (3,)
    fp_rot: torch.Tensor  # (nf, 3, 3)
    fp_pos: torch.Tensor  # (nf, 3)
    contact_pos: torch.Tensor  # (ncp, 3)
    contact_radius: torch.Tensor  # (ncp,)

    @property
    def device(self) -> torch.device:
        return self.jp_pos.device

    @property
    def dtype(self) -> torch.dtype:
        return self.jp_pos.dtype

    def to(self, device=None, dtype=None) -> "KinematicTree":
        return dataclasses.replace(
            self,
            **{
                k: getattr(self, k).to(device=device, dtype=dtype)
                for k in ARRAY_FIELDS
            },
        )

    @functools.cached_property
    def motion_subspaces(self) -> tuple:
        """S_i (6, nv_i) per body: joint velocity → local spatial
        velocity (FREE: v = [v_lin, ω] maps to spatial (ω, v_lin))."""
        kw = dict(dtype=self.dtype, device=self.device)
        out = []
        for i, t in enumerate(self.joint_type):
            S = torch.zeros(6, JOINT_NV[t], **kw)
            if t == JointType.FREE:
                S[0:3, 3:6] = torch.eye(3, **kw)
                S[3:6, 0:3] = torch.eye(3, **kw)
            elif t == JointType.REVOLUTE:
                S[0:3, 0] = self.axis[i]
            elif t == JointType.PRISMATIC:  # a translation along the axis
                S[3:6, 0] = self.axis[i]
            elif t == JointType.SPHERICAL:  # v = ω local
                S[0:3, 0:3] = torch.eye(3, **kw)
            else:
                raise ValueError(f"unsupported joint type {t}")
            out.append(S)
        return tuple(out)

    def _sprung(self, types) -> tuple[list, list]:
        stiff = self.stiffness.detach().cpu().numpy()
        sprung = [i for i, t in enumerate(self.joint_type)
                  if t in types and np.any(stiff[self.v_slice(i)] != 0)]
        return [self.v_off[i] for i in sprung], [self.q_off[i] for i in sprung]

    @functools.cached_property
    def sprung_joints(self) -> tuple[list, list]:
        """(v offsets, q offsets) of the 1-DoF joints with a spring
        (nonzero stiffness), read once per tree."""
        return self._sprung((JointType.REVOLUTE, JointType.PRISMATIC))

    @functools.cached_property
    def sprung_spherical(self) -> tuple[list, list]:
        """(v offsets, q offsets) of the SPHERICAL joints with a spring on
        any of their 3 dofs (the flexibility joints), read once per tree."""
        return self._sprung((JointType.SPHERICAL,))

    def neutral_q(self) -> np.ndarray:
        """The neutral configuration (nq,) as numpy float32: identity
        quaternions (FREE and SPHERICAL), zeros elsewhere."""
        q = np.zeros(self.nq, np.float32)
        for t, off in zip(self.joint_type, self.q_off):
            if t == JointType.FREE:
                q[off + 6] = 1.0
            elif t == JointType.SPHERICAL:
                q[off + 3] = 1.0
        return q

    def joint_placement(self, i: int) -> Transform:
        return Transform(rot=self.jp_rot[i], pos=self.jp_pos[i])

    def body_inertia(self, i: int) -> SpatialInertia:
        return SpatialInertia(
            mass=self.inertia_mass[i],
            h=self.inertia_h[i],
            inertia=self.inertia_mat[i],
        )

    @property
    def nf(self) -> int:
        return len(self.frame_body)

    @property
    def ncp(self) -> int:
        return len(self.contact_body)

    def joint_index(self, name: str) -> int:
        return self.joint_name.index(name)

    def frame_index(self, name: str) -> int:
        return self.frame_name.index(name)

    def frame_placement(self, k: int) -> Transform:
        """Pose of frame k in its body."""
        return Transform(rot=self.fp_rot[k], pos=self.fp_pos[k])

    def q_slice(self, i: int) -> slice:
        o = self.q_off[i]
        return slice(o, o + JOINT_NQ[self.joint_type[i]])

    def v_slice(self, i: int) -> slice:
        o = self.v_off[i]
        return slice(o, o + JOINT_NV[self.joint_type[i]])


def tree_from_arrays(
    d: dict, device="cuda", dtype=torch.float32
) -> KinematicTree:
    """The port's tree from every reference ``KinematicTree`` field given
    as a numpy array (integer arrays for topology, string arrays for
    names). This is how models and states cross from the JAX package."""
    from jiminy_tpu_torch import resolve_device

    dev = resolve_device(device)
    missing = [k for k in STATIC_FIELDS + ARRAY_FIELDS if k not in d]
    if missing:
        raise KeyError(f"tree_from_arrays: missing fields {missing}")

    def ints(k):
        return tuple(int(x) for x in np.asarray(d[k]).reshape(-1))

    def strs(k):
        return tuple(str(x) for x in np.asarray(d[k]).reshape(-1))

    jtypes = tuple(JointType(j) for j in ints("joint_type"))
    static = dict(
        nb=int(d["nb"]),
        nq=int(d["nq"]),
        nv=int(d["nv"]),
        parent=ints("parent"),
        joint_type=jtypes,
        q_off=ints("q_off"),
        v_off=ints("v_off"),
        body_name=strs("body_name"),
        joint_name=strs("joint_name"),
        frame_body=ints("frame_body"),
        frame_name=strs("frame_name"),
        contact_body=ints("contact_body"),
        contact_frame_name=strs("contact_frame_name"),
    )
    arrays = {
        k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=dev)
        for k in ARRAY_FIELDS
    }
    return KinematicTree(**static, **arrays)


def merge_trees(trees, prefixes=None) -> KinematicTree:
    """Robots merged into one forest tree (one root per robot), their
    bodies, joints, frames and contacts in order, the names prefixed per
    robot (``"robot0/"``, … or ``prefixes``) and the indices remapped;
    the gravity is the first tree's. Every tree must share one device and
    dtype."""
    trees = list(trees)
    if prefixes is None:
        prefixes = [f"robot{i}/" for i in range(len(trees))]
    static = {k: [] for k in STATIC_FIELDS if k not in ("nb", "nq", "nv")}
    b_off = q_base = v_base = 0
    for t, pre in zip(trees, prefixes):
        static["parent"] += [p + b_off if p >= 0 else -1 for p in t.parent]
        static["joint_type"] += list(t.joint_type)
        static["q_off"] += [o + q_base for o in t.q_off]
        static["v_off"] += [o + v_base for o in t.v_off]
        for k in ("body_name", "joint_name", "frame_name", "contact_frame_name"):
            static[k] += [pre + n for n in getattr(t, k)]
        static["frame_body"] += [b + b_off for b in t.frame_body]
        static["contact_body"] += [b + b_off for b in t.contact_body]
        b_off += t.nb
        q_base += t.nq
        v_base += t.nv
    arrays = {k: torch.cat([getattr(t, k) for t in trees]) for k in ARRAY_FIELDS
              if k != "gravity"}
    return KinematicTree(nb=b_off, nq=q_base, nv=v_base,
                         **{k: tuple(x) for k, x in static.items()},
                         gravity=trees[0].gravity, **arrays)


def map_configuration(src: KinematicTree, dst: KinematicTree, q_src: torch.Tensor) -> torch.Tensor:
    """A configuration (..., src.nq) of ``src`` as one (..., dst.nq) of
    ``dst``, joint by joint name; a joint that ``src`` lacks (an inserted
    flexibility or backlash joint) stays neutral."""
    neutral = torch.as_tensor(dst.neutral_q(), dtype=q_src.dtype, device=q_src.device)
    q = neutral.expand(*q_src.shape[:-1], dst.nq).clone()
    for j, name in enumerate(dst.joint_name):
        if name in src.joint_name:
            q[..., dst.q_slice(j)] = q_src[..., src.q_slice(src.joint_index(name))]
    return q


def map_velocity(src: KinematicTree, dst: KinematicTree, v_src: torch.Tensor) -> torch.Tensor:
    """The velocity counterpart of :func:`map_configuration` (absent
    joints at rest)."""
    v = v_src.new_zeros(*v_src.shape[:-1], dst.nv)
    for j, name in enumerate(dst.joint_name):
        if name in src.joint_name:
            v[..., dst.v_slice(j)] = v_src[..., src.v_slice(src.joint_index(name))]
    return v


class TreeBuilder:
    """Imperative builder, the reference's TreeBuilder. Fixed bodies are fused into their
    parent (inertia composition) and kept as operational frames; the
    numpy arithmetic is the reference's, so built trees match it."""

    def __init__(self, gravity=(0.0, 0.0, -9.81)):
        self._gravity = np.asarray(gravity, dtype=np.float32)
        self.parent: list[int] = []
        self.joint_type: list[JointType] = []
        self.jp: list[np.ndarray] = []
        self.axis: list[np.ndarray] = []
        self.mass: list[float] = []
        self.com: list[np.ndarray] = []
        self.inertia_com: list[np.ndarray] = []
        self.body_name: list[str] = []
        self.joint_name: list[str] = []
        self.armature: list[np.ndarray] = []
        self.damping: list[np.ndarray] = []
        self.stiffness: list[np.ndarray] = []
        self.q_min: list[np.ndarray] = []
        self.q_max: list[np.ndarray] = []
        self.v_max: list[np.ndarray] = []
        self.u_max: list[np.ndarray] = []
        self.frame_body: list[int] = []
        self.frame_name: list[str] = []
        self.fp: list[np.ndarray] = []
        self.contact_body: list[int] = []
        self.contact_pos: list[np.ndarray] = []
        self.contact_radius: list[float] = []
        self.contact_frame_name: list[str] = []

    @staticmethod
    def make_placement(pos=(0.0, 0.0, 0.0), rpy=(0.0, 0.0, 0.0)) -> np.ndarray:
        """4×4 placement at ``pos`` turned by roll-pitch-yaw ``rpy`` (the
        URDF convention), in float32 as the reference's."""
        T = np.eye(4, dtype=np.float32)
        # the reference's so3.rpy_to_quat in float32, with the sine and
        # cosine of the float32 half angles correctly rounded (as the
        # reference's round at the Ant's placements; torch's and numpy's
        # float32 ones are an ulp off there)
        half = (np.float32(0.5) * np.asarray(rpy, np.float32)).astype(np.float64)
        (cr, cp, cy), (sr, sp, sy) = np.cos(half).astype(np.float32), np.sin(half).astype(np.float32)
        quat = np.array([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                         cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy], np.float32)
        T[:3, :3] = so3.quat_to_matrix(torch.from_numpy(quat)).numpy()
        T[:3, 3] = np.asarray(pos, dtype=np.float32)
        return T

    def add_body(
        self,
        name: str,
        parent: int,
        joint_type: JointType,
        placement: np.ndarray | None = None,
        axis=(0.0, 0.0, 1.0),
        mass: float = 0.0,
        com=(0.0, 0.0, 0.0),
        inertia=None,
        joint_name: str | None = None,
        armature=0.0,
        damping=0.0,
        stiffness=0.0,
        q_limits=None,
        v_max: float = 1e6,
        u_max: float = 1e6,
    ) -> int:
        """A moving body under ``parent`` (−1: the world). ``armature``,
        ``damping`` and ``stiffness`` are per joint dof (scalars
        broadcast): a 1-DoF joint with stiffness k is a spring −k·q
        toward 0. Returns the body's index."""
        nvj = JOINT_NV[joint_type]
        nqj = JOINT_NQ[joint_type]
        self.parent.append(parent)
        self.joint_type.append(joint_type)
        self.jp.append(
            np.eye(4, dtype=np.float32) if placement is None else placement
        )
        ax = np.asarray(axis, dtype=np.float32)
        n = np.linalg.norm(ax)
        self.axis.append(ax / n if n > 0 else np.array([0, 0, 1], np.float32))
        self.mass.append(float(mass))
        self.com.append(np.asarray(com, dtype=np.float32))
        inertia = (
            np.zeros((3, 3), np.float32)
            if inertia is None else np.asarray(inertia, np.float32)
        )
        if inertia.shape == (3,):
            inertia = np.diag(inertia)
        self.inertia_com.append(inertia)
        self.body_name.append(name)
        self.joint_name.append(joint_name or f"{name}_joint")

        for dst, x in ((self.armature, armature), (self.damping, damping),
                       (self.stiffness, stiffness)):
            dst.append(np.broadcast_to(np.asarray(x, np.float32), (nvj,)).copy())
        if q_limits is None:
            lo = np.full(nqj, -1e6, np.float32)
            hi = np.full(nqj, 1e6, np.float32)
        else:
            lo = np.broadcast_to(np.asarray(q_limits[0], np.float32), (nqj,)).copy()
            hi = np.broadcast_to(np.asarray(q_limits[1], np.float32), (nqj,)).copy()
        if joint_type in (JointType.FREE, JointType.SPHERICAL):
            qs = 3 if joint_type == JointType.FREE else 0
            lo[qs:], hi[qs:] = -1e6, 1e6
        self.q_min.append(lo)
        self.q_max.append(hi)
        self.v_max.append(np.full(nvj, v_max, np.float32))
        self.u_max.append(np.full(nvj, u_max, np.float32))
        return len(self.parent) - 1

    def insert_flexibility(self, joint_name: str, stiffness=100.0, damping=1.0,
                           inertia=1e-3) -> int:
        """Insert a 3-DoF SPHERICAL flexibility joint upstream of the named
        joint: the new body ``<body>_flex`` takes the joint's body index,
        parent and placement, carries the rotary ``inertia`` (no mass),
        and a spring-damper of ``stiffness`` and ``damping`` per axis pulls
        it to the identity (−k·log(quat)); the original body hangs off it at
        the identity. Every body index ≥ it that the builder holds (parents,
        frames, contact sites) shifts by one. Returns the new body's
        index."""
        i = self.joint_name.index(joint_name)
        name = self.body_name[i] + "_flex"

        def bump(idx: int) -> int:
            return idx + 1 if idx >= i else idx

        self.parent = [bump(p) for p in self.parent]
        self.frame_body = [bump(b) for b in self.frame_body]
        self.contact_body = [bump(b) for b in self.contact_body]

        def per_axis(x):
            return np.broadcast_to(np.asarray(x, np.float32), (3,)).copy()

        for dst, x in (
            (self.parent, self.parent[i]), (self.joint_type, JointType.SPHERICAL),
            (self.jp, self.jp[i]), (self.axis, np.array([0, 0, 1], np.float32)),
            (self.mass, 0.0), (self.com, np.zeros(3, np.float32)),
            (self.inertia_com, np.diag(per_axis(inertia)).astype(np.float32)),
            (self.body_name, name), (self.joint_name, name + "_joint"),
            (self.armature, np.zeros(3, np.float32)), (self.damping, per_axis(damping)),
            (self.stiffness, per_axis(stiffness)), (self.q_min, np.full(4, -1e6, np.float32)),
            (self.q_max, np.full(4, 1e6, np.float32)), (self.v_max, np.full(3, 1e6, np.float32)),
            (self.u_max, np.full(3, 1e6, np.float32)),
        ):
            dst.insert(i, x)
        self.parent[i + 1] = i
        self.jp[i + 1] = np.eye(4, dtype=np.float32)
        return i

    def insert_backlash(self, joint_name: str, play: float, armature: float = 1e-4,
                        damping: float = 0.0) -> int:
        """Insert a passive backlash joint upstream of the named joint: a
        massless revolute body ``<body>_backlash`` about the same axis,
        bounded to ±play/2 (by the bounds rows), with ``armature`` so that
        the DoF has some inertia. It takes the joint's body index, parent
        and placement; the original body hangs off it at the identity, and
        every body index ≥ it shifts by one. Returns its index."""
        i = self.joint_name.index(joint_name)
        name = self.body_name[i] + "_backlash"

        def bump(idx: int) -> int:
            return idx + 1 if idx >= i else idx

        self.parent = [bump(p) for p in self.parent]
        self.frame_body = [bump(b) for b in self.frame_body]
        self.contact_body = [bump(b) for b in self.contact_body]

        half = float(play) / 2.0
        for dst, x in (
            (self.parent, self.parent[i]), (self.joint_type, JointType.REVOLUTE),
            (self.jp, self.jp[i]), (self.axis, self.axis[i].copy()),
            (self.mass, 0.0), (self.com, np.zeros(3, np.float32)),
            (self.inertia_com, np.zeros((3, 3), np.float32)),
            (self.body_name, name), (self.joint_name, name + "_joint"),
            (self.armature, np.full(1, armature, np.float32)),
            (self.damping, np.full(1, damping, np.float32)),
            (self.stiffness, np.zeros(1, np.float32)),
            (self.q_min, np.full(1, -half, np.float32)), (self.q_max, np.full(1, half, np.float32)),
            (self.v_max, np.full(1, 1e6, np.float32)), (self.u_max, np.full(1, 1e6, np.float32)),
        ):
            dst.insert(i, x)
        self.parent[i + 1] = i
        self.jp[i + 1] = np.eye(4, dtype=np.float32)
        return i

    def fuse_fixed_body(
        self, name, parent, placement, mass=0.0, com=(0.0, 0.0, 0.0),
        inertia=None,
    ) -> int:
        """Fuse a fixed body into ``parent`` (composite inertia) and keep
        its frame. Returns the frame index."""
        R = placement[:3, :3].astype(np.float32)
        p = placement[:3, 3].astype(np.float32)
        frame = self.add_frame(name, parent, placement)
        if parent < 0 or mass <= 0.0:
            return frame
        inertia = (
            np.zeros((3, 3), np.float32)
            if inertia is None else np.asarray(inertia, np.float32)
        )
        if inertia.shape == (3,):
            inertia = np.diag(inertia)
        c2 = R @ np.asarray(com, np.float32) + p
        i2 = R @ inertia @ R.T
        m1 = self.mass[parent]
        c1 = self.com[parent]
        i1 = self.inertia_com[parent]
        m = m1 + float(mass)
        c = (m1 * c1 + mass * c2) / m

        def shift(I, mi, ci):
            dd = ci - c
            return I + mi * (
                np.dot(dd, dd) * np.eye(3, dtype=np.float32) - np.outer(dd, dd)
            )

        self.mass[parent] = m
        self.com[parent] = c.astype(np.float32)
        self.inertia_com[parent] = (
            shift(i1, m1, c1) + shift(i2, float(mass), c2)
        ).astype(np.float32)
        return frame

    def add_frame(self, name, body, placement=None) -> int:
        self.frame_body.append(body)
        self.frame_name.append(name)
        self.fp.append(
            np.eye(4, dtype=np.float32) if placement is None else placement
        )
        return len(self.frame_body) - 1

    def add_contact_point(self, name, body, pos=(0.0, 0.0, 0.0), radius: float = 0.0):
        """A contact site on ``body``: a bare point (radius 0) or the
        centre of a sphere of ``radius``."""
        self.contact_body.append(body)
        self.contact_pos.append(np.asarray(pos, np.float32))
        self.contact_radius.append(float(radius))
        self.contact_frame_name.append(name)
        return len(self.contact_body) - 1

    def add_contact_sphere(self, name, body, center=(0.0, 0.0, 0.0), radius: float = 0.0):
        """A sphere against the ground: it touches at centre − r·n̂."""
        return self.add_contact_point(name, body, center, radius=radius)

    def add_contact_capsule(self, name, body, p0, p1, radius: float) -> tuple[int, int]:
        """A capsule against the ground as its two end spheres (on flat
        ground its side touches only where both ends do)."""
        return (self.add_contact_sphere(f"{name}_a", body, p0, radius=radius),
                self.add_contact_sphere(f"{name}_b", body, p1, radius=radius))

    def build(self, device="cuda", dtype=torch.float32) -> KinematicTree:
        q_off, v_off = [], []
        nq = nv = 0
        for t in self.joint_type:
            q_off.append(nq)
            v_off.append(nv)
            nq += JOINT_NQ[t]
            nv += JOINT_NV[t]
        jp = np.stack(self.jp)
        masses, hs, mats = [], [], []
        for m, c, ic in zip(self.mass, self.com, self.inertia_com):
            ch = np.array(
                [[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]],
                np.float32,
            )
            mats.append(ic + m * (ch @ ch.T))
            hs.append(m * c)
            masses.append(m)
        fp = np.stack(self.fp) if self.fp else np.zeros((0, 4, 4), np.float32)
        cp = (
            np.stack(self.contact_pos)
            if self.contact_pos else np.zeros((0, 3), np.float32)
        )
        d = dict(
            nb=len(self.parent),
            nq=nq,
            nv=nv,
            parent=np.asarray(self.parent),
            joint_type=np.asarray([int(t) for t in self.joint_type]),
            q_off=np.asarray(q_off),
            v_off=np.asarray(v_off),
            body_name=np.asarray(self.body_name),
            joint_name=np.asarray(self.joint_name),
            frame_body=np.asarray(self.frame_body),
            frame_name=np.asarray(self.frame_name),
            contact_body=np.asarray(self.contact_body, dtype=np.int64),
            contact_frame_name=np.asarray(self.contact_frame_name, dtype=str),
            jp_rot=jp[:, :3, :3],
            jp_pos=jp[:, :3, 3],
            axis=np.stack(self.axis),
            inertia_mass=np.asarray(masses, np.float32),
            inertia_h=np.stack(hs).astype(np.float32),
            inertia_mat=np.stack(mats).astype(np.float32),
            armature=np.concatenate(self.armature),
            damping=np.concatenate(self.damping),
            stiffness=np.concatenate(self.stiffness),
            q_min=np.concatenate(self.q_min),
            q_max=np.concatenate(self.q_max),
            v_max=np.concatenate(self.v_max),
            u_max=np.concatenate(self.u_max),
            gravity=self._gravity,
            fp_rot=fp[:, :3, :3],
            fp_pos=fp[:, :3, 3],
            contact_pos=cp,
            contact_radius=np.asarray(self.contact_radius, np.float32),
        )
        return tree_from_arrays(d, device=device, dtype=dtype)
