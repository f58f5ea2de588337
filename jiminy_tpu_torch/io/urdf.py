"""URDF → TreeBuilder / KinematicTree.

Counterpart of ``jiminy_tpu/io/urdf.py``, numpy and the standard library
only. The subset of URDF that robot-simulation assets use:

- joints: revolute, continuous, prismatic, fixed, floating; a mimic joint,
  a planar or any other type, or a root tag other than ``robot`` raises
  ValueError, as in the reference;
- a link's ``<inertial>`` (origin xyz and rpy, mass, the full inertia
  tensor), a joint's ``<origin>``, ``<axis>``, ``<limit lower upper effort
  velocity>`` and ``<dynamics damping>``;
- fixed links are fused into their parent (inertia composition) and kept
  as operational frames;
- ``<collision>`` spheres, capsules, cylinders (as capsules), boxes and
  STL meshes become per-link geometry (``builder.urdf_collisions``) that
  the hardware description attaches as contact sites
  (``[Global] collisionBodyNames``, ``robot.py``) and that
  ``engine/collision.py`` ``shape_for_link`` turns into pair shapes. A
  mesh is reduced when parsed to its support points along 26 + 14
  directions (the hull vertices that can touch the ground first, at most
  ``mesh_max_points``, a warning when that cap under-resolves the
  surface by more than 1 mm) and its fitted capsule;
- ``<visual>`` geometry (else the ``<collision>`` one) for a viewer
  (``builder.urdf_visuals``).

Every float is parsed to numpy float32, as the reference parses it; the
placements go through :meth:`TreeBuilder.make_placement`.
"""

from __future__ import annotations

import warnings
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder
from jiminy_tpu_torch.engine.collision import fit_capsule
from jiminy_tpu_torch.io.stl import read_stl

_JOINT_MAP = {
    "revolute": JointType.REVOLUTE,
    "continuous": JointType.REVOLUTE,
    "prismatic": JointType.PRISMATIC,
    "floating": JointType.FREE,
}


def _floats(s: str | None, n: int, default=0.0) -> np.ndarray:
    if not s:
        return np.full(n, default, dtype=np.float32)
    return np.asarray([float(x) for x in s.split()], dtype=np.float32)


def _origin(elem) -> np.ndarray:
    """<origin xyz rpy> → 4×4 placement."""
    if elem is None:
        return np.eye(4, dtype=np.float32)
    return TreeBuilder.make_placement(pos=_floats(elem.get("xyz"), 3),
                                      rpy=_floats(elem.get("rpy"), 3))


def _inertial(link) -> tuple[float, np.ndarray, np.ndarray]:
    """(mass, com in the link frame, inertia about the com in the link
    frame)."""
    ine = link.find("inertial")
    if ine is None:
        return 0.0, np.zeros(3, np.float32), np.zeros((3, 3), np.float32)
    T = _origin(ine.find("origin"))
    R, p = T[:3, :3], T[:3, 3]
    mass_e = ine.find("mass")
    mass = float(mass_e.get("value")) if mass_e is not None else 0.0
    it = ine.find("inertia")
    if it is None:
        inertia = np.zeros((3, 3), np.float32)
    else:
        ixx, iyy, izz, ixy, ixz, iyz = (float(it.get(k, 0.0))
                                        for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz"))
        inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]], np.float32)
    return mass, p.astype(np.float32), (R @ inertia @ R.T).astype(np.float32)


def _support_directions(n_extra: int = 0) -> np.ndarray:
    """The 26 face, edge and corner directions of a cube, then
    ``n_extra`` golden-spiral directions, as unit vectors: the extreme
    vertices of a cloud along them are hull vertices."""
    dirs = [np.array([x, y, z], np.float64)
            for x in (-1.0, 0.0, 1.0) for y in (-1.0, 0.0, 1.0) for z in (-1.0, 0.0, 1.0)
            if (x, y, z) != (0.0, 0.0, 0.0)]
    if n_extra:
        i = np.arange(n_extra, dtype=np.float64) + 0.5
        phi = np.arccos(1.0 - 2.0 * i / n_extra)
        theta = np.pi * (1.0 + 5.0**0.5) * i
        dirs += list(np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                               np.cos(phi)], axis=-1))
    d = np.stack(dirs)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _mesh_collision(mesh_elem, T: np.ndarray, mesh_dir: Path | None, max_points: int = 32,
                    n_extra_dirs: int = 14, link_name: str = "?"):
    """<collision><mesh> → ("mesh", support points (k, 3), its fitted
    capsule (p0, p1, r)) in the carrier body's frame, or None when the
    file is not found or is not an STL. A warning reports the reduction's
    penetration bound (the largest shortfall of the kept points' support
    against the whole cloud's, over 126 directions) above 1 mm."""
    fn = (mesh_elem.get("filename") or "").removeprefix("package://")
    cands = [Path(fn)]
    if mesh_dir is not None:
        cands += [mesh_dir / fn, mesh_dir / Path(fn).name]
    path = next((c for c in cands if c.is_file()), None)
    if path is None or path.suffix.lower() != ".stl":
        return None
    v, _ = read_stl(path, _floats(mesh_elem.get("scale"), 3, default=1.0))
    v = v @ T[:3, :3].astype(np.float64).T + T[:3, 3].astype(np.float64)
    pts = v[np.unique(np.argmax(v @ _support_directions(n_extra_dirs).T, axis=0))]
    if len(pts) > max_points:  # farthest-point thinning from the highest point
        keep = [int(np.argmax(pts[:, 2]))]
        d2 = np.sum((pts - pts[keep[0]]) ** 2, axis=-1)
        while len(keep) < max_points:
            nxt = int(np.argmax(d2))
            keep.append(nxt)
            d2 = np.minimum(d2, np.sum((pts - pts[nxt]) ** 2, axis=-1))
        pts = pts[keep]
    probe = _support_directions(100).T
    err = float(np.max(np.max(v @ probe, 0) - np.max(pts @ probe, 0)))
    if err > 1e-3:
        warnings.warn(
            f"collision mesh {path.name!r} on link {link_name!r}: support-point reduction "
            f"(max_points={max_points}) can under-resolve the surface by up to "
            f"{1e3 * err:.1f} mm — raise mesh_max_points in parse_urdf if this matters",
            stacklevel=2,
        )
    return ("mesh", pts.astype(np.float32), fit_capsule(v))


def _collision_geoms(link, T_link, urdf_dir, mesh_max_points, lname) -> list:
    """The link's <collision> entries in its carrier body's frame:
    ("sphere", c, r), ("capsule", p0, p1, r) (a cylinder too), ("box",
    corners (8, 3)) or ("mesh", points, capsule)."""
    geoms = []
    for col in link.findall("collision"):
        g = col.find("geometry")
        if g is None:
            continue
        T = T_link @ _origin(col.find("origin"))
        R, p = T[:3, :3], T[:3, 3]
        sph, cap, cyl, box, msh = (g.find(k) for k in ("sphere", "capsule", "cylinder", "box",
                                                         "mesh"))
        if sph is not None:
            geoms.append(("sphere", p.copy(), float(sph.get("radius"))))
        elif cap is not None or cyl is not None:
            e = cap if cap is not None else cyl
            half = 0.5 * float(e.get("length"))
            geoms.append(("capsule", p - half * R[:, 2], p + half * R[:, 2],
                          float(e.get("radius"))))
        elif box is not None:
            hx, hy, hz = 0.5 * _floats(box.get("size"), 3)
            geoms.append(("box", np.stack([R @ np.array([sx, sy, sz], np.float32) + p
                                           for sx in (-hx, hx) for sy in (-hy, hy)
                                           for sz in (-hz, hz)])))
        elif msh is not None:
            entry = _mesh_collision(msh, T, urdf_dir, max_points=mesh_max_points,
                                    link_name=lname)
            if entry is None:
                warnings.warn(f"<collision> mesh {msh.get('filename')!r} on link {lname!r} "
                              "skipped (unresolvable path or non-STL format)", stacklevel=2)
            else:
                geoms.append(entry)
    return geoms


def _visual_geoms(link, T_link) -> list:
    """The link's <visual> (else <collision>) primitives for a viewer,
    each {"type", "R", "p", ...its parameters} in the carrier body's
    frame."""
    geoms = []
    for el in link.findall("visual") or link.findall("collision"):
        g = el.find("geometry")
        if g is None:
            continue
        T = T_link @ _origin(el.find("origin"))
        base = {"R": T[:3, :3].copy(), "p": T[:3, 3].copy()}
        sph, cap, cyl, box, mesh = (g.find(k) for k in ("sphere", "capsule", "cylinder", "box",
                                                          "mesh"))
        if sph is not None:
            geoms.append({"type": "sphere", **base, "radius": float(sph.get("radius"))})
        elif cap is not None or cyl is not None:
            e = cap if cap is not None else cyl
            geoms.append({"type": "capsule" if cap is not None else "cylinder", **base,
                          "radius": float(e.get("radius")), "length": float(e.get("length"))})
        elif box is not None:
            geoms.append({"type": "box", **base, "size": _floats(box.get("size"), 3)})
        elif mesh is not None:
            geoms.append({"type": "mesh", **base, "filename": mesh.get("filename") or "",
                          "scale": _floats(mesh.get("scale"), 3, default=1.0)})
    return geoms


def parse_urdf(source: str | Path, freeflyer: bool = False, gravity=(0.0, 0.0, -9.81),
               mesh_max_points: int = 32) -> tuple[TreeBuilder, dict]:
    """A URDF file path or XML string as a :class:`TreeBuilder`, and
    ``info`` mapping each link name to ("body", index) or ("frame",
    index). ``freeflyer=True`` roots the robot on a FREE joint named
    ``root_joint``; otherwise the root link is fixed to the world. The
    builder also carries ``urdf_collisions`` {link: (carrier body,
    geometry)}, ``urdf_visuals`` {body: [geometry]} and ``urdf_dir``."""
    text = str(source)
    urdf_dir = None
    if "<robot" not in text:
        urdf_dir = Path(source).resolve().parent
        text = Path(source).read_text()
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"not a URDF: root tag {root.tag!r}")

    links = {link.get("name"): link for link in root.findall("link")}
    joints = list(root.findall("joint"))
    for j in joints:
        if j.find("mimic") is not None:
            raise ValueError(f"mimic joints unsupported: {j.get('name')}")
        if j.get("type") not in _JOINT_MAP and j.get("type") != "fixed":
            raise ValueError(f"unsupported joint type {j.get('type')!r}: {j.get('name')}")

    children: dict[str, list] = {}  # parent link → [(joint, child link)]
    for j in joints:
        children.setdefault(j.find("parent").get("link"), []).append(
            (j, j.find("child").get("link")))
    child_links = {c for kids in children.values() for _, c in kids}
    roots = [n for n in links if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, got {roots}")
    root_link = roots[0]

    b = TreeBuilder(gravity=gravity)
    info: dict[str, tuple[str, int]] = {}
    carrier: dict[str, tuple[int, np.ndarray]] = {}  # link → (body carrying it, offset)
    if freeflyer:
        mass, com, inertia = _inertial(links[root_link])
        idx = b.add_body(root_link, -1, JointType.FREE, mass=mass, com=com, inertia=inertia,
                         joint_name="root_joint")
        info[root_link] = ("body", idx)
        carrier[root_link] = (idx, np.eye(4, dtype=np.float32))
        b.add_frame(root_link + "_frame", idx)
    else:  # the root link is fixed to the world, its inertia dropped
        info[root_link] = ("frame", b.fuse_fixed_body(root_link, -1, np.eye(4, dtype=np.float32)))
        carrier[root_link] = (-1, np.eye(4, dtype=np.float32))

    stack = [root_link]  # depth first, the last-pushed child first
    while stack:
        parent_link = stack.pop()
        p_body, p_off = carrier[parent_link]
        for j, child in children.get(parent_link, []):
            T = p_off @ _origin(j.find("origin"))
            mass, com, inertia = _inertial(links[child])
            jtype = j.get("type")
            if jtype == "fixed":
                if p_body < 0:
                    f = b.fuse_fixed_body(child, -1, T)
                else:
                    f = b.fuse_fixed_body(child, p_body, T, mass=mass, com=com, inertia=inertia)
                info[child] = ("frame", f)
                carrier[child] = (p_body, T)
            else:
                axis_e = j.find("axis")
                axis = (_floats(axis_e.get("xyz"), 3) if axis_e is not None
                        else np.array([1.0, 0.0, 0.0], np.float32))
                lim = j.find("limit")
                kwargs = {}
                if lim is not None and jtype in ("revolute", "prismatic"):
                    kwargs["q_limits"] = (float(lim.get("lower", -1e6)),
                                          float(lim.get("upper", 1e6)))
                if lim is not None:
                    kwargs["u_max"] = float(lim.get("effort", 1e6))
                    kwargs["v_max"] = float(lim.get("velocity", 1e6))
                dyn = j.find("dynamics")
                idx = b.add_body(
                    child, p_body, _JOINT_MAP[jtype], placement=T, axis=axis, mass=mass,
                    com=com, inertia=inertia, joint_name=j.get("name"),
                    damping=float(dyn.get("damping", 0.0)) if dyn is not None else 0.0,
                    **kwargs,
                )
                info[child] = ("body", idx)
                carrier[child] = (idx, np.eye(4, dtype=np.float32))
                b.add_frame(child + "_frame", idx)
            stack.append(child)

    b.urdf_dir = urdf_dir
    b.urdf_collisions = {}
    b.urdf_visuals = {}
    for lname, link in links.items():
        if lname not in carrier:
            continue
        body, T_link = carrier[lname]
        geoms = _collision_geoms(link, T_link, urdf_dir, mesh_max_points, lname)
        if geoms:
            b.urdf_collisions[lname] = (body, geoms)
        visuals = _visual_geoms(link, T_link)
        if visuals:
            b.urdf_visuals.setdefault(body, []).extend(visuals)
    return b, info


def load_urdf(source: str | Path, freeflyer: bool = False, gravity=(0.0, 0.0, -9.81),
              device="cuda", dtype=torch.float32) -> KinematicTree:
    """:func:`parse_urdf` and build in one call."""
    b, _ = parse_urdf(source, freeflyer=freeflyer, gravity=gravity)
    return b.build(device=device, dtype=dtype)
