"""3-D replay viewer: shaded robot geometry, orbit camera, video.

Counterpart of ``jiminy_tpu/viewer3d.py`` (numpy, HTML and PIL: the
port's own copy). A zero-dependency pipeline for headless hosts:

- display geometry from URDF ``<visual>``/``<collision>`` primitives
  (sphere/capsule/cylinder/box) and binary/ASCII STL meshes
  (:func:`jiminy_tpu_torch.io.stl.read_stl`), tessellated into triangle
  meshes shared by both outputs;
- ``replay_html3d``: a standalone HTML file with a software-rendered
  perspective view (drag to orbit, shift-drag to pan, wheel to zoom,
  time scrubber, playback speed), no WebGL, no server, no assets;
- ``render_frame3d`` / ``record_gif3d``: the same painter's-algorithm
  renderer rasterized to a numpy frame (the reference draws it with PIL;
  here PIL is imported only by the GIF writers), or to a GIF.

Robots without display geometry get an auto-generated skeleton of
capsules (mass-scaled radii). The forward kinematics run in the port's
:mod:`~jiminy_tpu_torch.core.algos` over the whole trajectory at once,
and a ground is queried through its own ``query``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.io.stl import read_stl
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.viewer import as_numpy, trajectory_kinematics


def _ground_heights(ground, xy: np.ndarray) -> np.ndarray:
    """Heights (N,) of ``ground`` at the points ``xy`` (N, 2), queried in
    float32 on the CPU."""
    g = ground.to(device="cpu", dtype=torch.float32)
    h, _ = g.query(torch.as_tensor(np.asarray(xy), dtype=torch.float32))
    return h.numpy()


# ---------------------------------------------------------------------------
# primitive tessellation (numpy; shared by HTML payload and GIF renderer)
# ---------------------------------------------------------------------------


def _frame_from_axis(axis: np.ndarray) -> np.ndarray:
    """Orthonormal frame (3,3 columns) with column 2 along ``axis``."""
    z = axis / max(np.linalg.norm(axis), 1e-12)
    ref = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9 else np.array(
        [1.0, 0.0, 0.0]
    )
    x = np.cross(ref, z)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def uv_sphere(radius: float, center, rings: int = 6, segs: int = 10):
    """Latitude/longitude sphere mesh → (verts (n,3), faces (m,3))."""
    c = np.asarray(center, np.float64)
    verts = [c + [0, 0, radius]]
    for i in range(1, rings):
        phi = np.pi * i / rings
        for j in range(segs):
            th = 2 * np.pi * j / segs
            verts.append(
                c
                + radius
                * np.array(
                    [
                        np.sin(phi) * np.cos(th),
                        np.sin(phi) * np.sin(th),
                        np.cos(phi),
                    ]
                )
            )
    verts.append(c + [0, 0, -radius])
    faces = []
    for j in range(segs):
        faces.append((0, 1 + j, 1 + (j + 1) % segs))
    for i in range(rings - 2):
        a, b = 1 + i * segs, 1 + (i + 1) * segs
        for j in range(segs):
            j2 = (j + 1) % segs
            faces.append((a + j, b + j, b + j2))
            faces.append((a + j, b + j2, a + j2))
    last = len(verts) - 1
    a = 1 + (rings - 2) * segs
    for j in range(segs):
        faces.append((last, a + (j + 1) % segs, a + j))
    return np.asarray(verts), np.asarray(faces, np.int32)


def tube(p0, p1, radius: float, segs: int = 10, caps: str = "round"):
    """Capsule (``caps="round"``) or cylinder (``caps="flat"``) from p0
    to p1 → (verts, faces)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    F = _frame_from_axis(p1 - p0)
    ring = [
        F[:, 0] * np.cos(2 * np.pi * j / segs)
        + F[:, 1] * np.sin(2 * np.pi * j / segs)
        for j in range(segs)
    ]
    verts = [p0 + radius * r for r in ring] + [p1 + radius * r for r in ring]
    faces = []
    for j in range(segs):
        j2 = (j + 1) % segs
        faces.append((j, segs + j, segs + j2))
        faces.append((j, segs + j2, j2))
    if caps == "round":
        # hemispherical end caps: one mid ring + tip vertex each
        z = F[:, 2]
        for end, (p, sgn) in enumerate(((p0, -1.0), (p1, 1.0))):
            base = 0 if end == 0 else segs
            mid_start = len(verts)
            for j in range(segs):
                v = 0.7071 * radius * ring[j] + sgn * 0.7071 * radius * z
                verts.append(p + v)
            tip = len(verts)
            verts.append(p + sgn * radius * z)
            for j in range(segs):
                j2 = (j + 1) % segs
                if sgn > 0:
                    faces.append((base + j, mid_start + j, mid_start + j2))
                    faces.append((base + j, mid_start + j2, base + j2))
                    faces.append((mid_start + j, tip, mid_start + j2))
                else:
                    faces.append((base + j, mid_start + j2, mid_start + j))
                    faces.append((base + j, base + j2, mid_start + j2))
                    faces.append((mid_start + j, mid_start + j2, tip))
    else:
        # flat disks
        for end, (p, sgn) in enumerate(((p0, -1.0), (p1, 1.0))):
            base = 0 if end == 0 else segs
            ci = len(verts)
            verts.append(p)
            for j in range(segs):
                j2 = (j + 1) % segs
                if sgn > 0:
                    faces.append((base + j, ci, base + j2))
                else:
                    faces.append((base + j, base + j2, ci))
    # construction above is consistently inward-wound; flip to outward
    return np.asarray(verts), np.asarray(faces, np.int32)[:, [0, 2, 1]]


def box_mesh(R, p, size):
    """Oriented box (size = full extents) → (verts (8,3), faces (12,3))."""
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    h = 0.5 * np.asarray(size, np.float64)
    verts = np.array(
        [
            R @ (h * np.array([sx, sy, sz])) + p
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ]
    )
    # index layout: bit2=x, bit1=y, bit0=z
    faces = np.array(
        [
            (0, 1, 3), (0, 3, 2),  # -x
            (4, 7, 5), (4, 6, 7),  # +x
            (0, 5, 1), (0, 4, 5),  # -y
            (2, 3, 7), (2, 7, 6),  # +y
            (0, 2, 6), (0, 6, 4),  # -z
            (1, 5, 7), (1, 7, 3),  # +z
        ],
        np.int32,
    )
    return verts, faces


def _decimate(verts, faces, max_tris: int):
    """Crude stride decimation — keeps silhouettes recognisable while
    bounding payload size (viewer fidelity, not collision accuracy)."""
    if len(faces) <= max_tris:
        return verts, faces
    stride = int(np.ceil(len(faces) / max_tris))
    faces = faces[::stride]
    used, inv = np.unique(faces, return_inverse=True)
    return verts[used], inv.reshape(-1, 3).astype(np.int32)


# ---------------------------------------------------------------------------
# display geometry per body
# ---------------------------------------------------------------------------


def geometry_from_visuals(
    visuals: dict, mesh_dir: str | Path | None = None, max_tris: int = 1500
) -> dict[int, list]:
    """URDF visual dicts (io/urdf.py ``urdf_visuals``) → triangle meshes
    per body index. Mesh files resolve relative to ``mesh_dir``;
    ``package://`` prefixes are stripped. Unresolvable meshes are
    skipped (the auto-skeleton fills any body left empty)."""
    out: dict[int, list] = {}
    for body, geoms in visuals.items():
        for g in geoms:
            R = np.asarray(g.get("R", np.eye(3)), np.float64)
            p = np.asarray(g.get("p", np.zeros(3)), np.float64)
            t = g["type"]
            if t == "sphere":
                v, f = uv_sphere(g["radius"], p)
            elif t in ("capsule", "cylinder"):
                half = 0.5 * g["length"]
                z = R[:, 2]
                v, f = tube(
                    p - half * z,
                    p + half * z,
                    g["radius"],
                    caps="round" if t == "capsule" else "flat",
                )
            elif t == "box":
                v, f = box_mesh(R, p, g["size"])
            elif t == "mesh":
                fn = g.get("filename", "")
                fn = fn.removeprefix("package://")
                cands = [Path(fn)]
                if mesh_dir is not None:
                    cands += [
                        Path(mesh_dir) / fn,
                        Path(mesh_dir) / Path(fn).name,
                    ]
                path = next((c for c in cands if c.is_file()), None)
                if path is None or path.suffix.lower() != ".stl":
                    continue
                v, f = read_stl(path, g.get("scale", 1.0))
                v = v @ R.T + p
                v, f = _decimate(v, f, max_tris)
            else:
                continue
            out.setdefault(body, []).append((v, f))
    return out


def auto_skeleton_geometry(tree: KinematicTree) -> dict[int, list]:
    """Mass-scaled capsule skeleton for bodies without display geometry:
    a capsule from each body origin to each child joint origin, plus a
    sphere at every body origin (and toward the CoM for leaves)."""
    jp_pos = tree.jp_pos.cpu().numpy()
    masses = tree.inertia_mass.cpu().numpy()
    hvec = tree.inertia_h.cpu().numpy()
    children: dict[int, list[int]] = {}
    for i in range(tree.nb):
        par = tree.parent[i]
        if par >= 0:
            children.setdefault(par, []).append(i)

    def radius(m):
        return float(np.clip(0.012 + 0.02 * m ** (1 / 3), 0.015, 0.06))

    out: dict[int, list] = {}
    for i in range(tree.nb):
        r = radius(masses[i])
        geoms = [uv_sphere(1.3 * r, np.zeros(3), rings=5, segs=8)]
        for c in children.get(i, []):
            tip = jp_pos[c]
            if np.linalg.norm(tip) > 1e-6:
                geoms.append(tube(np.zeros(3), tip, r, segs=8))
        if not children.get(i) and masses[i] > 0:
            com = hvec[i] / max(masses[i], 1e-9)
            if np.linalg.norm(com) > 0.02:
                geoms.append(tube(np.zeros(3), 2.0 * com, r, segs=8))
        out[i] = geoms
    return out


def display_geometry(
    tree: KinematicTree,
    visuals: dict | None = None,
    mesh_dir: str | Path | None = None,
) -> dict[int, list]:
    """Resolved per-body triangle meshes: URDF visuals where available,
    auto-skeleton for every body left without geometry."""
    geo = (
        geometry_from_visuals(visuals, mesh_dir) if visuals else {}
    )
    auto = auto_skeleton_geometry(tree)
    for i in range(tree.nb):
        if i not in geo:
            geo[i] = auto[i]
    return geo


# ---------------------------------------------------------------------------
# replay extraction
# ---------------------------------------------------------------------------


def extract_replay3d(
    tree: KinematicTree,
    qs,
    visuals: dict | None = None,
    mesh_dir: str | Path | None = None,
    forces=None,
    ground=None,
    dt: float | None = None,
    max_frames: int = 300,
) -> dict:
    """FK over a trajectory → JSON-able 3-D replay payload:
    per-body meshes (body frame), body poses (pos + quat xyzw) per
    frame, CoM, contact points, optional force arrows and a ground
    heightfield patch."""
    qs = as_numpy(qs)
    T = qs.shape[0]
    idx = np.linspace(0, T - 1, min(max_frames, T)).astype(int)
    xw, cps, com = trajectory_kinematics(tree, qs[idx])
    pos = torch.stack([x.pos for x in xw], dim=1).cpu().numpy()
    quat = torch.stack([so3.matrix_to_quat(x.rot) for x in xw], dim=1).cpu().numpy()
    geo = display_geometry(tree, visuals, mesh_dir)
    geoms = []
    for i in range(tree.nb):
        for v, f in geo.get(i, []):
            geoms.append(
                {
                    "body": i,
                    "v": np.asarray(v).round(4).tolist(),
                    "f": np.asarray(f).tolist(),
                }
            )
    out = {
        "geoms": geoms,
        "pos": pos.round(4).tolist(),
        "quat": quat.round(4).tolist(),
        "contacts": np.asarray(cps).round(4).tolist(),
        "com": np.asarray(com).round(4).tolist(),
        "body_names": list(tree.body_name),
        "frame_idx": idx.tolist(),
        "dt": float(dt) if dt else None,
    }
    if forces is not None and tree.ncp:
        f = as_numpy(forces)[idx]
        weight = float(tree.inertia_mass.sum()) * 9.81
        tips = np.asarray(cps) + f / max(weight, 1e-6) * 0.3
        out["force_tips"] = tips.round(4).tolist()
    if dt is not None and len(idx) > 2:
        # capture point marker (reference Viewer marker set): DCM from
        # finite-difference CoM velocity over the replay samples
        com_np = np.asarray(com, np.float64)
        t_s = idx.astype(np.float64) * float(dt)
        v_com = np.gradient(com_np, t_s, axis=0)
        omega = np.sqrt(np.maximum(com_np[:, 2], 1e-3) / 9.81)
        cp_xy = com_np[:, :2] + v_com[:, :2] * omega[:, None]
        if ground is not None:
            cp_z = _ground_heights(ground, cp_xy).astype(np.float64)
        else:
            cp_z = np.zeros(len(cp_xy))
        out["cp"] = np.column_stack([cp_xy, cp_z]).round(4).tolist()
    # ground heightfield patch under the trajectory footprint
    lo = pos.reshape(-1, 3).min(0) - 0.5
    hi = pos.reshape(-1, 3).max(0) + 0.5
    n = 25
    gx = np.linspace(lo[0], hi[0], n)
    gy = np.linspace(lo[1], hi[1], n)
    if ground is not None:
        X, Y = np.meshgrid(gx, gy, indexing="ij")
        Z = _ground_heights(ground, np.stack([X.ravel(), Y.ravel()], 1)).reshape(n, n)
    else:
        Z = np.zeros((n, n))
    out["ground"] = {
        "x": gx.round(3).tolist(),
        "y": gy.round(3).tolist(),
        "z": Z.round(3).tolist(),
    }
    return out


# ---------------------------------------------------------------------------
# shared camera / shading math (Python mirror of the JS renderer)
# ---------------------------------------------------------------------------


def _camera(az, el, dist, target):
    """→ (eye (3,), world→camera rotation (3,3); camera looks down -z)."""
    az, el = np.deg2rad(az), np.deg2rad(el)
    fwd = np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )
    eye = np.asarray(target, np.float64) + dist * fwd
    z = fwd  # camera z points from target to eye
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    return eye, np.stack([x, y, z])


_LIGHT = np.array([0.45, 0.3, 0.84])  # normalized-ish key light


# ---------------------------------------------------------------------------
# GIF / video recording (PIL painter renderer)
# ---------------------------------------------------------------------------


def record_gif3d(
    tree: KinematicTree,
    qs,
    path: str | Path,
    visuals: dict | None = None,
    mesh_dir=None,
    forces=None,
    ground=None,
    fps: int = 25,
    size: int = 480,
    max_frames: int = 120,
    azimuth: float = 35.0,
    elevation: float = 18.0,
    distance: float | None = None,
    turntable_deg_per_s: float = 0.0,
    color=(120, 170, 230),
    follow: bool = True,
) -> None:
    """Render a trajectory to an animated GIF with the 3-D shaded
    renderer (reference: Viewer video recording). ``turntable_deg_per_s``
    orbits the camera during playback; ``follow`` keeps the camera
    tracking the floating base (the reference's camera-follow)."""
    data = extract_replay3d(
        tree, qs, visuals=visuals, mesh_dir=mesh_dir, forces=forces,
        ground=ground, max_frames=max_frames,
    )
    pos = np.asarray(data["pos"])
    if follow:
        # tracking camera: frame the ROBOT (per-frame body extent), not
        # the whole travelled path — the reference Viewer's camera-
        # follow behavior for locomotion replays
        robot_span = float(np.max(pos.max(1) - pos.min(1)))
        dist = distance or max(2.2 * robot_span + 0.8, 1.5)
        centers = pos[:, 0]
    else:
        center = pos.reshape(-1, 3).mean(0)
        span = float(
            np.max(pos.reshape(-1, 3).max(0) - pos.reshape(-1, 3).min(0))
        )
        dist = distance or max(1.5 * span + 1.0, 1.5)
        centers = np.repeat(center[None], len(pos), axis=0)
    from PIL import Image

    imgs = [
        Image.fromarray(_paint_frame(
            data, fi, size=size,
            azimuth=azimuth + turntable_deg_per_s * fi / fps,
            elevation=elevation, distance=dist, center=centers[fi],
            color=color,
        ))
        for fi in range(len(pos))
    ]
    imgs[0].save(
        str(path), save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )


class _Canvas:
    """An RGB image as a numpy array with the few drawing calls the frame
    renderer makes (the subset of PIL's ImageDraw it used): filled
    polygons, polylines and ellipses, pixel centres at integer + 0.5."""

    def __init__(self, size: int, background):
        self.img = np.empty((size, size, 3), np.uint8)
        self.img[:] = background
        self.size = size

    def _box(self, x0, y0, x1, y1):
        """Pixel rows and columns (as index arrays) meeting the box, or
        None when it lies outside."""
        i0, i1 = max(int(np.floor(y0)), 0), min(int(np.ceil(y1)) + 1, self.size)
        j0, j1 = max(int(np.floor(x0)), 0), min(int(np.ceil(x1)) + 1, self.size)
        if i0 >= i1 or j0 >= j1:
            return None
        return np.arange(i0, i1)[:, None] + 0.5, np.arange(j0, j1)[None, :] + 0.5

    def _fill(self, yy, xx, mask, fill):
        i, j = int(yy[0, 0]), int(xx[0, 0])
        self.img[i:i + mask.shape[0], j:j + mask.shape[1]][mask] = fill

    def polygon(self, pts, fill) -> None:
        """A filled triangle or convex polygon."""
        p = np.asarray(pts, np.float64)
        box = self._box(*p.min(0), *p.max(0))
        if box is None:
            return
        yy, xx = box
        inside_pos = np.ones((yy.shape[0], xx.shape[1]), bool)
        inside_neg = inside_pos.copy()
        for a, b in zip(p, np.roll(p, -1, axis=0)):
            c = (b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])
            inside_pos &= c >= 0
            inside_neg &= c <= 0
        self._fill(yy, xx, inside_pos | inside_neg, fill)

    def line(self, pts, fill, width: int = 1) -> None:
        """A polyline through ``pts``, ``width`` pixels wide."""
        p = np.asarray(pts, np.float64)
        r = 0.5 * width
        for a, b in zip(p[:-1], p[1:]):
            box = self._box(min(a[0], b[0]) - r, min(a[1], b[1]) - r,
                            max(a[0], b[0]) + r, max(a[1], b[1]) + r)
            if box is None:
                continue
            yy, xx = box
            ab = b - a
            t = np.clip(((xx - a[0]) * ab[0] + (yy - a[1]) * ab[1]) / max(ab @ ab, 1e-12), 0, 1)
            dist2 = (xx - a[0] - t * ab[0]) ** 2 + (yy - a[1] - t * ab[1]) ** 2
            self._fill(yy, xx, dist2 <= r * r + 0.25, fill)

    def ellipse(self, box, fill=None, outline=None, width: int = 1) -> None:
        """The ellipse inscribed in ``box`` [x0, y0, x1, y1], filled and/or
        outlined ``width`` pixels wide."""
        x0, y0, x1, y1 = box
        pix = self._box(x0, y0, x1, y1)
        if pix is None:
            return
        yy, xx = pix
        cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        rx, ry = max(0.5 * (x1 - x0), 1e-6), max(0.5 * (y1 - y0), 1e-6)
        rho = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
        if fill is not None:
            self._fill(yy, xx, rho <= 1.0, fill)
        if outline is not None:
            self._fill(yy, xx, (rho <= 1.0) & (rho >= 1.0 - width / min(rx, ry)), outline)


def _quat_mat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _paint_frame(
    data: dict,
    fi: int,
    size: int = 480,
    azimuth: float = 35.0,
    elevation: float = 18.0,
    distance: float | None = None,
    center=None,
    color=(120, 170, 230),
):
    """Rasterize one frame of an extract_replay3d payload → (size, size,
    3) uint8 array (painter's algorithm, flat shading; mirror of the HTML
    renderer), drawn by :class:`_Canvas` in numpy alone."""

    pos = np.asarray(data["pos"])
    quat = np.asarray(data["quat"])
    com = np.asarray(data["com"])
    cps = np.asarray(data["contacts"])
    tips = np.asarray(data.get("force_tips", []))
    meshes = [
        (g["body"], np.asarray(g["v"]), np.asarray(g["f"], np.int32))
        for g in data["geoms"]
    ]
    if center is None:
        center = pos.reshape(-1, 3).mean(0)
    if distance is None:
        span = float(
            np.max(pos.reshape(-1, 3).max(0) - pos.reshape(-1, 3).min(0))
        )
        distance = max(1.5 * span + 1.0, 1.5)
    gx = np.asarray(data["ground"]["x"])
    gy = np.asarray(data["ground"]["y"])
    gz = np.asarray(data["ground"]["z"])
    f_scale = size * 1.2  # focal length in px

    eye, Rc = _camera(azimuth, elevation, distance, center)
    d = _Canvas(size, (24, 26, 30))

    def project(pw):
        pc = (pw - eye) @ Rc.T
        zc = np.maximum(-pc[..., 2], 1e-3)
        return (
            size / 2 + f_scale * pc[..., 0] / zc,
            size / 2 - f_scale * pc[..., 1] / zc,
            zc,
        )

    # ground wireframe
    for i in range(0, len(gx), 2):
        line = np.stack([np.full_like(gy, gx[i]), gy, gz[i, :]], axis=1)
        xs, ys, _ = project(line)
        d.line(list(zip(xs, ys)), fill=(58, 62, 68), width=1)
    for j in range(0, len(gy), 2):
        line = np.stack([gx, np.full_like(gx, gy[j]), gz[:, j]], axis=1)
        xs, ys, _ = project(line)
        d.line(list(zip(xs, ys)), fill=(58, 62, 68), width=1)

    # collect shaded triangles
    tris = []
    for body, v, fcs in meshes:
        R = _quat_mat(quat[fi][body])
        vw = v @ R.T + pos[fi][body]
        xs, ys, zs = project(vw)
        p2 = np.stack([xs, ys], 1)
        a, b, c = vw[fcs[:, 0]], vw[fcs[:, 1]], vw[fcs[:, 2]]
        n = np.cross(b - a, c - a)
        nn = n / np.maximum(
            np.linalg.norm(n, axis=1, keepdims=True), 1e-12
        )
        # backface cull in world space against the view ray
        view = (a + b + c) / 3 - eye
        front = np.einsum("ij,ij->i", nn, view) < 0
        shade = 0.35 + 0.65 * np.clip(nn @ _LIGHT, 0, 1)
        depth = (zs[fcs[:, 0]] + zs[fcs[:, 1]] + zs[fcs[:, 2]]) / 3
        for k in np.nonzero(front)[0]:
            col = tuple(int(cc * shade[k]) for cc in color)
            tris.append(
                (
                    depth[k],
                    [
                        tuple(p2[fcs[k, 0]]),
                        tuple(p2[fcs[k, 1]]),
                        tuple(p2[fcs[k, 2]]),
                    ],
                    col,
                )
            )
    tris.sort(key=lambda t: -t[0])
    for _, poly, col in tris:
        d.polygon(poly, fill=col)

    # markers
    if len(tips):
        for k in range(cps.shape[1]):
            x0, y0, _ = project(cps[fi][k])
            x1, y1, _ = project(tips[fi][k])
            d.line([(x0, y0), (x1, y1)], fill=(255, 136, 0), width=2)
    for k in range(cps.shape[1] if cps.ndim == 3 else 0):
        x, y, _ = project(cps[fi][k])
        d.ellipse([x - 2, y - 2, x + 2, y + 2], fill=(255, 204, 102))
    x, y, _ = project(com[fi])
    d.ellipse([x - 4, y - 4, x + 4, y + 4], fill=(85, 221, 85))
    if "cp" in data:
        x, y, _ = project(np.asarray(data["cp"][fi]))
        d.ellipse([x - 3, y - 3, x + 3, y + 3], outline=(221, 85, 221),
                  width=2)
    return d.img


def render_frame3d(
    robot_or_tree,
    q,
    size: int = 480,
    ground=None,
    azimuth: float = 35.0,
    elevation: float = 18.0,
    distance: float | None = None,
) -> np.ndarray:
    """Render ONE configuration to an (H, W, 3) uint8 array — the gym
    adapter's ``render()`` frame (reference: Viewer.capture_frame)."""
    tree = getattr(robot_or_tree, "tree", robot_or_tree)
    visuals = getattr(robot_or_tree, "visuals", None)
    data = extract_replay3d(
        tree, as_numpy(q)[None], visuals=visuals, ground=ground,
        max_frames=1,
    )
    return _paint_frame(
        data, 0, size=size, azimuth=azimuth, elevation=elevation,
        distance=distance,
    )


def env_ground(env, info: dict, i: int = 0):
    """Env ``i``'s ground in a batch: its own terrain from ``info["ground"]``
    when the env draws one per episode, else the engine's ground (None
    without an engine)."""
    ground = getattr(getattr(env, "engine", None), "ground", None)
    if ground is not None and "ground" in info:
        ground = type(ground).from_coef(info["ground"][i], ground)
    return ground


def render_env(env, state, i: int = 0, size: int = 400) -> np.ndarray:
    """Env ``i`` of a batched env state as one (size, size, 3) uint8 frame,
    on its own ground (the gym adapter's ``render``)."""
    robot = getattr(env, "robot", None) or env.tree
    return render_frame3d(robot, state.sim.q[i], size=size,
                          ground=env_ground(env, getattr(state, "info", {}), i))


# ---------------------------------------------------------------------------
# standalone HTML viewer
# ---------------------------------------------------------------------------

_HTML3D = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>__TITLE__</title><style>
body{font-family:sans-serif;background:#101216;color:#dde;margin:1em}
canvas{background:#181a1e;border:1px solid #333;border-radius:8px;cursor:grab}
.lbl{color:#889;font-size:12px} input[type=range]{width:50%}
button{background:#23262c;color:#dde;border:1px solid #444;border-radius:4px}
</style></head><body>
<h3 style="margin:.2em 0">__TITLE__</h3>
<div class="lbl">drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
<canvas id="cv" width="860" height="560"></canvas>
<p><button id="play">&#9199;</button>
<input type="range" id="t" min="0" value="0">
speed <select id="spd"><option>0.25</option><option selected>1</option>
<option>2</option><option>4</option></select>&times;
<button id="rst">reset view</button>
<label class="lbl"><input type="checkbox" id="flw" checked> follow</label>
<span id="info" class="lbl"></span></p>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), g = cv.getContext('2d');
const P = D.pos, Q = D.quat, G = D.geoms, C = D.contacts;
const L = [0.45, 0.3, 0.84];
let allp = P.flat();
let ctr = [0,0,0];
for (const p of allp) for (let k=0;k<3;k++) ctr[k]+=p[k]/allp.length;
// per-frame robot extent (for the follow camera), global extent (fixed)
let rspan = 0.5;
for (const fr of P){
 let l=[1e9,1e9,1e9], h=[-1e9,-1e9,-1e9];
 for (const p of fr) for (let k=0;k<3;k++){l[k]=Math.min(l[k],p[k]);h[k]=Math.max(h[k],p[k]);}
 rspan = Math.max(rspan, h[0]-l[0], h[1]-l[1], h[2]-l[2]);
}
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for (const p of allp) for (let k=0;k<3;k++){lo[k]=Math.min(lo[k],p[k]);hi[k]=Math.max(hi[k],p[k]);}
const span = Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],0.5);
const cam0 = {az: 35, el: 18, dist: 2.2*rspan+0.8, tgt: [0,0,0]};
let cam = JSON.parse(JSON.stringify(cam0));
let follow = true;
function camTarget(f){
 if (!follow) return [ctr[0]+cam.tgt[0],ctr[1]+cam.tgt[1],ctr[2]+cam.tgt[2]];
 const b = P[f][0];
 return [b[0]+cam.tgt[0], b[1]+cam.tgt[1], b[2]+cam.tgt[2]];
}
function quatMat(q){const [x,y,z,w]=q;return [
 [1-2*(y*y+z*z),2*(x*y-z*w),2*(x*z+y*w)],
 [2*(x*y+z*w),1-2*(x*x+z*z),2*(y*z-x*w)],
 [2*(x*z-y*w),2*(y*z+x*w),1-2*(x*x+y*y)]];}
function camBasis(fi){
 const tgt = camTarget(fi===undefined ? +slider.value : fi);
 const az=cam.az*Math.PI/180, el=cam.el*Math.PI/180;
 const f=[Math.cos(el)*Math.cos(az),Math.cos(el)*Math.sin(az),Math.sin(el)];
 const eye=[tgt[0]+cam.dist*f[0],tgt[1]+cam.dist*f[1],tgt[2]+cam.dist*f[2]];
 const z=f; let x=[-z[1],z[0],0];
 const n=Math.hypot(x[0],x[1])||1e-9; x=[x[0]/n,x[1]/n,0];
 const y=[z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
 return {eye,x,y,z};
}
const fl = 1.2*Math.min(cv.width,cv.height);
function project(p,B){
 const d=[p[0]-B.eye[0],p[1]-B.eye[1],p[2]-B.eye[2]];
 const xc=d[0]*B.x[0]+d[1]*B.x[1]+d[2]*B.x[2];
 const yc=d[0]*B.y[0]+d[1]*B.y[1]+d[2]*B.y[2];
 const zc=-(d[0]*B.z[0]+d[1]*B.z[1]+d[2]*B.z[2]);
 const z=Math.max(zc,1e-3);
 return [cv.width/2+fl*xc/z, cv.height/2-fl*yc/z, z];
}
function draw(f){
 g.clearRect(0,0,cv.width,cv.height);
 const B=camBasis(f);
 // ground wireframe
 g.strokeStyle='#3a3e44'; g.lineWidth=1; g.beginPath();
 const gx=D.ground.x, gy=D.ground.y, gz=D.ground.z;
 for (let i=0;i<gx.length;i+=2){
  for (let j=0;j<gy.length;j++){
   const p=project([gx[i],gy[j],gz[i][j]],B);
   j?g.lineTo(p[0],p[1]):g.moveTo(p[0],p[1]);}}
 for (let j=0;j<gy.length;j+=2){
  for (let i=0;i<gx.length;i++){
   const p=project([gx[i],gy[j],gz[i][j]],B);
   i?g.lineTo(p[0],p[1]):g.moveTo(p[0],p[1]);}}
 g.stroke();
 // shaded robot triangles, painter-sorted
 const tris=[];
 for (const m of G){
  const R=quatMat(Q[f][m.body]), t=P[f][m.body];
  const vw=m.v.map(v=>[
   R[0][0]*v[0]+R[0][1]*v[1]+R[0][2]*v[2]+t[0],
   R[1][0]*v[0]+R[1][1]*v[1]+R[1][2]*v[2]+t[1],
   R[2][0]*v[0]+R[2][1]*v[1]+R[2][2]*v[2]+t[2]]);
  const pr=vw.map(v=>project(v,B));
  for (const [a,b,c] of m.f){
   const A=vw[a],Bv=vw[b],Cv=vw[c];
   const u=[Bv[0]-A[0],Bv[1]-A[1],Bv[2]-A[2]];
   const w=[Cv[0]-A[0],Cv[1]-A[1],Cv[2]-A[2]];
   let n=[u[1]*w[2]-u[2]*w[1],u[2]*w[0]-u[0]*w[2],u[0]*w[1]-u[1]*w[0]];
   const nl=Math.hypot(...n)||1e-12; n=[n[0]/nl,n[1]/nl,n[2]/nl];
   const mid=[(A[0]+Bv[0]+Cv[0])/3,(A[1]+Bv[1]+Cv[1])/3,(A[2]+Bv[2]+Cv[2])/3];
   const view=[mid[0]-B.eye[0],mid[1]-B.eye[1],mid[2]-B.eye[2]];
   if (n[0]*view[0]+n[1]*view[1]+n[2]*view[2] >= 0) continue;
   const sh=0.35+0.65*Math.max(0,n[0]*L[0]+n[1]*L[1]+n[2]*L[2]);
   tris.push([(pr[a][2]+pr[b][2]+pr[c][2])/3,
    [pr[a],pr[b],pr[c]],
    `rgb(${120*sh|0},${170*sh|0},${230*sh|0})`]);
  }
 }
 tris.sort((a,b)=>b[0]-a[0]);
 for (const [,p,col] of tris){
  g.fillStyle=col; g.beginPath();
  g.moveTo(p[0][0],p[0][1]); g.lineTo(p[1][0],p[1][1]); g.lineTo(p[2][0],p[2][1]);
  g.closePath(); g.fill();
 }
 // markers
 if (D.force_tips){
  g.strokeStyle='#f80'; g.lineWidth=2; g.beginPath();
  for (let k=0;k<(C[f]||[]).length;k++){
   const a=project(C[f][k],B), b=project(D.force_tips[f][k],B);
   g.moveTo(a[0],a[1]); g.lineTo(b[0],b[1]);}
  g.stroke();
 }
 g.fillStyle='#fc6';
 for (const c of (C[f]||[])){
  const p=project(c,B);
  g.beginPath(); g.arc(p[0],p[1],3,0,7); g.fill();}
 g.fillStyle='#5d5';
 const cm=project(D.com[f],B);
 g.beginPath(); g.arc(cm[0],cm[1],4,0,7); g.fill();
 if (D.cp){
  g.strokeStyle='#d5d'; g.lineWidth=2;
  const cp=project(D.cp[f],B);
  g.beginPath(); g.arc(cp[0],cp[1],3,0,7); g.stroke();
 }
 const rtf = D.dt ? ' · sim t='+(D.frame_idx[f]*D.dt).toFixed(2)+'s' : '';
 document.getElementById('info').textContent='frame '+f+'/'+(P.length-1)+rtf;
}
const slider=document.getElementById('t'); slider.max=P.length-1;
slider.oninput=()=>draw(+slider.value);
let playing=null;
function tick(){slider.value=(+slider.value+1)%P.length; draw(+slider.value);}
document.getElementById('play').onclick=()=>{
 if(playing){clearInterval(playing);playing=null;return;}
 const sp=+document.getElementById('spd').value;
 playing=setInterval(tick,40/sp);};
document.getElementById('spd').onchange=()=>{
 if(playing){clearInterval(playing);
  playing=setInterval(tick,40/+document.getElementById('spd').value);}};
document.getElementById('rst').onclick=()=>{
 cam=JSON.parse(JSON.stringify(cam0)); draw(+slider.value);};
document.getElementById('flw').onchange=e=>{
 follow=e.target.checked; cam.tgt=[0,0,0];
 cam.dist=follow ? 2.2*rspan+0.8 : 1.5*span+1.0;
 draw(+slider.value);};
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{
 if(!drag) return;
 const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 if (drag[2]){ // pan in camera plane
  const B=camBasis(), s=cam.dist/fl;
  for (let k=0;k<3;k++) cam.tgt[k]+=(-dx*B.x[k]+dy*B.y[k])*s;
 } else { cam.az-=dx*0.5; cam.el=Math.max(-89,Math.min(89,cam.el+dy*0.4)); }
 drag=[e.clientX,e.clientY,drag[2]]; draw(+slider.value);
};
cv.onwheel=e=>{e.preventDefault();
 cam.dist*=Math.exp(e.deltaY*0.001); draw(+slider.value);};
draw(0);
</script></body></html>
"""


def replay_html3d(
    robot_or_tree,
    qs,
    path: str | Path,
    title: str = "jiminy_tpu 3-D replay",
    mesh_dir=None,
    forces=None,
    ground=None,
    dt: float | None = None,
    max_frames: int = 300,
) -> None:
    """Write a standalone interactive 3-D replay (orbit camera, shaded
    geometry, scrubber) of a (T, nq) trajectory. Accepts a Robot (uses
    its URDF display geometry) or a bare KinematicTree (auto-skeleton).
    """
    tree = getattr(robot_or_tree, "tree", robot_or_tree)
    visuals = getattr(robot_or_tree, "visuals", None)
    data = extract_replay3d(
        tree, qs, visuals=visuals, mesh_dir=mesh_dir, forces=forces,
        ground=ground, dt=dt, max_frames=max_frames,
    )
    html = _HTML3D.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(data)
    )
    Path(path).write_text(html)


def replay3d_from_log(
    robot_or_tree, log, path: str | Path, **kw
) -> None:
    """3-D replay straight from a TelemetryLog containing q.* columns
    (reference: extract_replay_data_from_log + play_trajectories)."""
    tree = getattr(robot_or_tree, "tree", robot_or_tree)
    cols = [c for c in log.columns if c.startswith("q.")]
    cols.sort(key=lambda c: int(c.split(".")[1]))
    qs = np.stack([np.asarray(log.columns[c]) for c in cols], axis=1)
    del tree
    replay_html3d(robot_or_tree, qs, path, **kw)
