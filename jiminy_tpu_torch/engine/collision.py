"""Body-body and self-collision between primitive shapes, batched.

Counterpart of ``jiminy_tpu/engine/collision.py``. The pairs are declared
when the model is built (no broad phase: every env runs the same narrow
phases). A pair decomposes into contact generators, in the reference's
order:

- ``seg``: one closest-point contact between two segments swept by radii
  (sphere or capsule against sphere or capsule; a sphere is a capsule of
  zero length);
- ``ptbox``: k points with a common radius against an oriented box's
  exact signed distance (box-box: each box's corners against the other;
  capsule-box: 5 points along the axis; mesh-box: the support points);
- ``ptseg``: k points against a capsule (mesh against capsule or sphere;
  mesh-mesh: each cloud against the other's fitted capsule).

Each contact is one [t1, t2, n] block of PGS rows on the relative velocity
of the two surface points, with the ground contacts' Baumgarte and margin
activation; each pair is one PGS color (:func:`pair_rows`). The
whole-substep kernels run the same narrow phases in-kernel
(``csrc/substep.cuh`` ``jt_pair_contact``).

:func:`shape_for_link` turns a link's parsed URDF ``<collision>`` geometry
(``robot.Robot.collision_shapes``) into one of these shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.math.so3 import cross


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Sphere fixed to ``body`` (index or body name) at ``pos`` (body
    frame) with ``radius``."""

    body: int | str
    pos: tuple
    radius: float


@dataclasses.dataclass(frozen=True)
class Capsule:
    """Capsule fixed to ``body``: segment ``p0``→``p1`` (body frame)
    swept by ``radius``."""

    body: int | str
    p0: tuple
    p1: tuple
    radius: float


@dataclasses.dataclass(frozen=True)
class Box:
    """Oriented box fixed to ``body``: center ``pos`` (body frame),
    ``half_extents`` (hx, hy, hz), optional ``rot`` (row-major 3×3 in the
    body frame; None: axis-aligned)."""

    body: int | str
    pos: tuple
    half_extents: tuple
    rot: tuple | None = None


@dataclasses.dataclass(frozen=True)
class ConvexMesh:
    """Convex support-point cloud fixed to ``body`` and its fitted capsule
    ``(p0, p1, r)`` (None: fitted from the points, :func:`fit_capsule`)."""

    body: int | str
    points: tuple  # ((x, y, z), ...)
    capsule: tuple | None = None  # (p0, p1, r)


@dataclasses.dataclass(frozen=True)
class CollisionPair:
    """A declared pair of shapes tested every substep; ``friction``
    overrides the engine's contact friction for this pair (None: the
    engine's)."""

    a: Sphere | Capsule | Box | ConvexMesh
    b: Sphere | Capsule | Box | ConvexMesh
    friction: float | None = None


def shape_for_link(robot, link: str, index: int = 0, exact: bool = True):
    """The pair shape of entry ``index`` of a URDF link's ``<collision>``
    geometry (``robot.collision_shapes``): a sphere or capsule as it is;
    with ``exact`` a box as the oriented :class:`Box` rebuilt from its
    corners and a mesh as its :class:`ConvexMesh` of support points, else
    either as its fitted bounding :class:`Capsule`. E.g.
    ``CollisionPair(shape_for_link(r, "l_shin"), shape_for_link(r,
    "r_shin"))``."""
    if link not in robot.collision_shapes:
        raise ValueError(f"link {link!r} has no parsed <collision> geometry "
                         f"(available: {sorted(robot.collision_shapes)})")
    body, geoms = robot.collision_shapes[link]
    g = geoms[index]
    if g[0] == "sphere":
        return Sphere(body, tuple(np.asarray(g[1], np.float32)), float(g[2]))
    if g[0] == "capsule":
        return Capsule(body, tuple(np.asarray(g[1], np.float32)),
                       tuple(np.asarray(g[2], np.float32)), float(g[3]))
    if g[0] == "mesh":
        p0, p1, r = g[2]
        if exact:
            return ConvexMesh(body, tuple(map(tuple, np.asarray(g[1], np.float32))),
                              (tuple(p0), tuple(p1), float(r)))
        return Capsule(body, tuple(p0), tuple(p1), float(r))
    if g[0] == "box":
        corners = np.asarray(g[1], np.float64)  # (8, 3) in the body frame
        if not exact:
            p0, p1, r = fit_capsule(corners)
            return Capsule(body, tuple(p0), tuple(p1), float(r))
        # the corners' enumeration (x slowest, z fastest) fixes the edges
        c = corners.mean(axis=0)
        d = corners - c
        edges = (d[4] - d[0], d[2] - d[0], d[1] - d[0])
        R = np.stack([e / np.linalg.norm(e) for e in edges], axis=-1)
        h = 0.5 * np.array([np.linalg.norm(e) for e in edges])
        return Box(body, tuple(c.astype(np.float32)), tuple(h.astype(np.float32)),
                   tuple(map(tuple, R.astype(np.float32))))
    raise ValueError(f"unknown collision geometry kind {g[0]!r}")


def fit_capsule(v: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Bounding capsule (p0, p1, r) of a vertex cloud (k, 3): the segment
    along the principal axis, the radius the largest distance to it, the
    end caps pulled in by the radius when the cloud is elongated, else a
    sphere at the centroid (the reference's ``io/urdf.py`` ``_fit_capsule``,
    step for step)."""
    c = v.mean(axis=0)
    d = v - c
    _, vecs = np.linalg.eigh(d.T @ d)
    u = vecs[:, -1]
    t = d @ u
    r = float(np.sqrt(np.maximum(np.sum(d * d, axis=-1) - t * t, 0.0)).max())
    lo, hi = float(t.min()), float(t.max())
    if hi - lo > 2.0 * r:
        lo, hi = lo + r, hi - r
    else:
        lo = hi = 0.5 * (lo + hi)
    p0, p1 = c + lo * u, c + hi * u
    seg = p1 - p0
    denom = float(seg @ seg)
    s = np.clip(((v - p0) @ seg) / denom, 0.0, 1.0) if denom > 1e-12 else np.zeros(len(v))
    closest = p0 + s[:, None] * seg
    r = max(r, float(np.linalg.norm(v - closest, axis=-1).max()))
    return p0.astype(np.float32), p1.astype(np.float32), r


def _resolve_body(tree: KinematicTree, body: int | str) -> int:
    return tree.body_name.index(body) if isinstance(body, str) else int(body)


def _endpoints(shape):
    if isinstance(shape, Sphere):
        return shape.pos, shape.pos, shape.radius
    return shape.p0, shape.p1, shape.radius


def _seg_samples(shape, k: int = 5) -> np.ndarray:
    """(k, 3) points along a capsule's axis (one for a sphere)."""
    p0, p1, _ = _endpoints(shape)
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    if np.allclose(p0, p1):
        return p0[None]
    t = np.linspace(0.0, 1.0, k)[:, None]
    return p0[None] * (1.0 - t) + p1[None] * t


def _box_frame(box: Box):
    c = np.asarray(box.pos, np.float64)
    h = np.asarray(box.half_extents, np.float64)
    R = np.asarray(box.rot, np.float64).reshape(3, 3) if box.rot is not None else np.eye(3)
    return c, R, h


def _mesh_capsule(shape: ConvexMesh):
    if shape.capsule is not None:
        return shape.capsule
    p0, p1, r = fit_capsule(np.asarray(shape.points, np.float64))
    return tuple(p0), tuple(p1), float(r)


class CollisionPairSet:
    """The declared pairs of a tree as contact generators (numpy, built
    once): ``gens`` [(kind, data)], ``contacts_per_pair`` (each pair's PGS
    color size) and ``total_contacts`` — the reference's decomposition,
    field for field."""

    def __init__(self, tree: KinematicTree, pairs, default_friction):
        self.n = len(pairs)
        self.gens = []
        self.contacts_per_pair = []
        for p in pairs:
            ia, ib = _resolve_body(tree, p.a.body), _resolve_body(tree, p.b.body)
            if ia == ib:
                raise ValueError(f"collision pair on the same body {ia} is degenerate")
            mu = float(default_friction if p.friction is None else p.friction)
            n_contacts = 0
            for kind, data in self._decompose(p.a, ia, p.b, ib):
                data["mu"] = mu
                self.gens.append((kind, data))
                n_contacts += 1 if kind == "seg" else len(data["pts"])
            self.contacts_per_pair.append(n_contacts)
        self.total_contacts = sum(self.contacts_per_pair)

    @staticmethod
    def _decompose(sa, ia, sb, ib):
        seg_like = (Sphere, Capsule)

        def ptbox(b_pts, pts, rp, b_box, box):
            c, R, h = _box_frame(box)
            return ("ptbox", {"bp": b_pts, "pts": np.asarray(pts, np.float64), "rp": float(rp),
                              "bf": b_box, "c": c, "R": R, "h": h})

        def ptseg(b_pts, pts, rp, b_seg, p0, p1, rs):
            return ("ptseg", {"bp": b_pts, "pts": np.asarray(pts, np.float64), "rp": float(rp),
                              "bf": b_seg, "p0": np.asarray(p0, np.float64),
                              "p1": np.asarray(p1, np.float64), "rs": float(rs)})

        if isinstance(sa, seg_like) and isinstance(sb, seg_like):
            pa0, pa1, r_a = _endpoints(sa)
            pb0, pb1, r_b = _endpoints(sb)
            return [("seg", {"ba": ia, "a0": pa0, "a1": pa1, "ra": r_a,
                             "bb": ib, "b0": pb0, "b1": pb1, "rb": r_b})]
        if isinstance(sa, Box) and isinstance(sb, Box):
            ca, Ra, ha = _box_frame(sa)
            cb, Rb, hb = _box_frame(sb)
            sgn = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                           np.float64)
            return [ptbox(ia, (sgn * ha) @ Ra.T + ca, 0.0, ib, sb),
                    ptbox(ib, (sgn * hb) @ Rb.T + cb, 0.0, ia, sa)]
        if isinstance(sa, Box) or isinstance(sb, Box):
            box, b_box = (sa, ia) if isinstance(sa, Box) else (sb, ib)
            other, b_other = (sb, ib) if isinstance(sa, Box) else (sa, ia)
            if isinstance(other, seg_like):
                return [ptbox(b_other, _seg_samples(other), _endpoints(other)[2], b_box, box)]
            if isinstance(other, ConvexMesh):
                return [ptbox(b_other, np.asarray(other.points, np.float64), 0.0, b_box, box)]
        if isinstance(sa, ConvexMesh) and isinstance(sb, ConvexMesh):
            pa0, pa1, r_a = _mesh_capsule(sa)
            pb0, pb1, r_b = _mesh_capsule(sb)
            return [ptseg(ia, sa.points, 0.0, ib, pb0, pb1, r_b),
                    ptseg(ib, sb.points, 0.0, ia, pa0, pa1, r_a)]
        if isinstance(sa, ConvexMesh) or isinstance(sb, ConvexMesh):
            mesh, b_mesh = (sa, ia) if isinstance(sa, ConvexMesh) else (sb, ib)
            other, b_other = (sb, ib) if isinstance(sa, ConvexMesh) else (sa, ia)
            p0, p1, rs = _endpoints(other)
            return [ptseg(b_mesh, mesh.points, 0.0, b_other, p0, p1, rs)]
        raise ValueError(
            f"unsupported collision pair {type(sa).__name__} vs {type(sb).__name__}"
        )


def _dot(a, b):
    return (a * b).sum(-1)


def closest_segment_segment(p1, q1, p2, q2, eps: float = 1e-9):
    """Closest points (ca, cb) (..., 3) between the segments [p1, q1] and
    [p2, q2] (Ericson §5.1.9, branchless: the infinite lines' s clamped,
    then t, then s again at the clamped t where t left [0, 1])."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e = _dot(d1, d1), _dot(d2, d2)
    f, c, b = _dot(d2, r), _dot(d1, r), _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > eps,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=eps), 0.0, 1.0),
                    torch.zeros_like(denom))
    t = torch.where(e > eps, (b * s + f) / torch.clamp(e, min=eps), torch.zeros_like(e))
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(
        t != t_cl,
        torch.where(a > eps, torch.clamp((t_cl * b - c) / torch.clamp(a, min=eps), 0.0, 1.0),
                    torch.zeros_like(a)),
        s,
    )
    return p1 + s[..., None] * d1, p2 + t_cl[..., None] * d2


def box_sdf(pl: torch.Tensor, h) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact signed distance (...) and outward normal (..., 3) of points
    ``pl`` (..., 3) in the box frame, half-extents ``h`` (3,); inside, the
    normal is the axis of least penetration (ties to within 1e-12
    averaged)."""
    h = torch.as_tensor(h, dtype=pl.dtype, device=pl.device)
    q = pl.abs() - h
    out = torch.clamp(q, min=0.0)
    d_out = torch.sqrt(_dot(out, out) + 1e-18)
    m = q.amax(dim=-1)
    sdf = d_out + torch.clamp(m, max=0.0)
    sgn = torch.where(pl >= 0, 1.0, -1.0).to(pl.dtype)
    g_out = sgn * out / d_out[..., None]
    one = (q >= m[..., None] - 1e-12).to(pl.dtype)
    g_in = sgn * one / one.sum(dim=-1, keepdim=True)
    return sdf, torch.where((m < 0.0)[..., None], g_in, g_out)


def _contact_rows(tree, xw, alpha_over_dt, dt, margin, slop, max_corr_vel,
                  b_pt, sa, b_field, sb, n, depth, mu):
    """One contact per env → J (B, 3, nv), target (B, 3), active (B, 3),
    μ (B, 3): the rows [t1; t2; n]·(J_p(b_pt, sa) − J_p(b_field, sb)) with
    t1 = n × ref normalized (ref = e_x where |n_x| < 0.9, else e_y) and
    t2 = n × t1, the ground contacts' Baumgarte / velocity-barrier target on
    the normal row, active where depth > −margin."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(n[:, 0:1].abs() < 0.9, ex, ey)
    t1 = cross(n, ref)
    t1 = t1 / torch.sqrt(_dot(t1, t1) + 1e-18)[:, None]
    t2 = cross(n, t1)
    J_rel = (algos.point_jacobian(tree, xw, b_pt, sa)
             - algos.point_jacobian(tree, xw, b_field, sb))
    J = torch.stack([t1, t2, n], dim=1) @ J_rel
    v_corr = torch.where(
        depth > 0.0,
        torch.clamp(alpha_over_dt * (depth - slop), 0.0, max_corr_vel),
        depth / dt,
    )
    target = torch.stack([torch.zeros_like(depth), torch.zeros_like(depth), v_corr], dim=1)
    active = (depth > -margin).to(n.dtype)[:, None].expand(-1, 3)
    return J, target, active, torch.full_like(target, mu)


def _apply(xw, b, p_local, like):
    p = torch.as_tensor(np.asarray(p_local, np.float64), dtype=like.dtype, device=like.device)
    return xw[b].apply(p.expand(like.shape[0], 3))


def pair_rows(pairs: CollisionPairSet, tree: KinematicTree, xw, dt, alpha_over_dt, margin,
              slop, max_corr_vel):
    """PGS rows of every declared pair for a batch at world poses ``xw``:
    per contact a [t1, t2, n] block on the relative surface-point velocity
    (:func:`_contact_rows`). Returns J (B, 3N, nv), target, active and μ
    (B, 3N), N = ``pairs.total_contacts``, the contacts in generator
    order. ``alpha_over_dt``: the contacts' Baumgarte gain over dt."""
    like = xw[0].pos
    B = like.shape[0]
    Js, targets, actives, mus = [], [], [], []
    kw = (tree, xw, alpha_over_dt, dt, margin, slop, max_corr_vel)

    def emit(*contact):
        for acc, x in zip((Js, targets, actives, mus), _contact_rows(*kw, *contact)):
            acc.append(x)

    for kind, g in pairs.gens:
        if kind == "seg":
            ba, bb = g["ba"], g["bb"]
            ca, cb = closest_segment_segment(_apply(xw, ba, g["a0"], like),
                                             _apply(xw, ba, g["a1"], like),
                                             _apply(xw, bb, g["b0"], like),
                                             _apply(xw, bb, g["b1"], like))
            d = ca - cb
            dist = torch.sqrt(_dot(d, d) + 1e-18)
            n = d / dist[:, None]  # from B toward A
            depth = (g["ra"] + g["rb"]) - dist
            emit(ba, ca - g["ra"] * n, bb, cb + g["rb"] * n, n, depth, g["mu"])
            continue
        bp, bf, rp = g["bp"], g["bf"], g["rp"]
        pts = torch.as_tensor(g["pts"], dtype=like.dtype, device=like.device)  # (k, 3)
        pw = pts @ xw[bp].rot.transpose(-1, -2) + xw[bp].pos[:, None]  # (B, k, 3)
        if kind == "ptbox":
            c_w = _apply(xw, bf, g["c"], like)
            R_w = xw[bf].rot @ torch.as_tensor(g["R"], dtype=like.dtype, device=like.device)
            sdf, n_l = box_sdf((pw - c_w[:, None]) @ R_w, g["h"])
            n_w = n_l @ R_w.transpose(-1, -2)  # outward from the box, toward the point
            depth = rp - sdf
            sa_all, sb_all = pw - rp * n_w, pw - sdf[..., None] * n_w
        else:  # ptseg: the points against a capsule on bf
            p0, p1 = _apply(xw, bf, g["p0"], like), _apply(xw, bf, g["p1"], like)
            seg = p1 - p0
            denom = torch.clamp(_dot(seg, seg), min=1e-12)
            s = torch.clamp(_dot(pw - p0[:, None], seg[:, None]) / denom[:, None], 0.0, 1.0)
            cpt = p0[:, None] + s[..., None] * seg[:, None]
            d = pw - cpt
            dist = torch.sqrt(_dot(d, d) + 1e-18)
            n_w = d / dist[..., None]
            depth = (rp + g["rs"]) - dist
            sa_all, sb_all = pw - rp * n_w, cpt + g["rs"] * n_w
        for i in range(len(g["pts"])):
            emit(bp, sa_all[:, i], bf, sb_all[:, i], n_w[:, i], depth[:, i], g["mu"])
    if not Js:
        z = like.new_zeros(B, 0)
        return like.new_zeros(B, 0, tree.nv), z, z, z
    return (torch.cat(Js, dim=1), torch.cat(targets, dim=1), torch.cat(actives, dim=1),
            torch.cat(mus, dim=1))
