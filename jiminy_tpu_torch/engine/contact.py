"""Contact sites against the ground, batched.

Counterpart of ``jiminy_tpu/engine/contact.py``: ``ContactParams``, the
world positions and velocities of the contact sites, and the per-substep
contact manifold, for bare points and for sphere sites (a capsule against
the ground is its two end spheres, ``TreeBuilder.add_contact_capsule``),
which the constraint (impulse) model turns into PGS rows; and the
penalty (spring-damper) model, the reference's default: a normal force
from the depth and its rate ramped in over ``transition_eps``,
regularized Coulomb friction with the explicit-integration stability
clamp (:func:`penalty_forces`), the point forces as per-body wrenches
(:func:`forces_to_fext`, :func:`compute_contact_fext`) and the static
tangential effective mass that the clamp reads
(:func:`contact_effective_mass`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.math.so3 import cross
from jiminy_tpu_torch.math.spatial import Transform, mtv, mv


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """The reference's ``engine.contacts`` option block. Each field is a
    float, or in ``Engine.step(..., contact_params=)`` each env's (B,)
    tensor. The impulse path reads ``friction``; the penalty model all
    five."""

    stiffness: float = 1e5
    damping: float = 2e3
    friction: float = 1.0
    transition_velocity: float = 0.01
    transition_eps: float = 1e-3


def contact_params_from_arrays(d: dict) -> ContactParams:
    """ContactParams from the reference's fields as numpy scalars."""
    return ContactParams(
        **{
            f.name: float(np.asarray(d[f.name]))
            for f in dataclasses.fields(ContactParams)
        }
    )


def contact_points_world(
    tree: KinematicTree, xw: list[Transform], vel: list[torch.Tensor]
):
    """World positions and velocities (B, ncp, 3) of the contact sites."""
    ps, vs = [], []
    for k in range(tree.ncp):
        b = tree.contact_body[k]
        p_local = tree.contact_pos[k]
        ps.append(xw[b].apply(p_local))
        w_l, v_l = vel[b][:, :3], vel[b][:, 3:]
        vs.append(mv(xw[b].rot, v_l + cross(w_l, p_local)))
    return torch.stack(ps, dim=1), torch.stack(vs, dim=1)


def surface_contacts(tree: KinematicTree, xw, vel, ground, spheres: bool):
    """(points, velocities, depth, normal) of every site against the
    ground: (B, ncp, 3), (B, ncp, 3), (B, ncp), (B, ncp, 3). A bare point
    is its body point. A sphere site (radius r > 0) touches at its
    surface point p = c − r·n̂, the normal n̂ taken at the centre's xy; the
    height at p's xy gives the depth and the normal there the contact's
    (exact on flat ground, first order on curved terrain; the kernels do
    the same), and p moves at v_c + ω × (p − c), the rolling lever arm.
    ``spheres``: whether any site has a radius, known on the host
    (``SubstepSpec.spheres``), so that the step does not wait for the
    device to read the tree's radii."""
    centers, v_c = contact_points_world(tree, xw, vel)
    if not spheres:
        h, n = ground.query(centers[..., :2])
        return centers, v_c, h - centers[..., 2], n
    _, n1 = ground.query(centers[..., :2])
    pts = centers - tree.contact_radius[:, None] * n1
    h2, n2 = ground.query(pts[..., :2])
    omegas = torch.stack(
        [mv(xw[b].rot, vel[b][:, :3]) for b in tree.contact_body], dim=1
    )
    return pts, v_c + cross(omegas, pts - centers), h2 - pts[..., 2], n2


def has_spheres(tree: KinematicTree) -> bool:
    """Whether any contact site has a radius (read on the host)."""
    return tree.ncp > 0 and bool((tree.contact_radius > 0).any())


def _per_env(x, like: torch.Tensor):
    """A contact parameter as a float, or each env's (B,) as (B, 1) to
    broadcast against ``like`` (B, ncp)."""
    if torch.is_tensor(x):
        return x.to(dtype=like.dtype, device=like.device).reshape(-1, 1)
    return x


def penalty_forces(depth, n, velocities, params: ContactParams, dt=None, m_eff=None):
    """World contact force (B, ncp, 3) at each point from the depth (B,
    ncp) (> 0 below the surface), the normals and the points' velocities
    (B, ncp, 3): f_n = (k·δ − d·δ̇)₊ ramped in linearly over
    ``transition_eps``, and regularized Coulomb friction, μ·f_n against
    the slip, proportional to the slip speed below ``transition_velocity``.
    Given ``dt`` and the sites' tangential effective mass ``m_eff`` (ncp,),
    the band widens to max(v_tr, μ·f_n·dt / (2·m_eff)): the explicitly
    integrated friction slope then stays below 2·m_eff/dt (the reference's
    stability clamp)."""
    k, d = _per_env(params.stiffness, depth), _per_env(params.damping, depth)
    mu = _per_env(params.friction, depth)
    v_n = torch.sum(velocities * n, dim=-1)
    act = torch.clamp(depth / _per_env(params.transition_eps, depth), 0.0, 1.0)
    f_n = torch.clamp_min(k * depth - d * v_n, 0.0) * act
    v_t = velocities - v_n[..., None] * n
    vt_norm = torch.linalg.vector_norm(v_t, dim=-1)
    v_tr = _per_env(params.transition_velocity, depth)
    if dt is not None and m_eff is not None:
        v_tr = torch.maximum(torch.as_tensor(v_tr, dtype=depth.dtype, device=depth.device),
                             mu * f_n * dt / (2.0 * m_eff))
    scale = torch.clamp_max(vt_norm / v_tr, 1.0)
    f_t_mag = mu * f_n * scale
    t_dir = v_t / torch.clamp_min(vt_norm, 1e-9)[..., None]
    return f_n[..., None] * n - f_t_mag[..., None] * t_dir


def spring_damper_forces(points, velocities, ground, params: ContactParams):
    """Penalty forces (B, ncp, 3) of bare points (B, ncp, 3) against the
    ground, which this queries."""
    h, n = ground.query(points[..., :2])
    return penalty_forces(h - points[..., 2], n, velocities, params)


def forces_to_fext(tree: KinematicTree, xw, forces_world, points_world) -> torch.Tensor:
    """World point forces (B, ncp, 3) at ``points_world`` summed into each
    body's local spatial wrench at its origin, (B, nb, 6), the ``fext``
    of :func:`~jiminy_tpu_torch.core.algos.rnea`."""
    B = forces_world.shape[0]
    per_body = [None] * tree.nb
    for k, b in enumerate(tree.contact_body):
        f_w = forces_world[:, k]
        n_w = cross(points_world[:, k] - xw[b].pos, f_w)
        w = torch.cat([mtv(xw[b].rot, n_w), mtv(xw[b].rot, f_w)], dim=-1)
        per_body[b] = w if per_body[b] is None else per_body[b] + w
    zero = forces_world.new_zeros(B, 6)
    return torch.stack([zero if w is None else w for w in per_body], dim=1)


def contact_effective_mass(tree: KinematicTree) -> np.ndarray:
    """Each site's static tangential effective mass (ncp,), float32: 1 /
    max((J·M⁻¹·Jᵀ)_xx, (J·M⁻¹·Jᵀ)_yy) at the neutral configuration, the
    leg's reflected inertia that the penalty model's friction clamp
    reads. Built once, in float64 on the CPU from the tree's constants."""
    from jiminy_tpu_torch.core import algos

    t = tree.to(device="cpu", dtype=torch.float64)
    q = torch.as_tensor(t.neutral_q(), dtype=torch.float64)[None]
    xw, _ = algos.kinematics(t, q, torch.zeros(1, t.nv, dtype=torch.float64))
    Minv = torch.linalg.inv(algos.crba(t, q)[0])
    out = []
    for k, b in enumerate(t.contact_body):
        J = algos.point_jacobian(t, xw, b, xw[b].apply(t.contact_pos[k])[None])[0]
        W = J @ Minv @ J.T
        out.append(1.0 / max(float(W[0, 0]), float(W[1, 1]), 1e-9))
    return np.asarray(out, np.float32)


def compute_contact_fext(tree: KinematicTree, xw, vel, ground, params: ContactParams, dt=None,
                         m_eff=None, spheres: bool | None = None):
    """The penalty pipeline: (fext (B, nb, 6) local wrenches, world forces
    (B, ncp, 3)). ``dt`` and ``m_eff`` (ncp,) turn on the friction clamp
    of :func:`penalty_forces`; ``spheres`` as in :func:`surface_contacts`
    (None: read from the tree)."""
    B = xw[0].pos.shape[0]
    if tree.ncp == 0:
        z = xw[0].pos.new_zeros
        return z(B, tree.nb, 6), z(B, 0, 3)
    spheres = has_spheres(tree) if spheres is None else spheres
    pts, vels, depth, n = surface_contacts(tree, xw, vel, ground, spheres)
    f_w = penalty_forces(depth, n, vels, params, dt=dt, m_eff=m_eff)
    return forces_to_fext(tree, xw, f_w, pts), f_w
