"""Contact sites against the ground, batched.

Counterpart of ``jiminy_tpu/engine/contact.py`` for the constraint
(impulse) contact model: ``ContactParams``, the world positions and
velocities of the contact sites, and the per-substep contact manifold,
for bare points and for sphere sites (a capsule against the ground is its
two end spheres, ``TreeBuilder.add_contact_capsule``). The penalty
(spring-damper) model waits for a later slice (ROADMAP A.16).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.math.so3 import cross
from jiminy_tpu_torch.math.spatial import Transform, mv


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """The reference's ``engine.contacts`` option block. The impulse path
    reads ``friction`` only (a float, or in ``Engine.step(...,
    contact_params=)`` each env's (B,) tensor); the penalty parameters are
    kept so models cross unchanged."""

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
