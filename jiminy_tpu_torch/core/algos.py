"""Featherstone rigid-body algorithms over a batch of configurations.

Counterpart of ``jiminy_tpu/core/algos.py`` (kinematics, body
accelerations, RNEA with armature, CRBA, ABA, point and 6-D frame
Jacobians, the centre of mass, the energy, Lie-group integrate) for FREE, REVOLUTE, PRISMATIC and SPHERICAL joints; a joint's columns
enter every algorithm through its motion subspace alone. The reference
writes them for one robot and vmaps; here every function takes batched
``q (B, nq)``, ``v (B, nv)`` and loops over bodies in Python (the
topology is static), so each step is one whole-batch tensor op.
Spatial vectors are (angular, linear) in the local body frame at the
body origin, as in the reference.
"""

from __future__ import annotations

import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import (
    Transform,
    motion_cross,
    motion_cross_force,
    mv,
)


def _axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor):
    """Rodrigues rotation (B, 3, 3) about a constant unit axis."""
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    K = so3.hat(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def joint_transform(tree: KinematicTree, i: int, q: torch.Tensor) -> Transform:
    """Pose of body i's frame in its joint frame, X_J(q_i), batched."""
    t = tree.joint_type[i]
    off = tree.q_off[i]
    B = q.shape[0]
    if t == JointType.FREE:
        return Transform(
            rot=so3.quat_to_matrix(q[:, off + 3:off + 7]), pos=q[:, off:off + 3]
        )
    if t == JointType.REVOLUTE:
        return Transform(
            rot=_axis_angle_matrix(tree.axis[i], q[:, off]),
            pos=q.new_zeros(B, 3),
        )
    if t == JointType.PRISMATIC:
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        return Transform(rot=eye.expand(B, 3, 3), pos=tree.axis[i] * q[:, off:off + 1])
    if t == JointType.SPHERICAL:
        return Transform(rot=so3.quat_to_matrix(q[:, off:off + 4]), pos=q.new_zeros(B, 3))
    raise ValueError(f"unsupported joint type {t}")


def motion_subspace(tree: KinematicTree, i: int) -> torch.Tensor:
    """S_i (6, nv_i): joint velocity → local spatial velocity."""
    return tree.motion_subspaces[i]


def _joint_velocity(tree, i, S, x):
    """S @ x[:, v_slice(i)] → (B, 6)."""
    return x[:, tree.v_slice(i)] @ S.T


def local_transforms(tree: KinematicTree, q: torch.Tensor) -> list[Transform]:
    """X_λi: pose of body i in its parent's frame, for every body."""
    return [
        tree.joint_placement(i).compose(joint_transform(tree, i, q))
        for i in range(tree.nb)
    ]


def forward_kinematics(tree: KinematicTree, q: torch.Tensor) -> list[Transform]:
    """World pose of every body frame."""
    xl = local_transforms(tree, q)
    xw: list[Transform] = []
    for i in range(tree.nb):
        p = tree.parent[i]
        xw.append(xl[i] if p < 0 else xw[p].compose(xl[i]))
    return xw


def kinematics(tree: KinematicTree, q, v, xl=None):
    """World poses and local spatial velocities (B, 6) of every body."""
    xl = local_transforms(tree, q) if xl is None else xl
    xw: list[Transform] = []
    vel: list[torch.Tensor] = []
    for i in range(tree.nb):
        p = tree.parent[i]
        vj = _joint_velocity(tree, i, motion_subspace(tree, i), v)
        if p < 0:
            xw.append(xl[i])
            vel.append(vj)
        else:
            xw.append(xw[p].compose(xl[i]))
            vel.append(xl[i].motion_parent_to_child(vel[p]) + vj)
    return xw, vel


def body_accelerations(tree: KinematicTree, q, v, a):
    """World poses, local spatial velocities and local spatial
    accelerations (B, 6) of every body for joint accelerations ``a``. The
    root is accelerated by [0; −g], so the accelerations are proper ones:
    what an accelerometer measures."""
    xl = local_transforms(tree, q)
    g = tree.gravity
    a0 = torch.cat([torch.zeros_like(g), -g])
    xw: list[Transform] = []
    vel: list[torch.Tensor] = []
    acc: list[torch.Tensor] = []
    for i in range(tree.nb):
        p = tree.parent[i]
        S = motion_subspace(tree, i)
        vj = _joint_velocity(tree, i, S, v)
        aj = _joint_velocity(tree, i, S, a)
        if p < 0:
            xw.append(xl[i])
            vel.append(vj)
            acc.append(xl[i].motion_parent_to_child(a0) + aj)
        else:
            xw.append(xw[p].compose(xl[i]))
            vel.append(xl[i].motion_parent_to_child(vel[p]) + vj)
            acc.append(
                xl[i].motion_parent_to_child(acc[p]) + aj + motion_cross(vel[i], vj)
            )
    return xw, vel, acc


def rnea(tree: KinematicTree, q, v, a, fext=None, xl=None, inertials=None) -> torch.Tensor:
    """Inverse dynamics with armature, τ = ID(q, v, a) − Jᵀ f_ext
    (B, nv). ``fext``: optional (B, nb, 6) local wrenches. ``inertials``:
    optional per-env masses, inertias and armature
    (``engine.randomization.Inertials``) in place of the tree's."""
    xl = local_transforms(tree, q) if xl is None else xl
    dyn = tree if inertials is None else inertials
    g = tree.gravity
    a0 = torch.cat([torch.zeros_like(g), -g])
    vel, acc, f, S_all = [None] * tree.nb, [None] * tree.nb, [None] * tree.nb, [None] * tree.nb
    for i in range(tree.nb):
        p = tree.parent[i]
        S = S_all[i] = motion_subspace(tree, i)
        vj = _joint_velocity(tree, i, S, v)
        aj = _joint_velocity(tree, i, S, a)
        if p < 0:
            vel[i] = vj
            acc[i] = xl[i].motion_parent_to_child(a0) + aj
        else:
            vel[i] = xl[i].motion_parent_to_child(vel[p]) + vj
            acc[i] = (
                xl[i].motion_parent_to_child(acc[p]) + aj
                + motion_cross(vel[i], vj)
            )
        Ii = dyn.body_inertia(i)
        f[i] = Ii.mul_motion(acc[i]) + motion_cross_force(
            vel[i], Ii.mul_motion(vel[i])
        )
        if fext is not None:
            f[i] = f[i] - fext[:, i]
    tau = torch.zeros_like(v)
    for i in range(tree.nb - 1, -1, -1):
        tau[:, tree.v_slice(i)] = f[i] @ S_all[i]
        p = tree.parent[i]
        if p >= 0:
            f[p] = f[p] + xl[i].force_child_to_parent(f[i])
    return tau + dyn.armature * a


def crba(tree: KinematicTree, q, xl=None, inertials=None) -> torch.Tensor:
    """Composite-rigid-body mass matrix (B, nv, nv), armature on the
    diagonal; ``inertials`` as in :func:`rnea`."""
    xl = local_transforms(tree, q) if xl is None else xl
    B = q.shape[0]
    dyn = tree if inertials is None else inertials
    Ic = [dyn.body_inertia(i) for i in range(tree.nb)]
    M = q.new_zeros(B, tree.nv, tree.nv)
    for i in range(tree.nb - 1, -1, -1):
        p = tree.parent[i]
        if p >= 0:
            Ic[p] = Ic[p].add(Ic[i].transform_by(xl[i]))
        S = motion_subspace(tree, i)
        # F = Ic·S, one column per joint dof → (B, 6, nv_i)
        F = torch.stack(
            [Ic[i].mul_motion(S[:, k]) for k in range(S.shape[1])], dim=-1
        ).expand(B, 6, S.shape[1])
        sl_i = tree.v_slice(i)
        M[:, sl_i, sl_i] = S.T @ F
        j = i
        while tree.parent[j] >= 0:
            # propagate F into the parent's frame, fill off-diagonal blocks
            F = torch.stack(
                [xl[j].force_child_to_parent(F[..., k]) for k in range(F.shape[-1])],
                dim=-1,
            )
            j = tree.parent[j]
            blk = F.transpose(-1, -2) @ motion_subspace(tree, j)
            sl_j = tree.v_slice(j)
            M[:, sl_i, sl_j] = blk
            M[:, sl_j, sl_i] = blk.transpose(-1, -2)
    if inertials is None:
        return M + torch.diag(tree.armature)
    return M + torch.diag_embed(inertials.armature)


def _force_mat(x: Transform) -> torch.Tensor:
    """Dense (..., 6, 6) force transform child → parent: [[R, p̂R], [0, R]]."""
    R = x.rot
    top = torch.cat([R, so3.hat(x.pos) @ R], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def aba(tree: KinematicTree, q, v, tau, fext=None) -> torch.Tensor:
    """Articulated-body forward dynamics with armature, a = FD(q, v, τ)
    (B, nv); ``fext`` as in :func:`rnea`. The reference implementation
    that the engine's mass-matrix solve is held against; the engine does
    not call it."""
    xl = local_transforms(tree, q)
    g = tree.gravity
    a0 = torch.cat([torch.zeros_like(g), -g])
    nb = tree.nb
    vel, c, IA, pA = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    S_all, U_all, Dinv_all, u_all = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    # pass 1: velocities and bias forces
    for i in range(nb):
        p = tree.parent[i]
        S = S_all[i] = motion_subspace(tree, i)
        vj = _joint_velocity(tree, i, S, v)
        if p < 0:
            vel[i] = vj
            c[i] = torch.zeros_like(vj)
        else:
            vel[i] = xl[i].motion_parent_to_child(vel[p]) + vj
            c[i] = motion_cross(vel[i], vj)
        Ii = tree.body_inertia(i)
        IA[i] = Ii.to_matrix()
        pA[i] = motion_cross_force(vel[i], Ii.mul_motion(vel[i]))
        if fext is not None:
            pA[i] = pA[i] - fext[:, i]
    # pass 2: articulated inertias, leaves to root
    for i in range(nb - 1, -1, -1):
        S = S_all[i]
        sl = tree.v_slice(i)
        U = IA[i] @ S  # (…, 6, nv_i)
        D = S.T @ U + torch.diag(tree.armature[sl])
        Dinv = 1.0 / D if S.shape[1] == 1 else torch.linalg.inv(D)
        u = tau[:, sl] - pA[i] @ S
        U_all[i], Dinv_all[i], u_all[i] = U, Dinv, u
        p = tree.parent[i]
        if p >= 0:
            Ia = IA[i] - U @ Dinv @ U.transpose(-1, -2)
            pa = pA[i] + mv(Ia, c[i]) + mv(U, mv(Dinv, u))
            W = _force_mat(xl[i])
            IA[p] = IA[p] + W @ Ia @ W.transpose(-1, -2)
            pA[p] = pA[p] + mv(W, pa)
    # pass 3: accelerations, root to leaves
    acc = [None] * nb
    qdd = torch.zeros_like(v)
    for i in range(nb):
        p = tree.parent[i]
        a_up = a0 if p < 0 else acc[p]
        a_prime = xl[i].motion_parent_to_child(a_up) + c[i]
        qdd_i = mv(Dinv_all[i], u_all[i] - mv(U_all[i].transpose(-1, -2), a_prime))
        qdd[:, tree.v_slice(i)] = qdd_i
        acc[i] = a_prime + qdd_i @ S_all[i].T
    return qdd


def _chain_columns(tree: KinematicTree, xw: list[Transform], body: int, point_world):
    """For ``body`` and each of its ancestors j: (j's velocity slice, its
    world angular columns (B, 3, nv_j), the world linear velocity columns
    of the point ``point_world`` (B, 3) that it moves (B, 3, nv_j))."""
    j = body
    while j >= 0:
        S = motion_subspace(tree, j)
        R, o = xw[j].rot, xw[j].pos
        w_cols = R @ S[:3, :]  # (B, 3, nv_j) world angular
        v_cols = R @ S[3:, :]  # world linear at the joint origin
        r = (point_world - o)[:, None, :]
        lin = v_cols + so3.cross(w_cols.transpose(-1, -2), r).transpose(-1, -2)
        yield tree.v_slice(j), w_cols, lin
        j = tree.parent[j]


def point_jacobian(
    tree: KinematicTree, xw: list[Transform], body: int, point_world
) -> torch.Tensor:
    """World-frame linear-velocity Jacobian (B, 3, nv) of a point attached
    to ``body``, walking the ancestor chain."""
    J = point_world.new_zeros(point_world.shape[0], 3, tree.nv)
    for sl, _, lin in _chain_columns(tree, xw, body, point_world):
        J[:, :, sl] = lin
    return J


def frame_jacobian6(
    tree: KinematicTree, xw: list[Transform], body: int, point_world
) -> torch.Tensor:
    """World-frame 6-D Jacobian (B, 6, nv) [angular; linear] of a frame at
    ``point_world`` attached to ``body``."""
    J = point_world.new_zeros(point_world.shape[0], 6, tree.nv)
    for sl, w_cols, lin in _chain_columns(tree, xw, body, point_world):
        J[:, :3, sl] = w_cols
        J[:, 3:, sl] = lin
    return J


def com_position(tree: KinematicTree, xw: list[Transform]) -> torch.Tensor:
    """Whole-body centre of mass in the world frame (B, 3); a massless
    body adds nothing."""
    total_m = 0.0
    weighted = torch.zeros_like(xw[0].pos)
    for i in range(tree.nb):
        m = tree.inertia_mass[i]
        com_local = torch.where(m > 0, tree.inertia_h[i] / m, torch.zeros_like(tree.inertia_h[i]))
        weighted = weighted + m * xw[i].apply(com_local)
        total_m = total_m + m
    return weighted / total_m


def energy(tree: KinematicTree, q, v) -> tuple[torch.Tensor, torch.Tensor]:
    """(kinetic, potential) energy, each (B,); the kinetic energy counts
    the armature's ½·Σ armature·v²."""
    xw, vel = kinematics(tree, q, v)
    ke, pe = 0.0, 0.0
    g = tree.gravity.to(q.dtype)
    for i in range(tree.nb):
        ke = ke + 0.5 * torch.sum(vel[i] * tree.body_inertia(i).mul_motion(vel[i]), dim=-1)
        com_w = mv(xw[i].rot, tree.inertia_h[i]) + tree.inertia_mass[i] * xw[i].pos
        pe = pe - torch.sum(g * com_w, dim=-1)
    ke = ke + 0.5 * torch.sum(tree.armature * v * v, dim=-1)
    return ke, pe


def integrate(tree: KinematicTree, q, v, dt) -> torch.Tensor:
    """q ⊕ v·dt on the configuration manifold (the quaternions of FREE and
    SPHERICAL joints by the exponential map with local tangents,
    Pinocchio semantics)."""
    out = q.clone()
    one = [i for i in range(tree.nb)
           if tree.joint_type[i] in (JointType.REVOLUTE, JointType.PRISMATIC)]
    if one:
        qi = [tree.q_off[i] for i in one]
        vi = [tree.v_off[i] for i in one]
        out[:, qi] = q[:, qi] + v[:, vi] * dt
    for i in range(tree.nb):
        t = tree.joint_type[i]
        qo, vo = tree.q_off[i], tree.v_off[i]
        if t == JointType.FREE:
            quat = q[:, qo + 3:qo + 7]
            dp = mv(so3.quat_to_matrix(quat), v[:, vo:vo + 3] * dt)
            out[:, qo:qo + 3] = q[:, qo:qo + 3] + dp
            out[:, qo + 3:qo + 7] = so3.quat_integrate(quat, v[:, vo + 3:vo + 6], dt)
        elif t == JointType.SPHERICAL:
            out[:, qo:qo + 4] = so3.quat_integrate(q[:, qo:qo + 4], v[:, vo:vo + 3], dt)
    return out
