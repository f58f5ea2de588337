"""Shared physical quantities of one env step, computed once.

Counterpart of ``jiminy_tpu/envs/quantities.py`` (the reference's
``QuantityManager``: lazily evaluated quantities such as the CoM, the ZMP,
the capture point, the odometry pose and the contact forces, shared by
rewards, terminations and observers). A :class:`QuantityContext` is made
for one step over a batch of states; each property computes its value on
first use and keeps it in ``_cache`` for the other consumers of that
step, as the reference's per-trace cache does. Every quantity has a
leading (B,) axis.
"""

from __future__ import annotations

import math

import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import mv


class QuantityContext:
    """Quantities of a batch of states ``sim`` of ``tree``. ``ground``
    (optional, e.g. each env's own, ``WalkerEnv._episode_ground(info)``)
    makes the terrain-aware quantities measure against it; ``gravity``
    is the magnitude the capture point uses."""

    def __init__(self, tree: KinematicTree, sim: SimState, gravity: float = 9.81, ground=None):
        self.tree = tree
        self.sim = sim
        self.g = gravity
        self.ground = ground
        self._cache: dict = {}

    def _memo(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    # ---- kinematic backbone
    @property
    def kinematics(self):
        """(world poses, local spatial velocities) of every body."""
        return self._memo("kin", lambda: algos.kinematics(self.tree, self.sim.q, self.sim.v))

    @property
    def xw(self):
        return self.kinematics[0]

    @property
    def vel(self):
        return self.kinematics[1]

    # ---- quantities
    @property
    def com(self) -> torch.Tensor:
        """Whole-body centre of mass, world frame (B, 3)."""
        return self._memo("com", lambda: algos.com_position(self.tree, self.xw))

    @property
    def com_velocity(self) -> torch.Tensor:
        """Velocity of the centre of mass, world frame (B, 3)."""

        def f():
            tree, xw, vel = self.tree, self.xw, self.vel
            p = torch.zeros_like(self.sim.q[:, :3])
            for i in range(tree.nb):
                m = tree.inertia_mass[i]
                c_loc = torch.where(m > 0, tree.inertia_h[i] / torch.clamp(m, min=1e-9),
                                    torch.zeros_like(tree.inertia_h[i]))
                w_l, v_l = vel[i][:, :3], vel[i][:, 3:]
                p = p + m * mv(xw[i].rot, v_l + so3.cross(w_l, c_loc))
            return p / torch.sum(tree.inertia_mass)

        return self._memo("com_vel", f)

    @property
    def zmp(self) -> torch.Tensor:
        """Zero-moment point from the contact forces, world xy (B, 2); the
        CoM's projection where the vertical force is 1e-3 N or less (a
        flight phase)."""

        def f():
            if self.tree.ncp == 0:
                return self.com[:, :2]
            f_z = self.sim.contact_forces[:, :, 2]
            total = torch.sum(f_z, dim=-1)
            zmp = torch.sum(self.contact_points[:, :, :2] * f_z[:, :, None], dim=1) \
                / torch.clamp(total, min=1e-6)[:, None]
            return torch.where((total > 1e-3)[:, None], zmp, self.com[:, :2])

        return self._memo("zmp", f)

    @property
    def capture_point(self) -> torch.Tensor:
        """Instantaneous capture point (B, 2): com_xy + com_vel_xy·√(z/g)."""

        def f():
            com, v = self.com, self.com_velocity
            omega = torch.sqrt(torch.clamp(com[:, 2], min=1e-3) / self.g)
            return com[:, :2] + v[:, :2] * omega[:, None]

        return self._memo("cp", f)

    @property
    def base_pose(self):
        """(position (B, 3), quaternion xyzw (B, 4)) of the floating base."""
        return self.sim.q[:, :3], self.sim.q[:, 3:7]

    @property
    def odometry(self) -> torch.Tensor:
        """Planar odometry pose (x, y, yaw) (B, 3)."""

        def f():
            pos, quat = self.base_pose
            yaw = so3.quat_to_rpy(quat)[:, 2]
            return torch.stack([pos[:, 0], pos[:, 1], yaw], dim=-1)

        return self._memo("odom", f)

    @property
    def base_velocity_world(self) -> torch.Tensor:
        """Base linear velocity in the world frame (B, 3)."""
        return self._memo(
            "base_vw", lambda: mv(so3.quat_to_matrix(self.sim.q[:, 3:7]), self.sim.v[:, 0:3]))

    @property
    def base_angular_velocity(self) -> torch.Tensor:
        """Base angular velocity in the base frame (B, 3)."""
        return self.sim.v[:, 3:6]

    @property
    def base_height_above_ground(self) -> torch.Tensor:
        """Base height above the context's ground under it (B,); ``q[:, 2]``
        without a ground."""

        def f():
            z = self.sim.q[:, 2]
            if self.ground is None:
                return z
            return z - self.ground.query(self.sim.q[:, :2])[0]

        return self._memo("base_h", f)

    @property
    def base_tilt(self) -> torch.Tensor:
        """cos of the angle between the base's z-axis and the world's up
        (B,), 1 when level."""
        return self._memo("tilt", lambda: so3.quat_to_matrix(self.sim.q[:, 3:7])[:, 2, 2])

    @property
    def contact_points(self) -> torch.Tensor:
        """World positions of the contact points (B, ncp, 3)."""

        def f():
            tree, xw = self.tree, self.xw
            if tree.ncp == 0:
                return self.sim.q.new_zeros(self.sim.q.shape[0], 0, 3)
            return torch.stack([xw[b].apply(tree.contact_pos[k])
                                for k, b in enumerate(tree.contact_body)], dim=1)

        return self._memo("cpts", f)

    @property
    def total_contact_force(self) -> torch.Tensor:
        """Summed world contact force (B, 3)."""
        return self._memo("fc", lambda: torch.sum(self.sim.contact_forces, dim=1))

    @property
    def energy(self):
        """(kinetic (B,), potential (B,))."""
        return self._memo("energy", lambda: algos.energy(self.tree, self.sim.q, self.sim.v))

    def frame_pose(self, frame: int):
        """World pose of an operational frame (a batched Transform)."""
        return self._memo(
            f"fp{frame}",
            lambda: self.xw[self.tree.frame_body[frame]].compose(self.tree.frame_placement(frame)),
        )

    def support_polygon_margin(self, point: torch.Tensor | None = None,
                               n_directions: int = 16) -> torch.Tensor:
        """Signed distance (B,) from ``point`` (B, 2) (default: the ZMP) to
        the support polygon of the loaded contact points (vertical force
        over 1e-3 N), positive inside: the support function's
        min over θ of max over k of (c_k − p)·u(θ), on ``n_directions``
        directions; −inf without a loaded contact."""

        def f():
            p = self.zmp if point is None else point
            pts = self.contact_points[:, :, :2]
            loaded = self.sim.contact_forces[:, :, 2] > 1e-3
            th = torch.arange(n_directions, dtype=pts.dtype, device=pts.device) \
                * (2.0 * math.pi / n_directions)
            U = torch.stack([torch.cos(th), torch.sin(th)], dim=1)  # (D, 2)
            proj = (pts - p[:, None, :]) @ U.T  # (B, ncp, D)
            proj = torch.where(loaded[:, :, None], proj, torch.full_like(proj, -math.inf))
            return torch.amin(torch.amax(proj, dim=1), dim=1)

        return self._memo("spm", f) if point is None else f()
