"""Toy models: the pendulums, the cartpole, the acrobot, a ball and a box.

Counterpart of ``jiminy_tpu/models/toys.py``, built with the port's
:class:`~jiminy_tpu_torch.core.tree.TreeBuilder` in the reference's
order, so each tree equals the reference's field for field
(``tests/test_torch_prismatic.py``). ``make_cartpole`` is the port's
PRISMATIC model: a cart sliding along x with its ±``x_limit`` bounds,
a pole hinged on it about y.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_tpu_torch.core.tree import JointType, KinematicTree, TreeBuilder


def make_pendulum(
    length: float = 1.0,
    mass: float = 1.0,
    point_mass: bool = True,
    armature: float = 0.0,
    damping: float = 0.0,
    device="cuda",
    dtype=torch.float32,
) -> KinematicTree:
    """A pendulum about the world y-axis, θ = 0 hanging down (−z): a point
    mass at ``length``, or a thin rod (``point_mass=False``); a frame and
    a contact point at the tip."""
    b = TreeBuilder()
    inertia = np.zeros((3, 3), np.float32)
    if not point_mass:
        inertia = np.diag([mass * length**2 / 12.0] * 2 + [0.0]).astype(np.float32)
        com = (0.0, 0.0, -length / 2.0)
    else:
        com = (0.0, 0.0, -length)
    b.add_body(
        "link", parent=-1, joint_type=JointType.REVOLUTE, axis=(0.0, 1.0, 0.0), mass=mass,
        com=com, inertia=inertia, armature=armature, damping=damping, joint_name="pivot",
    )
    b.add_frame("tip", 0, TreeBuilder.make_placement(pos=(0, 0, -length)))
    b.add_contact_point("tip_contact", 0, (0.0, 0.0, -length))
    return b.build(device=device, dtype=dtype)


def make_double_pendulum(
    l1: float = 1.0, l2: float = 1.0, m1: float = 1.0, m2: float = 1.0,
    device="cuda", dtype=torch.float32,
) -> KinematicTree:
    """Two point-mass links, both about y, hanging down."""
    b = TreeBuilder()
    j1 = b.add_body("link1", parent=-1, joint_type=JointType.REVOLUTE, axis=(0, 1, 0), mass=m1,
                    com=(0, 0, -l1), joint_name="shoulder")
    b.add_body("link2", parent=j1, joint_type=JointType.REVOLUTE,
               placement=TreeBuilder.make_placement(pos=(0, 0, -l1)), axis=(0, 1, 0), mass=m2,
               com=(0, 0, -l2), joint_name="elbow")
    b.add_frame("tip", 1, TreeBuilder.make_placement(pos=(0, 0, -l2)))
    return b.build(device=device, dtype=dtype)


def make_cartpole(
    cart_mass: float = 1.0,
    pole_mass: float = 0.1,
    pole_length: float = 0.5,
    x_limit: float = 2.4,
    device="cuda",
    dtype=torch.float32,
) -> KinematicTree:
    """The classic cartpole: a PRISMATIC cart along x within ±``x_limit``
    (u_max 30), a pole about y as a point mass at ``pole_length`` (Gym's
    half-pole), θ = 0 upright."""
    b = TreeBuilder()
    cart = b.add_body("cart", parent=-1, joint_type=JointType.PRISMATIC, axis=(1, 0, 0),
                      mass=cart_mass, com=(0, 0, 0), joint_name="slider",
                      q_limits=(-x_limit, x_limit), u_max=30.0)
    b.add_body("pole", parent=cart, joint_type=JointType.REVOLUTE, axis=(0, 1, 0),
               mass=pole_mass, com=(0, 0, pole_length), joint_name="pole_hinge")
    b.add_frame("pole_tip", 1, TreeBuilder.make_placement(pos=(0, 0, pole_length)))
    return b.build(device=device, dtype=dtype)


def make_acrobot(
    l1: float = 1.0, l2: float = 1.0, m1: float = 1.0, m2: float = 1.0, lc1: float = 0.5,
    lc2: float = 0.5, I1: float = 1.0, I2: float = 1.0, device="cuda", dtype=torch.float32,
) -> KinematicTree:
    """The acrobot (Sutton's parameters): two links about y, θ = 0 hanging
    down, the elbow's effort limited to 10; I1, I2 about each link's
    centre of mass."""
    b = TreeBuilder()
    j1 = b.add_body("upper_arm", parent=-1, joint_type=JointType.REVOLUTE, axis=(0, 1, 0),
                    mass=m1, com=(0, 0, -lc1), inertia=np.diag([I1, I1, 0.0]).astype(np.float32),
                    joint_name="shoulder")
    b.add_body("lower_arm", parent=j1, joint_type=JointType.REVOLUTE,
               placement=TreeBuilder.make_placement(pos=(0, 0, -l1)), axis=(0, 1, 0), mass=m2,
               com=(0, 0, -lc2), inertia=np.diag([I2, I2, 0.0]).astype(np.float32),
               joint_name="elbow", u_max=10.0)
    b.add_frame("tip", 1, TreeBuilder.make_placement(pos=(0, 0, -l2)))
    return b.build(device=device, dtype=dtype)


def make_ball(mass: float = 1.0, radius: float = 0.1, device="cuda",
              dtype=torch.float32) -> KinematicTree:
    """A free solid sphere with one sphere contact site at its centre
    (it touches at centre − r·n̂, so friction makes it roll)."""
    i = 0.4 * mass * radius * radius
    b = TreeBuilder()
    ball = b.add_body("ball", parent=-1, joint_type=JointType.FREE, mass=mass, com=(0, 0, 0),
                      inertia=np.diag([i, i, i]).astype(np.float32), joint_name="root")
    b.add_contact_sphere("surface", ball, (0.0, 0.0, 0.0), radius=radius)
    return b.build(device=device, dtype=dtype)


def make_free_box(mass: float = 1.0, half_extents=(0.1, 0.1, 0.1), device="cuda",
                  dtype=torch.float32) -> KinematicTree:
    """A free box with a contact point at each of its 8 corners."""
    hx, hy, hz = half_extents
    ix = mass / 3.0 * (hy**2 + hz**2)
    iy = mass / 3.0 * (hx**2 + hz**2)
    iz = mass / 3.0 * (hx**2 + hy**2)
    b = TreeBuilder()
    box = b.add_body("box", parent=-1, joint_type=JointType.FREE, mass=mass, com=(0, 0, 0),
                     inertia=np.diag([ix, iy, iz]).astype(np.float32), joint_name="root")
    for cx in (-hx, hx):
        for cy in (-hy, hy):
            for cz in (-hz, hz):
                b.add_contact_point(f"corner_{cx:+.2f}_{cy:+.2f}_{cz:+.2f}", box, (cx, cy, cz))
    return b.build(device=device, dtype=dtype)
