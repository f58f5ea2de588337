"""The port's URDF and TOML builders (``jiminy_tpu_torch.io``,
``jiminy_tpu_torch.robot``) against jiminy_tpu's.

- ``build_robot`` of ``data/anymal``, ``data/spotmicro`` and
  ``data/atlas`` (with the hardware's torso flexibility), of
  ``quadruped_urdf`` / ``humanoid_urdf`` text with their hardware dicts,
  of the capsule-foot ANYmal (``foot_radius`` 0.02, ``foot_len`` 0.08),
  with ``default_hardware`` and with a fixed root: the tree against
  ``tree_from_arrays`` of the reference's (integers and names exact,
  floats bit-identical: both parse the same text to numpy float32 with
  the same arithmetic), the motor banks and the sensor suites field for
  field, the parsed ``<collision>`` geometry and the display geometry.
- The URDF text and the hardware dicts are the reference's, to the
  character; ``data/anymal.urdf`` is ``anymal_urdf()``.
- The URDF-built ANYmal and Spotmicro within 1e-7 of the port's own
  ``make_quadruped`` (the bound of ``tests/test_torch_model.py``).
- The capsule-foot tree: ncp 8, radii 0.02, sites at ±0.04 in y, 4
  contact sensors (the reference's ``test_capsule_feet_build``); a
  ``[Flexibility]`` section on it shifts the geometry's bodies as the
  reference's does.
- ``default_hardware``, the reference's refusals (a mimic joint, an
  unknown joint type, a root tag other than ``robot``: ValueError in
  both), ``load_urdf``, ``read_stl`` (binary and ASCII) and
  ``shape_for_link`` of a sphere, a capsule, a turned box and an STL cube
  written to ``tmp_path``, exact and as capsules.
- Port-only, at B = 4 on the CPU (plain versions): the capsule-foot
  ANYmal stands 25 env steps from the reference's stand pose
  (``test_capsule_feet_stand``: base above 0.45 m, finite, not
  terminated); ``WalkerEnv(robot, stand_pose=)`` equals ``WalkerEnv(tree,
  motors, stand_pose, sensors=)`` bit for bit over 2 sensor-path steps.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jiminy_tpu.models.humanoid as j_humanoid
import jiminy_tpu.models.quadruped as j_quadruped
from jiminy_tpu.engine import collision as j_collision
from jiminy_tpu.io import urdf as j_urdf
from jiminy_tpu.robot import build_robot as j_build_robot
from jiminy_tpu.robot import default_hardware as j_default_hardware
from jiminy_tpu.viewer3d import read_stl as j_read_stl
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import collision
from jiminy_tpu_torch.envs.locomotion import WalkerEnv
from jiminy_tpu_torch.io import load_urdf, parse_urdf, read_stl
from jiminy_tpu_torch.models import humanoid, quadruped
from jiminy_tpu_torch.robot import build_robot, default_hardware

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "data"
MOTOR_FIELDS = ("v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
                "friction_dry", "friction_viscous", "friction_vel_eps")
CAPSULE = dict(foot_radius=0.02, foot_len=0.08)
P_CAPSULE = dataclasses.replace(quadruped.ANYMAL, **CAPSULE)
J_CAPSULE = dataclasses.replace(j_quadruped.ANYMAL, **CAPSULE)


def _cases():
    """{name: (urdf, hardware, freeflyer)}."""
    flex = dict(quadruped.quadruped_hardware(P_CAPSULE), Flexibility={
        "lf_knee_flex": {"joint_name": "LF_KFE", "stiffness": 500.0, "damping": 4.0,
                         "inertia": 2e-3}})
    return {
        "anymal_files": (DATA / "anymal.urdf", DATA / "anymal_hardware.toml", True),
        "spotmicro_files": (DATA / "spotmicro.urdf", DATA / "spotmicro_hardware.toml", True),
        "atlas_files_flexible": (DATA / "atlas.urdf", DATA / "atlas_hardware.toml", True),
        "anymal_text": (quadruped.anymal_urdf(), quadruped.anymal_hardware(0.004, 0.02, 0.005),
                        True),
        "humanoid_text": (humanoid.humanoid_urdf(), humanoid.humanoid_hardware(), True),
        "capsule_feet": (quadruped.quadruped_urdf(P_CAPSULE),
                         quadruped.quadruped_hardware(P_CAPSULE), True),
        "capsule_feet_flexible": (quadruped.quadruped_urdf(P_CAPSULE), flex, True),
        "anymal_default_hardware": (DATA / "anymal.urdf", None, True),
        "anymal_fixed_root": (DATA / "anymal.urdf", None, False),
    }


@pytest.fixture(scope="module")
def robots():
    """{case: (reference robot, port robot)}."""
    return {name: (j_build_robot(u, hw, freeflyer=ff), build_robot(u, hw, freeflyer=ff,
                                                                    device="cpu"))
            for name, (u, hw, ff) in _cases().items()}


def _tree_arrays(tree):
    return {k: np.asarray(getattr(tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}


def _assert_trees_equal(got, want_tree, atol=0.0):
    want = tree_from_arrays(_tree_arrays(want_tree), device="cpu")
    for k in STATIC_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, k
        if atol:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


def _assert_motors_equal(got, want, atol=0.0):
    for k in MOTOR_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0, err_msg=k)
        else:
            assert tuple(a) == tuple(b), k


def _assert_sensors_equal(got, want, atol=0.0):
    assert got.period == want.period
    assert [g.type for g in got.groups] == [g.type for g in want.groups]
    for g, w in zip(got.groups, want.groups):
        assert (tuple(g.target), tuple(g.name), g.buf_len) == (tuple(w.target), tuple(w.name),
                                                                w.buf_len), g.type
        for k in ("delay", "bias", "noise_std"):
            a = getattr(g, k)
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            np.testing.assert_allclose(a, np.asarray(getattr(w, k)), atol=atol, rtol=0,
                                       err_msg=f"{g.type} {k}")


def _assert_geometry_equal(got, want):
    """Parsed <collision> maps {link: (body, [tuples])} or display maps
    {body: [dicts]} equal, arrays exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_geometry_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_geometry_equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("case", list(_cases()))
def test_build_robot_matches_reference(robots, case):
    jrobot, robot = robots[case]
    _assert_trees_equal(robot.tree, jrobot.tree)
    _assert_motors_equal(robot.motors, jrobot.motors)
    _assert_sensors_equal(robot.sensors, jrobot.sensors)
    _assert_geometry_equal(robot.collision_shapes, jrobot.collision_shapes)
    _assert_geometry_equal(robot.visuals, jrobot.visuals)
    assert robot.nmotors == jrobot.nmotors and robot.name == jrobot.name


def test_atlas_flexibility_and_capsule_shift(robots):
    tree = robots["atlas_files_flexible"][1].tree
    assert (tree.nb, tree.nq, tree.nv, tree.body_name[1]) == (25, 34, 32, "torso_yaw_l_flex")
    rigid, flexible = (robots[c][1] for c in ("capsule_feet", "capsule_feet_flexible"))
    i = flexible.tree.body_name.index("LF_SHANK_flex")
    for link, (body, _) in rigid.collision_shapes.items():
        assert flexible.collision_shapes[link][0] == (body + 1 if body >= i else body), link


def test_urdf_text_and_hardware_match_reference():
    for p, jp in ((quadruped.ANYMAL, j_quadruped.ANYMAL),
                  (quadruped.SPOTMICRO, j_quadruped.SPOTMICRO), (P_CAPSULE, J_CAPSULE)):
        assert quadruped.quadruped_urdf(p) == j_quadruped.quadruped_urdf(jp)
        assert quadruped.quadruped_hardware(p, 0.004, 0.02, 0.005) == \
            j_quadruped.quadruped_hardware(jp, 0.004, 0.02, 0.005)
    assert quadruped.anymal_urdf() == (DATA / "anymal.urdf").read_text().rstrip("\n")
    assert quadruped.anymal_hardware(0.01) == j_quadruped.anymal_hardware(0.01)
    assert humanoid.humanoid_urdf() == j_humanoid.humanoid_urdf()
    assert humanoid.humanoid_hardware(flexibility=True) == \
        j_humanoid.humanoid_hardware(flexibility=True)
    assert quadruped.STAND_HEIGHT == j_quadruped.STAND_HEIGHT


@pytest.mark.parametrize("name", ["anymal", "spotmicro"])
def test_urdf_route_matches_the_direct_builder(name):
    """The URDF-built quadruped against the port's ``make_quadruped``
    (which builds the tree directly), within 1e-7."""
    p = {"anymal": quadruped.ANYMAL, "spotmicro": quadruped.SPOTMICRO}[name]
    kw = dict(sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
    robot = build_robot(quadruped.quadruped_urdf(p), quadruped.quadruped_hardware(p, **kw),
                        freeflyer=True, sensor_period=0.005, device="cpu")
    tree, motors, sensors = quadruped.make_quadruped(p, device="cpu", sensor_period=0.005, **kw)
    _assert_trees_equal(tree, robot.tree, atol=1e-7)
    _assert_motors_equal(motors, robot.motors, atol=1e-7)
    _assert_sensors_equal(sensors, robot.sensors, atol=1e-7)
    np.testing.assert_array_equal(quadruped.stand_q(tree, p), quadruped.stand_q(robot.tree, p))


def test_capsule_feet_build():
    """The reference's ``test_capsule_feet_build``, and the stand pose,
    ``make_quadruped`` taking the URDF route."""
    tree, _, sensors = quadruped.make_quadruped(P_CAPSULE, device="cpu")
    jrobot = j_quadruped.make_quadruped(J_CAPSULE)
    assert tree.ncp == 8
    np.testing.assert_allclose(tree.contact_radius.numpy(), 0.02)
    np.testing.assert_allclose(sorted(np.abs(tree.contact_pos[:, 1].numpy())), [0.04] * 8,
                               atol=1e-5)
    assert {g.type: g.ns for g in sensors.groups}["contact"] == 4
    _assert_trees_equal(tree, jrobot.tree)
    _assert_sensors_equal(sensors, jrobot.sensors)
    np.testing.assert_array_equal(quadruped.stand_q(tree, P_CAPSULE),
                                  j_quadruped.stand_q(jrobot.tree, J_CAPSULE))


def test_default_hardware_matches_reference():
    for source in (DATA / "anymal.urdf", DATA / "atlas.urdf"):
        for ff in (True, False):
            jb, jinfo = j_urdf.parse_urdf(source, freeflyer=ff)
            b, info = parse_urdf(source, freeflyer=ff)
            assert info == jinfo
            assert default_hardware(b, info) == j_default_hardware(jb, jinfo)


BAD = {
    "mimic": """<robot name="m"><link name="a"/><link name="b"/>
      <joint name="j" type="revolute"><parent link="a"/><child link="b"/>
      <mimic joint="k"/></joint></robot>""",
    "planar": """<robot name="p"><link name="a"/><link name="b"/>
      <joint name="j" type="planar"><parent link="a"/><child link="b"/></joint></robot>""",
    "root_tag": """<model name="x"><link name="a"/></model><!-- <robot -->""",
}


@pytest.mark.parametrize("case", list(BAD))
def test_refusals_match_reference(case):
    with pytest.raises(ValueError) as want:
        j_urdf.parse_urdf(BAD[case])
    with pytest.raises(ValueError) as got:
        parse_urdf(BAD[case])
    assert str(got.value) == str(want.value)


def test_load_urdf_matches_reference():
    _assert_trees_equal(load_urdf(DATA / "spotmicro.urdf", freeflyer=True, device="cpu"),
                        j_urdf.load_urdf(DATA / "spotmicro.urdf", freeflyer=True))


def _write_cube_stl(path, half=0.1, center=(0.02, -0.01, 0.05)):
    """A binary STL of an axis-aligned cube (``tests/test_mesh_collision.py``'s)."""
    c = np.asarray(center, np.float64)
    corners = np.array([[sx, sy, sz] for sx in (-half, half) for sy in (-half, half)
                        for sz in (-half, half)]) + c
    faces = [(0, 1, 3), (0, 3, 2), (4, 7, 5), (4, 6, 7), (0, 5, 1), (0, 4, 5),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for tri in faces:
            f.write(struct.pack("<3f", 0.0, 0.0, 0.0))
            for idx in tri:
                f.write(struct.pack("<3f", *corners[idx]))
            f.write(struct.pack("<H", 0))
    return corners, faces


SHAPES_URDF = """<?xml version="1.0"?>
<robot name="shapes">
  <link name="base">
    <inertial><mass value="2.0"/>
      <inertia ixx="0.02" iyy="0.03" izz="0.04" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.05"/><geometry><sphere radius="0.08"/></geometry></collision>
    <collision><origin xyz="0.2 0 0" rpy="1.5707963 0 0"/>
      <geometry><capsule radius="0.03" length="0.1"/></geometry></collision>
  </link>
  <link name="arm">
    <inertial><origin xyz="0 0 -0.1" rpy="0.1 0.2 0.3"/><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.02" ixy="0.001" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.1 0.05 -0.2" rpy="0.3 -0.2 0.7"/>
      <geometry><box size="0.1 0.2 0.3"/></geometry></collision>
    <collision><origin xyz="0 0 -0.1"/>
      <geometry><cylinder radius="0.02" length="0.2"/></geometry></collision>
  </link>
  <link name="cube">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.007" iyy="0.007" izz="0.007" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.02" rpy="0 0 0.4"/>
      <geometry><mesh filename="{stl}"/></geometry></collision>
  </link>
  <joint name="shoulder" type="revolute"><parent link="base"/><child link="arm"/>
    <origin xyz="0 0.1 0" rpy="0 0.2 0"/><axis xyz="0 1 0"/>
    <limit lower="-1" upper="1" effort="10" velocity="5"/></joint>
  <joint name="slide" type="prismatic"><parent link="base"/><child link="cube"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 0 1"/>
    <limit lower="-2" upper="2" effort="100" velocity="10"/></joint>
</robot>"""


def test_read_stl_matches_reference(tmp_path):
    corners, faces = _write_cube_stl(tmp_path / "cube.stl")
    for scale in (1.0, (2.0, 1.0, 0.5)):
        for got, want in zip(read_stl(tmp_path / "cube.stl", scale),
                             j_read_stl(tmp_path / "cube.stl", scale)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    lines = ["solid cube"]
    for tri in faces:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += ["vertex " + " ".join(repr(float(c)) for c in v) for v in corners[list(tri)]]
        lines += ["endloop", "endfacet"]
    (tmp_path / "cube_ascii.stl").write_text("\n".join(lines + ["endsolid cube"]))
    for got, want in zip(read_stl(tmp_path / "cube_ascii.stl"),
                         j_read_stl(tmp_path / "cube_ascii.stl")):
        np.testing.assert_array_equal(got, want)


def test_shape_for_link_matches_reference(tmp_path):
    _write_cube_stl(tmp_path / "cube.stl")
    urdf = SHAPES_URDF.format(stl=tmp_path / "cube.stl")
    hw = {"Global": {"collisionBodyNames": ["base", "arm", "cube"]}}
    jrobot = j_build_robot(urdf, hw, freeflyer=True)
    robot = build_robot(urdf, hw, freeflyer=True, device="cpu")
    _assert_trees_equal(robot.tree, jrobot.tree)
    _assert_geometry_equal(robot.collision_shapes, jrobot.collision_shapes)
    _assert_geometry_equal(robot.visuals, jrobot.visuals)
    kinds = []
    for link, (_, geoms) in jrobot.collision_shapes.items():
        for index in range(len(geoms)):
            for exact in (True, False):
                got = collision.shape_for_link(robot, link, index, exact)
                want = j_collision.shape_for_link(jrobot, link, index, exact)
                assert type(got).__name__ == type(want).__name__
                _assert_geometry_equal(dataclasses.astuple(got), dataclasses.astuple(want))
                kinds.append((geoms[index][0], type(got).__name__))
    assert set(kinds) == {("sphere", "Sphere"), ("capsule", "Capsule"), ("box", "Box"),
                          ("box", "Capsule"), ("mesh", "ConvexMesh"), ("mesh", "Capsule")}
    with pytest.raises(ValueError):
        collision.shape_for_link(robot, "nowhere")


@pytest.fixture(scope="module")
def capsule_robot():
    return build_robot(quadruped.quadruped_urdf(P_CAPSULE),
                       quadruped.quadruped_hardware(P_CAPSULE, 0.004, 0.02, 0.005),
                       freeflyer=True, sensor_period=5e-3, device="cpu")


def test_capsule_feet_stand(capsule_robot):
    """The reference's ``test_capsule_feet_stand`` at B = 4."""
    env = WalkerEnv(capsule_robot, stand_pose=quadruped.stand_q(capsule_robot.tree, P_CAPSULE),
                    max_steps=100, reset_noise=0.02, min_height=0.4, observe="state",
                    device="cpu")
    assert env.engine.nc == 36
    st = env.reset(torch.Generator().manual_seed(0), 4)
    zero = torch.zeros(4, 12)
    for _ in range(25):  # 0.5 s
        st = env.step(st, zero)
    assert bool(torch.isfinite(st.obs).all())
    assert bool((st.sim.q[:, 2] > 0.45).all()), st.sim.q[:, 2]
    assert not bool(st.terminated.any())


def test_walker_takes_a_robot(capsule_robot):
    r = capsule_robot
    stand = quadruped.stand_q(r.tree, P_CAPSULE)
    kw = dict(observe="sensors", sim_dt=5e-3, device="cpu")
    envs = [WalkerEnv(r, stand_pose=stand, **kw),
            WalkerEnv(r.tree, r.motors, stand, sensors=r.sensors, **kw)]
    gen = torch.Generator().manual_seed(3)
    actions = [torch.rand(3, 12, generator=gen) * 2 - 1 for _ in range(2)]
    outs = []
    for env in envs:
        st = env.reset(torch.Generator().manual_seed(1), 3)
        for a in actions:
            st = env.step(st, a)
        outs.append(st)
    for k in ("obs", "reward"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k
    assert torch.equal(outs[0].sim.q, outs[1].sim.q) and torch.equal(outs[0].sim.v, outs[1].sim.v)
    assert torch.equal(outs[0].info["sensor_bufs"], outs[1].info["sensor_bufs"])
    with pytest.raises(TypeError, match="stand_pose= by keyword"):
        WalkerEnv(r, r.motors, stand, **kw)  # a Robot brings its own motors
