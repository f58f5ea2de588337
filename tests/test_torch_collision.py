"""The port's collision module against jiminy_tpu's ``engine/collision.py``.

- ``closest_segment_segment`` on random segments (with degenerate ones:
  points, parallel and crossing segments) and ``box_sdf`` on random points
  in and around a box (with exact ties between axes): float32 on both
  sides, within 1e-6.
- ``CollisionPairSet``: the generators, ``contacts_per_pair`` and
  ``total_contacts`` field for field for Cassie's self-collision pairs
  (``seg``), for Atlas's pairs on the reference's Atlas tree crossed with
  ``tree_from_arrays`` (two ``seg`` and two ``ptbox`` of 5 points), for a
  convex cloud against a capsule (``ptseg``) and for two clouds (``ptseg``
  both ways, with a given capsule and with one fitted by ``fit_capsule``).
- ``pair_rows`` on those trees and pairs against the reference's from the
  same joint states, float64 on both sides (the reference's trees copied
  to float64): J, target, active and μ within 1e-9 (μ and active exactly).
- ``surface_contacts`` with sphere sites (a capsule against the ground
  as its two end spheres, ``add_contact_capsule``, on a free body) on a
  Fourier ground: points, velocities (the rolling lever arm), depths and
  normals against the reference's in float64 within 1e-12.
- ``shape_for_link`` on a robot parsed from a URDF (a capsule shin)
  equals the reference's, and refuses a link without ``<collision>``
  geometry with the reference's ValueError.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.engine import collision as jc
from jiminy_tpu.engine import contact as jcontact
from jiminy_tpu.engine import ground as jg
from jiminy_tpu.io.urdf import _fit_capsule as j_fit_capsule
from jiminy_tpu.models.biped import cassie_self_collision_pairs as j_cassie_pairs
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu.models.humanoid import atlas_self_collision_pairs, make_atlas
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
from jiminy_tpu_torch.engine import collision as pc
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.contact import surface_contacts
from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DT, ALPHA, MARGIN, SLOP, MAX_CORR = 2e-3, 0.25, 5e-3, 1e-3, 0.2
B = 16
CLOUD = ((0.06, 0.0, -0.17), (-0.06, 0.0, -0.17), (0.0, 0.08, -0.17), (0.0, -0.08, -0.17),
         (0.0, 0.0, -0.05), (0.0, 0.0, -0.29))


def _port_shape(shape):
    """The port's shape of the same kind and fields as a reference shape."""
    return getattr(pc, type(shape).__name__)(**dataclasses.asdict(shape))


def _port_pairs(pairs):
    return tuple(pc.CollisionPair(_port_shape(p.a), _port_shape(p.b), p.friction) for p in pairs)


def _port_tree(jtree):
    return tree_from_arrays(
        {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def cassie():
    robot, _, stand = j_make_cassie()
    return robot.tree, np.asarray(stand)


@pytest.fixture(scope="module")
def atlas():
    return make_atlas().tree


def _mesh_pairs():
    """A cloud on the R tarsus against the L tarsus capsule (ptseg), and
    the cloud against a cloud on the L tarsus, once with the second's
    capsule given and once fitted."""
    mesh = jc.ConvexMesh("R_tarsus", CLOUD)
    left = tuple((x, -y, z) for x, y, z in CLOUD)
    given = jc.ConvexMesh("L_tarsus", left, ((0.0, 0.0, -0.05), (0.0, 0.0, -0.29), 0.08))
    return (
        jc.CollisionPair(mesh, jc.Capsule("L_tarsus", (0, 0, 0), (0, 0, -0.35), 0.04),
                         friction=0.6),
        jc.CollisionPair(mesh, given),
        jc.CollisionPair(jc.ConvexMesh("L_tarsus", left), mesh),
    )


def test_closest_segment_segment_matches_reference():
    rng = np.random.default_rng(0)
    n = 512
    p1, q1, p2, q2 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4))
    q1[:32] = p1[:32]  # a point against a segment
    q2[16:48] = p2[16:48]  # and two points
    q2[64:96] = p2[64:96] + (q1[64:96] - p1[64:96])  # parallel segments
    want = jax.vmap(jc.closest_segment_segment)(*(jnp.asarray(a) for a in (p1, q1, p2, q2)))
    got = pc.closest_segment_segment(*(torch.as_tensor(a) for a in (p1, q1, p2, q2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the reference's own closed forms
    ca, cb = pc.closest_segment_segment(*(torch.tensor(x, dtype=torch.float32) for x in (
        [-1.0, 0, 0], [1.0, 0, 0], [0.0, -1, 0.5], [0.0, 1, 0.5])))
    np.testing.assert_allclose(ca.numpy(), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(cb.numpy(), [0, 0, 0.5], atol=1e-6)


def test_box_sdf_matches_reference():
    rng = np.random.default_rng(1)
    h = np.array([0.1, 0.07, 0.05], np.float32)
    pts = rng.uniform(-0.2, 0.2, (512, 3)).astype(np.float32)
    pts[:64] *= 0.3  # inside
    cube = np.array([0.05, 0.05, 0.05], np.float32)
    pts[64:72] = cube * np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                                  for sz in (-1, 1)], np.float32) * 0.5  # ties inside a cube
    hh = np.where(np.arange(512)[:, None] < 72, cube, h)
    for k in range(512):  # one box per point, so the ties see a cube
        sdf_w, n_w = jc.box_sdf(jnp.asarray(pts[k:k + 1]), jnp.asarray(hh[k]))
        sdf_g, n_g = pc.box_sdf(torch.as_tensor(pts[k:k + 1]), torch.as_tensor(hh[k]))
        np.testing.assert_allclose(sdf_g.numpy(), np.asarray(sdf_w), atol=1e-6, rtol=0)
        np.testing.assert_allclose(n_g.numpy(), np.asarray(n_w), atol=1e-6, rtol=0)
    # batched: (B, k, 3) at once against the loop's (k, 3)
    sdf_b, _ = pc.box_sdf(torch.as_tensor(pts[72:]).reshape(8, 55, 3), torch.as_tensor(h))
    sdf_w, _ = jc.box_sdf(jnp.asarray(pts[72:]), jnp.asarray(h))
    np.testing.assert_allclose(sdf_b.reshape(-1).numpy(), np.asarray(sdf_w), atol=1e-6, rtol=0)


def _assert_same_gens(got: pc.CollisionPairSet, want: jc.CollisionPairSet):
    assert got.n == want.n
    assert got.contacts_per_pair == want.contacts_per_pair
    assert got.total_contacts == want.total_contacts
    for (kind, g), (wkind, w) in zip(got.gens, want.gens, strict=True):
        assert kind == wkind and set(g) == set(w)
        for k, x in w.items():
            np.testing.assert_allclose(np.asarray(g[k], np.float64), np.asarray(x, np.float64),
                                       rtol=1e-7, atol=0, err_msg=f"{kind} {k}")


def test_pair_sets_match_reference(cassie, atlas):
    jtree, _ = cassie
    tree = _port_tree(jtree)
    cases = [(jtree, tree, j_cassie_pairs(), [1, 1, 1]),
             (atlas, _port_tree(atlas), atlas_self_collision_pairs(), [1, 1, 5, 5]),
             (jtree, tree, _mesh_pairs(), [6, 12, 12])]
    for jt, pt, jpairs, per_pair in cases:
        want = jc.CollisionPairSet(jt, jpairs, 0.9)
        got = pc.CollisionPairSet(pt, _port_pairs(jpairs), 0.9)
        _assert_same_gens(got, want)
        assert got.contacts_per_pair == per_pair
    kinds = [k for k, _ in pc.CollisionPairSet(_port_tree(atlas), _port_pairs(
        atlas_self_collision_pairs()), 1.0).gens]
    assert kinds == ["seg", "seg", "ptbox", "ptbox"]
    # the port's own Cassie pairs are the reference's
    _assert_same_gens(pc.CollisionPairSet(tree, cassie_self_collision_pairs(), 1.0),
                      jc.CollisionPairSet(jtree, j_cassie_pairs(), 1.0))
    with pytest.raises(ValueError, match="same body"):
        pc.CollisionPairSet(tree, (pc.CollisionPair(pc.Sphere(3, (0, 0, 0), 0.1),
                                                    pc.Sphere(3, (0, 0, 0), 0.1)),), 1.0)


def test_fit_capsule_matches_reference():
    rng = np.random.default_rng(2)
    for cloud in (np.asarray(CLOUD), rng.standard_normal((20, 3)) * [0.02, 0.02, 0.2],
                  rng.standard_normal((12, 3)) * 0.05):
        got, want = pc.fit_capsule(cloud), j_fit_capsule(cloud)
        np.testing.assert_allclose(got[0], want[0], atol=1e-7)
        np.testing.assert_allclose(got[1], want[1], atol=1e-7)
        assert got[2] == pytest.approx(want[2], abs=1e-12)


def _f64_tree(jtree):
    return jtree.replace(**{k: jnp.asarray(np.asarray(getattr(jtree, k)), jnp.float64)
                            for k in ARRAY_FIELDS})


def _states(jtree, tree, rng, base=None):
    """Joint states: around ``base`` (Cassie's stand pose with the legs
    brought together) or random joint angles under a tilted free base."""
    q = np.zeros((B, tree.nq))
    if base is not None:
        q[:] = base
        j = lambda n: tree.q_off[tree.joint_index(n)]  # noqa: E731
        q[:, j("L_hip_roll")] = -rng.uniform(0.0, 0.4, B)
        q[:, j("R_hip_roll")] = rng.uniform(0.0, 0.4, B)
        q[:, [j("L_hip_yaw"), j("R_hip_yaw")]] = rng.uniform(-0.3, 0.3, (B, 2))
    else:
        q[:, 7:] = rng.uniform(-0.6, 0.6, (B, tree.nq - 7))
        q[:, 2] = 1.0
        quat = np.concatenate([rng.uniform(-0.1, 0.1, (B, 3)), np.ones((B, 1))], 1)
        q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    return q


def _rows_pair(jtree, tree, jpairs, q):
    """(port rows, reference rows) for the pairs at the states q, float64."""
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    jt = _f64_tree(jtree)
    jset = jc.CollisionPairSet(jt, jpairs, 0.9)

    def one(qq):
        xw = jalgos.forward_kinematics(jt, qq)
        return jc.pair_rows(jset, jt, xw, jnp.float64, DT, ALPHA, MARGIN, SLOP, MAX_CORR)

    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(q, jnp.float64))]
    t64 = tree.to(dtype=torch.float64)
    xw = algos.forward_kinematics(t64, torch.as_tensor(q))
    got = pc.pair_rows(pc.CollisionPairSet(t64, _port_pairs(jpairs), 0.9), t64, xw, DT,
                       ALPHA / DT, MARGIN, SLOP, MAX_CORR)
    return [x.numpy() for x in got], want


@pytest.mark.parametrize("case", ["cassie_seg", "cassie_mesh", "atlas"])
def test_pair_rows_match_reference(case, cassie, atlas):
    rng = np.random.default_rng(3)
    if case == "atlas":
        jtree, base, jpairs = atlas, None, atlas_self_collision_pairs()
    else:
        jtree, base = cassie
        jpairs = j_cassie_pairs() if case == "cassie_seg" else _mesh_pairs()
    tree = _port_tree(jtree)
    q = _states(jtree, tree, rng, base)
    got, want = _rows_pair(jtree, tree, jpairs, q)
    n = 3 * pc.CollisionPairSet(tree, _port_pairs(jpairs), 0.9).total_contacts
    assert got[0].shape == (B, n, tree.nv) and want[0].shape == (B, n, tree.nv)
    for name, g, w in zip(("J", "target", "active", "mu"), got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float64), atol=1e-9, rtol=0,
                                   err_msg=f"{case} {name}")
    assert (got[2] > 0).any()  # some rows active
    assert set(np.unique(got[3])) <= {0.6, 0.9}


def test_shape_for_link_waits_for_the_urdf_parser():
    """The URDF parser has landed: a capsule shin parses to the
    reference's shape, and a link without geometry raises as there."""
    from jiminy_tpu.robot import build_robot as j_build_robot
    from jiminy_tpu_torch.robot import build_robot

    urdf = """<robot name="leg"><link name="l_shin"><inertial><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
      <collision><origin xyz="0 0 -0.2" rpy="0.1 0 0"/>
      <geometry><capsule radius="0.04" length="0.3"/></geometry></collision></link></robot>"""
    got = pc.shape_for_link(build_robot(urdf, {}, freeflyer=True, device="cpu"), "l_shin")
    want = jc.shape_for_link(j_build_robot(urdf, {}, freeflyer=True), "l_shin")
    assert isinstance(got, pc.Capsule) and got.body == want.body == 0
    np.testing.assert_allclose(np.array([got.p0, got.p1]), np.array([want.p0, want.p1]),
                               rtol=0, atol=1e-7)
    assert got.radius == want.radius == pytest.approx(0.04)
    with pytest.raises(ValueError, match="no parsed <collision> geometry"):
        pc.shape_for_link(build_robot(urdf, {}, freeflyer=True, device="cpu"), "r_shin")


def test_sphere_site_surface_contacts_match_reference():
    """A free body with a capsule foot (two end spheres of radius 0.05)
    and a bare point, built by both packages' builders, on a 4-term
    Fourier ground."""
    def build(builder_cls, joint_type, **kw):
        b = builder_cls()
        body = b.add_body("shin", -1, joint_type.FREE, mass=1.0, inertia=np.diag([0.01] * 3))
        b.add_frame("shin", body)
        b.add_contact_capsule("foot", body, (0.0, -0.05, -0.2), (0.0, 0.05, -0.2), 0.05)
        b.add_contact_point("toe", body, (0.1, 0.0, -0.25))
        return b.build(**kw)

    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    jt = _f64_tree(build(JTreeBuilder, JJointType))
    tree = build(TreeBuilder, JointType, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tree.contact_radius.numpy(), np.float32([0.05, 0.05, 0.0]))
    rng = np.random.default_rng(4)
    K = 4
    coef = np.concatenate([0.05 * 0.5 ** np.arange(K), rng.uniform(-6, 6, (2, K)).ravel(),
                           rng.uniform(0, 6.3, K)])
    jground = jg.FourierGround(*(jnp.asarray(coef[i * K:(i + 1) * K]) for i in range(4)))
    ground = pg.FourierGround(torch.as_tensor(coef))
    q = np.zeros((B, 7))
    q[:, :3] = rng.uniform(-1, 1, (B, 3)) * [1, 1, 0.05] + [0, 0, 0.22]
    quat = rng.standard_normal((B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.standard_normal((B, 6))

    def one(qq, vv):
        xw, vel = jalgos.kinematics(jt, qq, vv)
        return jcontact.surface_contacts(jt, xw, vel, jground)

    want = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v))
    xw, vel = algos.kinematics(tree, torch.as_tensor(q), torch.as_tensor(v))
    got = surface_contacts(tree, xw, vel, ground, spheres=True)
    for name, g, w in zip(("points", "velocities", "depth", "normal"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0, err_msg=name)
