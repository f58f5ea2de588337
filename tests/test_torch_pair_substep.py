"""The port's substep with collision pairs and sphere sites against
jiminy_tpu's.

One substep of the port's plain version (every backend: ``"substep"``,
``"kernel"``, ``"inline"``; on the CPU the first two run the plain
versions of their kernels) against the reference engine with
``constraint_solver="xla"`` and the same declared pairs, from the same
seeded numpy states, float64 on both sides with the reference's model
copied to float64 (as tests/test_torch_cassie.py: its float32 constants
would put it further off on Cassie): within 1e-9 in q, v, λ and the
residual, 1e-9/dt in the contact forces. The cases:

- Cassie with its three self-collision capsule pairs (``seg``), the legs
  brought together by inward hip rolls and yaws (nc = 37, five colors);
- the two-ball forest of tests/test_pair_collision.py (two FREE roots, no
  ground contact, no bounds: the pair rows alone), the balls overlapping,
  touching and apart;
- on that forest, a box on one ball against a capsule on the other
  (``ptbox``, 5 contacts) with a sphere pair beside it, and a convex
  point cloud against a capsule (``ptseg``, 6 contacts);
- the sphere-site ball of tests/test_collision.py (``make_ball``) on flat
  ground and on a Fourier ground (the two-pass site offset).

Each case asserts that some pair rows (or the sphere site) are active in
a quarter of the envs at least, so the comparison holds the rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.core.tree import merge_trees
from jiminy_tpu.engine import collision as jc
from jiminy_tpu.engine import ground as jg
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.biped import cassie_self_collision_pairs as j_cassie_pairs
from jiminy_tpu.models.biped import make_cassie as j_make_cassie
from jiminy_tpu.models.toys import make_ball as j_make_ball
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.engine import collision as pc
from jiminy_tpu_torch.engine import ground as pg
from jiminy_tpu_torch.engine.constraints import distance_constraint_from_arrays
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B = 8
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)
SIM_FIELDS = ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")
CONSTRAINT_FIELDS = ("frame1", "frame2", "distance", "baumgarte_freq")
SOLVERS = ("substep", "kernel", "inline")


def _port_tree(jtree):
    return tree_from_arrays(
        {k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS}, device="cpu")


def _f64(obj, fields):
    return obj.replace(**{k: jnp.asarray(np.asarray(getattr(obj, k)), jnp.float64)
                          for k in fields})


def _jax_step(case, arrays):
    """The reference ``"xla"`` engine's one substep in float64 on a float64
    copy of its model, vmapped over the envs."""
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it
    motors = _f64(case["jmotors"], MOTOR_FIELDS[3:]) if case.get("jmotors") is not None else None
    ctrl = JPDController(*case["pd"]) if case.get("pd") else None
    eng = JEngine(_f64(case["jtree"], ARRAY_FIELDS),
                  JEngineOptions(contact_model="constraint", constraint_solver="xla",
                                 dt=case["dt"], pgs_iters=8, compute_solver_residual=True),
                  ground=_jax_ground(case.get("coef")), motors=motors, controller=ctrl,
                  constraints=case.get("jcons", ()), collision_pairs=case["jpairs"])
    q, v, lam, u, wrench = (jnp.asarray(a, jnp.float64) for a in arrays)
    states = jax.vmap(lambda qq: eng.reset(q=qq))(q).replace(v=v, lam=lam)
    out = jax.jit(jax.vmap(lambda s, uu, w: eng.step(s, uu, base_wrench=w)))(states, u, wrench)
    return {k: np.asarray(getattr(out, k)) for k in SIM_FIELDS}


def _jax_ground(coef):
    """The reference's Fourier ground of coefficients ``coef`` (4K,) in
    float64 (made after x64 is on), or its flat ground for None."""
    if coef is None:
        return None
    return jg.FourierGround(*(jnp.asarray(coef[i * K:(i + 1) * K], jnp.float64)
                              for i in range(4)))


def _port_engine(case, solver, dtype=torch.float64):
    motors = case.get("motors")
    return Engine(
        case["tree"].to(dtype=dtype),
        EngineOptions(contact_model="constraint", dt=case["dt"], pgs_iters=8,
                      compute_solver_residual=True,
                      constraint_solver=solver),
        ground=case.get("ground"), motors=motors.to(dtype=dtype) if motors else None,
        controller=PDController(*case["pd"]) if case.get("pd") else None,
        constraints=case.get("cons", ()), collision_pairs=case["pairs"], device="cpu")


def _port_step(eng, arrays):
    q, v, lam, u, wrench = (torch.as_tensor(a, dtype=torch.float64) for a in arrays)
    state = eng.reset(q, v)
    state.lam = lam
    out = eng.step(state, u, base_wrench=wrench)
    return {k: getattr(out, k).numpy() for k in SIM_FIELDS}


def _active_pair_share(eng, q):
    """Share of envs with a pair row active (depth > −margin) at q."""
    spec = eng.substep_spec
    tree = spec.tree
    xw = algos.forward_kinematics(tree, torch.as_tensor(q, dtype=tree.dtype))
    o = spec.options
    _, _, act, _ = pc.pair_rows(spec.pairs, tree, xw, spec.dt, spec.alpha_c_over_dt,
                                o.contact_margin, o.contact_slop, o.contact_max_correction_vel)
    return float((act > 0).any(dim=1).double().mean())


def _common(rng, nv, nc, q):
    v = 0.3 * rng.standard_normal((B, nv))
    lam = np.abs(0.05 * rng.standard_normal((B, nc)))
    wrench = np.concatenate([2.0 * rng.standard_normal((B, 3)),
                             10.0 * rng.standard_normal((B, 3))], 1)
    return v, lam, wrench


# ---- the cases ---------------------------------------------------------------

def _cassie_case(seed=0):
    robot, cons, stand = j_make_cassie()
    tree = _port_tree(robot.tree)
    motors = motors_from_arrays(
        {k: np.asarray(getattr(robot.motors, k)) for k in MOTOR_FIELDS}, device="cpu")
    pcons = tuple(distance_constraint_from_arrays(
        {k: np.asarray(getattr(c, k)) for k in CONSTRAINT_FIELDS}) for c in cons)
    case = dict(jtree=robot.tree, jmotors=robot.motors, jcons=cons, jpairs=j_cassie_pairs(),
                tree=tree, motors=motors, cons=pcons, pairs=cassie_self_collision_pairs(),
                pd=(150.0, 6.0), dt=2e-3)
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(stand), (B, 1)).astype(np.float64)
    qi = list(motors.q_idx)
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, 10))
    j = lambda n: tree.q_off[tree.joint_index(n)]  # noqa: E731
    q[:, j("L_hip_roll")] = -rng.uniform(0.0, 0.3, B)  # inward: the legs come together
    q[:, j("R_hip_roll")] = rng.uniform(0.0, 0.3, B)
    q[:, [j("L_hip_yaw"), j("R_hip_yaw")]] = rng.uniform(-0.3, 0.3, (B, 2))
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    v, lam, wrench = _common(rng, tree.nv, 37, q)
    u = q[:, qi] + rng.uniform(-0.1, 0.1, (B, 10))
    return case, (q, v, lam, u, wrench)


def _two_balls(r=0.1):
    def ball(name):
        b = JTreeBuilder(gravity=(0.0, 0.0, 0.0))
        i = 0.4 * r * r
        b.add_body(name, parent=-1, joint_type=JJointType.FREE, mass=1.0, com=(0, 0, 0),
                   inertia=np.diag([i, i, i]).astype(np.float32), joint_name=f"{name}_root")
        return b.build()

    return merge_trees([ball("ball_a"), ball("ball_b")])


def _forest_case(kind, seed=1):
    """Two free balls; ball_b 0.12–0.32 m from ball_a along a random
    direction (0.05–0.18 m for the point cloud), both turned at random."""
    jtree = _two_balls()
    a, b = "robot0/ball_a", "robot1/ball_b"
    if kind == "spheres":
        shapes = [((jc.Sphere, (a, (0, 0, 0), 0.1)), (jc.Sphere, (b, (0, 0, 0), 0.1)), 0.0)]
    elif kind == "ptbox":
        rot = tuple(map(tuple, _rot(0.3, 0.2, -0.4)))
        shapes = [((jc.Box, (a, (0.01, 0.0, 0.0), (0.09, 0.07, 0.06), rot)),
                   (jc.Capsule, (b, (0, 0, -0.06), (0, 0, 0.06), 0.03)), 0.7),
                  ((jc.Sphere, (a, (0, 0, 0), 0.02)), (jc.Sphere, (b, (0, 0, 0), 0.03)), None)]
    else:  # ptseg: a 6-point cloud against a capsule
        pts = tuple((0.07 * x, 0.06 * y, 0.05 * z) for x, y, z in
                    ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)))
        shapes = [((jc.ConvexMesh, (a, pts)),
                   (jc.Capsule, (b, (-0.05, 0, 0), (0.05, 0, 0), 0.04)), 0.5)]
    port = {jc.Sphere: pc.Sphere, jc.Box: pc.Box, jc.Capsule: pc.Capsule,
            jc.ConvexMesh: pc.ConvexMesh}
    jpairs = tuple(jc.CollisionPair(sa(*aa), sb(*ab), friction=mu)
                   for (sa, aa), (sb, ab), mu in shapes)
    ppairs = tuple(pc.CollisionPair(port[sa](*aa), port[sb](*ab), friction=mu)
                   for (sa, aa), (sb, ab), mu in shapes)
    case = dict(jtree=jtree, jpairs=jpairs, tree=_port_tree(jtree), pairs=ppairs, dt=1e-3)
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 14))
    for o in (3, 10):  # each ball's quaternion
        quat = rng.standard_normal((B, 4))
        q[:, o:o + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    d = rng.standard_normal((B, 3))
    lo, hi = (0.05, 0.18) if kind == "ptseg" else (0.12, 0.32)
    q[:, 7:10] = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(lo, hi, (B, 1))
    nc = 3 * pc.CollisionPairSet(case["tree"], ppairs, 1.0).total_contacts
    v, lam, wrench = _common(rng, 12, nc, q)
    return case, (q, v, lam, 0.5 * rng.standard_normal((B, 12)), wrench)


def _rot(a, b, c):
    """Rz(c)·Ry(b)·Rx(a)."""
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    Rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    Ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    Rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


K = 8


def _ball_case(ground, seed=2):
    """make_ball (one sphere site of radius 0.1 at its centre, μ 1) on the
    ground, the centre 1 cm into it to 1 cm above it, spinning and
    sliding."""
    jtree = j_make_ball(mass=1.0, radius=0.1)
    rng = np.random.default_rng(seed)
    case = dict(jtree=jtree, jpairs=(), tree=_port_tree(jtree), pairs=(), dt=1e-3)
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    h = np.zeros(B)
    if ground == "fourier":
        amp = 0.05 * 0.5 ** np.arange(K)
        th = rng.uniform(0, 2 * np.pi, K)
        mag = 2 * np.pi / 1.2 * 1.5 ** np.arange(K)
        coef = np.concatenate([amp, mag * np.cos(th), mag * np.sin(th), rng.uniform(0, 6.3, K)])
        case["coef"] = coef
        case["ground"] = pg.FourierGround(torch.as_tensor(coef, dtype=torch.float64))
        h = case["ground"].query(torch.as_tensor(xy))[0].numpy()
    q = np.zeros((B, 7))
    q[:, :2] = xy
    q[:, 2] = h + 0.1 + rng.uniform(-0.01, 0.01, B)
    quat = rng.standard_normal((B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v, lam, wrench = _common(rng, 6, 3, q)
    v[:, 3:] *= 10.0
    return case, (q, v, lam, rng.standard_normal((B, 6)), wrench)


CASES = {
    "cassie_seg": _cassie_case,
    "forest_spheres": lambda: _forest_case("spheres"),
    "forest_ptbox": lambda: _forest_case("ptbox"),
    "forest_ptseg": lambda: _forest_case("ptseg"),
    "ball_flat": lambda: _ball_case("flat"),
    "ball_fourier": lambda: _ball_case("fourier"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_substep_matches_reference_in_f64(name):
    case, arrays = CASES[name]()
    want = _jax_step(case, arrays)
    assert want["q"].dtype == np.float64
    engines = {s: _port_engine(case, s) for s in SOLVERS}
    spec = engines["substep"].substep_spec
    assert engines["substep"].backend == "substep"
    if case["pairs"]:
        assert _active_pair_share(engines["inline"], arrays[0]) >= 0.25
        assert np.abs(want["lam"][:, spec.pair_off:]).max() > 1e-3  # the pairs push
    else:
        assert spec.spheres and np.abs(want["contact_forces"]).max() > 1.0  # the site pushes
    dt = case["dt"]
    atol = {"t": 1e-12, "tau": 1e-9, "q": 1e-9, "v": 1e-9, "lam": 1e-9,
            "solver_residual": 1e-9, "contact_forces": 1e-9 / dt, "a": 1e-9 / dt}
    for solver, eng in engines.items():
        got = _port_step(eng, arrays)
        for k, tol in atol.items():
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                       err_msg=f"{name} {solver} {k}")


def test_spec_layout_matches_reference():
    """The Cassie self-collision spec against the reference's
    ``_substep_spec``: nc 37, the colors (two ground, three pairs of one
    contact), each generator field for field; the packed pair section's
    lengths."""
    case, _ = _cassie_case()
    robot, cons, _ = j_make_cassie()
    jeng = JEngine(robot.tree, JEngineOptions(contact_model="constraint",
                                              constraint_solver="pallas_substep", dt=2e-3,
                                              pgs_iters=8),
                   motors=robot.motors, controller=JPDController(150.0, 6.0), constraints=cons,
                   collision_pairs=j_cassie_pairs())
    jspec = jeng._substep_spec
    spec = _port_engine(case, "substep", torch.float32).substep_spec
    assert spec.nc == jspec.cfg.nc == 37 and spec.n_pc == 3 and spec.pair_off == 28
    assert tuple(spec.cfg.contact_colors) == tuple(jspec.cfg.contact_colors)
    assert spec.pair_contacts == jspec.pair_contacts == [1, 1, 1]
    for (kind, g), (jkind, jgen) in zip(spec.pairs.gens, jspec.pair_gens, strict=True):
        assert kind == jkind == "seg"
        for k, want in jgen.items():
            np.testing.assert_allclose(np.asarray(g[k], np.float64), np.asarray(want), rtol=1e-7,
                                       atol=0, err_msg=k)
    si, sf = spec.packed("cpu")
    assert sf[12].item() == 3.0 and sf[13].item() == 0.0  # generators, no sphere site
    n_plain = 16 + 28 * 15 + 3 * 20 + 3 * 4 + 2 * 14 + 8 * 10 + 8 * 2
    assert sf.numel() == n_plain + 3 * 15 and si.numel() == 10 + 4 * 15 + 2 * 4 + 14 + 20 + 4 + 15
    assert si[-15:].reshape(3, 5)[:, [0, 3, 4]].tolist() == [[0, 1, 0], [0, 1, 15], [0, 1, 30]]


@pytest.mark.parametrize("name,tamper", [
    ("cassie_seg", "seg_dropped"), ("forest_ptbox", "ptbox_short"),
    ("forest_ptbox", "reordered"),
])
def test_packing_refuses_generators_off_the_pair_colors(name, tamper):
    """The kernels write each packed generator's count of contacts from
    the pair rows' start, so packing refuses generators that the pair
    colors do not cover exactly: a seg generator dropped (2 contacts
    against Cassie's three one-contact colors), a ptbox generator with 4
    of its 5 points, and the forest's ptbox and sphere generators swapped
    (6 contacts either way, but the first color would end inside the
    box's)."""
    case, _ = CASES[name]()
    spec = _port_engine(case, "substep", torch.float32).substep_spec
    spec.packed("cpu")  # as built, the counts match the colors
    gens = spec.pairs.gens
    spec.pairs = pc.CollisionPairSet.__new__(pc.CollisionPairSet)
    if tamper == "seg_dropped":
        spec.pairs.gens = gens[:2]
    elif tamper == "ptbox_short":
        (kind, g), rest = gens[0], gens[1:]
        spec.pairs.gens = [(kind, {**g, "pts": g["pts"][:4]}), *rest]
    else:
        spec.pairs.gens = gens[::-1]
    spec._packed.clear()
    with pytest.raises(ValueError, match="do not match the pair colors"):
        spec.packed("cpu")


def test_collision_pairs_need_constraint_contacts():
    """As the reference's engine: pairs resolve in the PGS, so another
    contact model is refused; a pair on one body is degenerate."""
    case, _ = _forest_case("spheres")
    with pytest.raises(ValueError, match="contact_model='constraint'"):
        Engine(case["tree"], EngineOptions(contact_model="penalty"),
               collision_pairs=case["pairs"], device="cpu")
    same = pc.CollisionPair(pc.Sphere("robot0/ball_a", (0, 0, 0), 0.1),
                            pc.Sphere("robot0/ball_a", (0.1, 0, 0), 0.1))
    with pytest.raises(ValueError, match="same body"):
        Engine(case["tree"], EngineOptions(contact_model="constraint"), collision_pairs=(same,),
               device="cpu")


def test_sphere_sites_pack_their_radii():
    case, _ = _ball_case("flat")
    spec = _port_engine(case, "substep", torch.float32).substep_spec
    si, sf = spec.packed("cpu")
    assert spec.spheres and sf[13].item() == 1.0 and sf[12].item() == 0.0
    assert sf[-1].item() == pytest.approx(0.1)  # the radius, last (no pair section)
