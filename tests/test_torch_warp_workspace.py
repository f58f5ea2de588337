"""The shared-memory workspace of K2's warp body (``csrc/substep_warp.cuh``),
as ``SubstepSpec.warp_workspace`` lays it out, on every model K2 runs, the
ANYmal frame and the large frame (Cassie with its pairs and flexible hips,
the PRISMATIC slab scene, Atlas with and without its pairs): every region
inside the env's slice, the regions that live at one time apart, every
offset on 16 bytes, W envs per block that fit one block's shared memory,
the ints in the order the C entry point reads them; each large-frame
model's bytes per env; a model past the kernels' caps refused, not
routed. Builds the port's engines on
the CPU; no JAX."""

from __future__ import annotations

import pytest
import torch

from jiminy_tpu_torch.ops.substep_kernel import (
    SMEM_PER_BLOCK,
    WARP_MAX_W,
    WARP_VIEWS,
    SensorKernelSpec,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

# bytes per env, as PERF.md and csrc/substep_warp.cuh state them
ANYMAL_BYTES = 8752
LARGE_FRAME_BYTES = {"cassie_state": 11072, "cassie_sensors": 11072, "cassie_selfcol": 15168,
                     "cassie_flex": 13840, "slab": 13792, "atlas_state": 25776,
                     "atlas_sensors": 25776, "atlas_selfcol": 53712,
                     "atlas_selfcol_sensors": 53712}


def _walker_env(name, **kw):
    from jiminy_tpu_torch.envs import AntEnv, ANYmalEnv, SpotmicroEnv

    return {"anymal": ANYmalEnv, "ant": AntEnv, "spotmicro": SpotmicroEnv}[name](device="cpu",
                                                                             **kw)


def _cassie_pairs(kind):
    """``chip_smoke.py`` `_pair_sets`' ptbox (a box on the pelvis against
    the L thigh capsule, nc 43) and ptseg (a 6-point cloud on the R tarsus
    against the L tarsus capsule, nc 46) on Cassie's tree."""
    from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair, ConvexMesh

    def leg(body):
        return Capsule(body, (0.0, 0.0, 0.0), (0.0, 0.0, -0.35), 0.04)

    if kind == "ptbox":
        return (CollisionPair(Box("pelvis", (0.0, 0.0, -0.15), (0.06, 0.08, 0.08)),
                              leg("L_thigh")),)
    cloud = ((0.06, 0.0, -0.17), (-0.06, 0.0, -0.17), (0.0, 0.08, -0.17), (0.0, -0.08, -0.17),
             (0.0, 0.0, -0.05), (0.0, 0.0, -0.29))
    return (CollisionPair(ConvexMesh("R_tarsus", cloud), leg("L_tarsus"), friction=0.6),)


def _slab_engine(n_cubes=1, solver="substep"):
    """``chip_smoke.py`` `_slab_model`'s scene (tests/test_box_pairs.py's
    sprung PRISMATIC slab and free cube with their box pair, friction 0.8:
    nb 2, nv 7, 16 pair contacts, nc 48) with a direct motor on the slider;
    with ``n_cubes`` 2 a second cube and pair (32 pair contacts, nc 96:
    past the kernels' 24 pair contacts)."""
    import numpy as np

    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.collision import Box, CollisionPair
    from jiminy_tpu_torch.hardware.motors import Motors

    b = TreeBuilder()
    b.add_body("slab", -1, JointType.PRISMATIC, axis=(0, 0, 1), mass=100.0, com=(0, 0, 0.05),
               inertia=np.diag([10.0] * 3), joint_name="slab_z", stiffness=1e7, damping=1e4)
    pairs = []
    for k in range(n_cubes):
        b.add_body(f"cube{k}", -1, JointType.FREE, mass=1.0, inertia=np.diag([0.004] * 3))
        pairs.append(CollisionPair(Box("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                                   Box(f"cube{k}", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8))
    opts = EngineOptions(contact_model="constraint", dt=1e-3, pgs_iters=8,
                         constraint_solver=solver)
    return Engine(b.build(device="cpu"), opts, motors=Motors.create([0], device="cpu"),
                  collision_pairs=tuple(pairs), device="cpu")


def _model(name):
    """(spec, sensor spec or None) of each model K2 runs."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair, Sphere
    from jiminy_tpu_torch.engine.randomization import ModelRandomization
    from jiminy_tpu_torch.hardware.motors import Motors
    from jiminy_tpu_torch.models.toys import make_cartpole

    opts = EngineOptions(contact_model="constraint", constraint_solver="substep")
    if name == "cartpole":
        eng = Engine(make_cartpole(device="cpu"), opts,
                     motors=Motors.create([0], effort_limit=30.0, device="cpu"), device="cpu")
        return eng.substep_spec, None
    if name == "slab":
        return _slab_engine().substep_spec, None
    if name.startswith("cassie"):
        from jiminy_tpu_torch.envs import CassieEnv

        path = name.partition("_")[2]
        if path in ("ptbox", "ptseg"):
            env = CassieEnv(observe="state", device="cpu")
            eng = env.engine
            eng = Engine(env.tree, eng.options, motors=env.motors,
                         constraints=eng.constraints, collision_pairs=_cassie_pairs(path),
                         device="cpu")
            return eng.substep_spec, None
        observe = "sensors" if path.endswith("sensors") else "state"
        env = CassieEnv(observe=observe, self_collision=path == "selfcol",
                        flexibility=path.startswith("flex"), device="cpu")
        sens = (SensorKernelSpec(env.tree, env.sensors, env.n_substeps_per_obs)
                if observe == "sensors" else None)
        return env.engine.substep_spec, sens
    if name.startswith("atlas"):
        from jiminy_tpu_torch.envs import AtlasEnv

        observe = "sensors" if name.endswith("sensors") else "state"
        env = AtlasEnv(observe=observe, self_collision="selfcol" in name, device="cpu")
        sens = (SensorKernelSpec(env.tree, env.sensors, env.n_substeps_per_obs)
                if observe == "sensors" else None)
        return env.engine.substep_spec, sens
    if name == "forest":
        b = TreeBuilder(gravity=(0.0, 0.0, 0.0))
        for body in ("ball_a", "ball_b"):
            b.add_frame(body, b.add_body(body, -1, JointType.FREE, mass=1.0,
                                         inertia=(4e-3, 4e-3, 4e-3)))
        pairs = (CollisionPair(Sphere("ball_a", (0, 0, 0), 0.1), Sphere("ball_b", (0, 0, 0), 0.1)),
                 CollisionPair(Box("ball_a", (0.01, 0, 0), (0.09, 0.07, 0.06)),
                               Capsule("ball_b", (0, 0, -0.06), (0, 0, 0.06), 0.03)))
        eng = Engine(b.build(device="cpu"), opts, collision_pairs=pairs,
                     motors=Motors.create([0], device="cpu"), device="cpu")
        return eng.substep_spec, None
    walker, _, path = name.partition("_")
    kw = {"observe": "sensors" if path in ("sensors", "terrain", "sim2real") else "state"}
    if path in ("terrain", "sim2real"):
        kw.update(terrain="fourier", push_magnitude=100.0, push_duration=0.2)
    if path == "sim2real":
        kw["model_randomization"] = ModelRandomization(
            mass_scale=(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2),
            motor_gain=(0.9, 1.1))
    env = _walker_env(walker, **kw)
    if path == "spheres":  # ANYmal's feet as 2 cm spheres
        from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays

        t = env.tree
        d = {k: getattr(t, k) for k in STATIC_FIELDS + ARRAY_FIELDS}
        d = {k: x.numpy() if isinstance(x, torch.Tensor) else x for k, x in d.items()}
        d["contact_radius"] = torch.full((t.ncp,), 0.02).numpy()
        eng = Engine(tree_from_arrays(d, device="cpu"), opts, motors=env.motors, device="cpu")
        return eng.substep_spec, None
    spec = env.engine.substep_spec
    sens = (SensorKernelSpec(env.tree, env.sensors, env.n_substeps_per_obs)
            if kw["observe"] == "sensors" else None)
    return spec, sens


MODELS = ("anymal_state", "anymal_sensors", "anymal_terrain", "anymal_sim2real", "anymal_spheres",
          "ant_state", "ant_sensors", "spotmicro_state", "spotmicro_sensors", "cartpole", "forest",
          "cassie_state", "cassie_sensors", "cassie_selfcol", "cassie_ptbox", "cassie_ptseg",
          "cassie_flex", "cassie_flex_sensors", "slab", "atlas_state", "atlas_sensors",
          "atlas_selfcol", "atlas_selfcol_sensors")


def _expected_sizes(spec, sens, lds):
    t = spec.tree
    nb, nq, nv, nc, ncp = t.nb, t.nq, t.nv, spec.nc, t.ncp
    nm = spec.torque.nm if spec.torque is not None else 0
    sb = nb if sens is not None else 0
    return dict(
        q0=nq, q1=nq, v0=nv, v1=nv, tau=nv, lam=nc, cmd=nm, w0=6, fc=3 * ncp, g=spec.n_gc,
        M=nv * lds["ldm"], dL=nv, pf=nv, J=nc * lds["ldj"], target=nc, mu=nc, active=nc,
        basis=9 * ncp if spec.n_gc else 0, rhs=nc, diag=nc, vfree=nv,
        xlR=9 * nb, xlp=3 * nb, xwR=9 * nb, xwp=3 * nb, vel=6 * nb, acc=6 * nb, frc=6 * nb,
        Ic=13 * nb, cc=19 * nb, X=nv * lds["ldx"], A=nc * lds["lda"],
        s_xwR=9 * sb, s_vel=6 * sb, s_acc=6 * sb,
        rows=sum(g.ns * g.dim for g in sens.suite.groups) if sens is not None else 0,
    )


def _disjoint(regions, names):
    live = sorted((regions[n][0], regions[n][0] + regions[n][1], n) for n in names
                  if regions[n][1] > 0)
    for (_, end, a), (start, _, b) in zip(live, live[1:]):
        assert end <= start, f"{a} and {b} overlap"


@pytest.mark.parametrize("name", MODELS)
def test_warp_workspace_layout(name):
    spec, sens = _model(name)
    t = spec.tree
    assert t.nb <= 32 and t.nv <= 32 and spec.nc <= 96, "a model of the large frame's caps"
    ws = spec.warp_workspace(sens)
    assert ws is not None and spec.warp_workspace(sens) is ws  # built once
    regions, lds = ws.regions, ws.lds
    stride = ws.bytes_per_env // 4
    assert 4 * stride == ws.bytes_per_env and stride % 4 == 0
    # the row strides cover their rows and are odd
    assert lds["ldm"] >= t.nv and lds["ldj"] >= t.nv and lds["lda"] >= spec.nc
    assert lds["ldx"] >= spec.nc + 1 and all(ld % 2 == 1 for ld in lds.values())
    for region, size in _expected_sizes(spec, sens, lds).items():
        assert regions[region][1] == size, region
    for region, (off, size) in regions.items():
        assert off % 4 == 0, f"{region} at {off} floats is off 16 bytes"
        assert 0 <= off and off + size <= stride, region
    # outside the union: live throughout, apart from one another and from it
    u0, u_size = regions["union"]
    assert u0 + u_size == stride
    outside = [n for n in regions if n != "union" and not any(n in v for v in WARP_VIEWS.values())]
    _disjoint(regions, outside + ["union"])
    # each view of the union inside it, its regions apart
    for view in WARP_VIEWS.values():
        for region in view:
            off, size = regions[region]
            assert size == 0 or u0 <= off and off + size <= stride, region
        _disjoint(regions, view)
    assert 1 <= ws.W <= WARP_MAX_W and ws.W * ws.bytes_per_env <= SMEM_PER_BLOCK
    assert ws.W == min(WARP_MAX_W, SMEM_PER_BLOCK // ws.bytes_per_env)
    # the ints, as the C entry point reads them: the header, then the offsets
    n_rows = regions["rows"][1]
    assert ws.ints[:8] == (ws.W, stride, t.ncp, n_rows, lds["ldm"], lds["ldj"], lds["ldx"],
                           lds["lda"])
    order = outside + ["union"] + [n for v in WARP_VIEWS.values() for n in v]
    assert ws.ints[8:] == tuple(regions[n][0] for n in order) and len(ws.ints) == 8 + 37


@pytest.mark.parametrize("observe", ["state", "sensors"])
def test_anymal_workspace_bytes(observe):
    """ANYmal's slice, the figure PERF.md and the source note give, on
    either path (the union's chain view is the largest), four envs per
    block."""
    spec, sens = _model(f"anymal_{observe}")
    ws = spec.warp_workspace(sens)
    assert (ws.bytes_per_env, ws.W) == (ANYMAL_BYTES, 4)


@pytest.mark.parametrize("name", sorted(LARGE_FRAME_BYTES))
def test_large_frame_workspace_bytes(name):
    """Each large-frame model's slice, the figures PERF.md and the source
    note give (the union's chain view, X and A, the largest), four envs
    per block: the warp body takes the large frame, as every K2 launch."""
    spec, sens = _model(name)
    t = spec.tree
    assert t.nb > 13 or t.nv > 18 or spec.nc > 24, "past the ANYmal frame"
    ws = spec.warp_workspace(sens)
    assert (ws.bytes_per_env, ws.W) == (LARGE_FRAME_BYTES[name], 4)
    a_off, a_size = ws.regions["A"]
    assert 4 * (a_off + -(-a_size // 4) * 4) == ws.bytes_per_env  # the chain view ends the slice


def test_past_the_caps_is_refused():
    """A model past the kernels' caps (the slab with two cubes: 32 pair
    contacts, past the 24 the kernels take) gets no layout: ``warp_workspace`` raises, as the
    entry points do, rather than route it anywhere."""
    spec = _slab_engine(n_cubes=2, solver="inline").substep_spec
    assert spec.nc == 96
    with pytest.raises(ValueError, match="caps"):
        spec.warp_workspace()
