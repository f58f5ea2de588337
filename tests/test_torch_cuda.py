"""The port's CUDA kernels on the card, against their plain versions:
K1 (``solve_batched``), K3 (``substep_batched``) and K2
(``substep_batched_multi``), with and without its sensor stage, on flat
ground and on per-env analytic grounds (the ``GEN`` instantiations), with
and without per-env model parameters (the ``RAND`` instantiations),
on the Cassie biped (the large frame, the pushrods' distance rows
and the shin springs; held to float64 by the distribution of the per-env
distance, as ``chip_smoke.py`` ``_gate_dist_vs_f64``, since float32 is not
well posed there at 1e-4), with collision pairs (the three narrow phases
on Cassie's tree, likewise; on a forest of two free balls within 1e-4)
with sphere contact sites (ANYmal's feet, env by env against
float64), with PRISMATIC joints (the reference's sprung-slab kernel scene
along z and along an oblique axis, the cartpole at its limits; env by
env against float64, nominal and randomized) and on the Ant's and
Spotmicro's env paths (one fused launch per env step); and PPO (A.8):
the learner's update on the card against the CPU's, and one
``train_step`` on the main path's env that launches K2 once per rollout
env step; the capsule-foot ANYmal built from its URDF (K2 env by env
against float64) and the distributed train step at world size 1 over
NCCL (bit for bit the single-device step); the convenience layer (A.19):
the Simulator's K2 launches and its log's round trip, ``set_options``
rerouting a live sensor env, PCG32 and the parity mode on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX.) Tolerance
1e-4: float32 reassociation between the kernel and the plain version over
one substep; the acceleration a = (v⁺ − v)/dt carries v's tolerance ÷ dt
and τ is held relative to its size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jiminy_tpu_torch.engine.solver import BlockSpec
from jiminy_tpu_torch.models.quadruped import stand_q
from jiminy_tpu_torch.ops.constraint_solve import (
    SolveConfig,
    solve_batched,
    solve_reference,
)
from jiminy_tpu_torch.ops.substep_kernel import (
    substep_batched,
    substep_batched_multi,
    substep_multi_reference,
    substep_reference,
)

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-4
CONFIGS = {
    "anymal": SolveConfig(
        n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
        contact_colors=((12, 2), (18, 2)), iters=8, compute_residual=True,
    ),
    "atlas": SolveConfig(
        n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
        contact_colors=((23, 4), (35, 4)), iters=4, compute_residual=True,
    ),
    "cassie": SolveConfig(
        n=22, nc=26, dt=2e-3, eq_blocks=(BlockSpec("equality", 0, 4),),
        bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)), iters=4,
        relax=0.9, compute_residual=True,
    ),
    # Atlas with its self-collision pairs: nc 83, three items per lane
    "atlas_selfcol": SolveConfig(
        n=29, nc=83, dt=4e-3, eq_blocks=(), bounds_span=(0, 23),
        contact_colors=((23, 4), (35, 4), (47, 1), (50, 1), (53, 5), (68, 5)), iters=8,
        compute_residual=True,
    ),
    # the gantry ANYmal: a weld's 6 rows and a lock's 1 ahead of ANYmal's
    "gantry": SolveConfig(
        n=18, nc=31, dt=5e-3,
        eq_blocks=(BlockSpec("equality", 0, 6), BlockSpec("equality", 6, 1)),
        bounds_span=(7, 12), contact_colors=((19, 2), (25, 2)), iters=8, compute_residual=True,
    ),
    # a rolling wheel: its 3 rows alone, no bounds, no contact color
    "wheel": SolveConfig(
        n=6, nc=3, dt=1e-3, eq_blocks=(BlockSpec("equality", 0, 3),), bounds_span=None,
        contact_colors=(), iters=16, compute_residual=True,
    ),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel cannot run on the CPU")
    return torch.device("cuda")


def _rand_system(seed, B, n, nc, dev):
    """Well-conditioned random systems (as tests/test_pallas_solve.py)."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((B, n, n)) * 0.3
    M = R @ R.transpose(0, 2, 1) + 2.0 * np.eye(n)
    arrays = (
        M, rng.standard_normal((B, n)), 0.5 * rng.standard_normal((B, n)),
        0.5 * rng.standard_normal((B, nc, n)), 0.1 * rng.standard_normal((B, nc)),
        np.full((B, nc), 0.8), (rng.random((B, nc)) < 0.7).astype(np.float64),
        0.01 * rng.standard_normal((B, nc)),
    )
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("B", [16, 1000])
def test_kernel_matches_plain_version(cuda_device, name, B):
    cfg = CONFIGS[name]
    args = _rand_system(5, B, cfg.n, cfg.nc, cuda_device)
    before = solve_batched.launches
    out = solve_batched(cfg, *args, device=cuda_device)
    torch.cuda.synchronize()
    assert solve_batched.launches == before + 1
    for o, r in zip(out, solve_reference(cfg, *args)):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=0)


CHAIN_B = 4097  # the batch the K1 gates read; smaller batches are its first envs


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("B", [16, 1000, CHAIN_B])
def test_kernel_launches_are_bit_equal(cuda_device, name, B):
    """K1's warp body (one warp per env, the workspace in shared memory):
    two launches from the same inputs bit-equal, each env's bits those of
    the same env in a launch of CHAIN_B envs (a warp's env does not depend
    on the batch or its ragged edge), through the warp body (its counter),
    and within 1e-4 of the plain version."""
    cfg = CONFIGS[name]
    big = _rand_system(7, CHAIN_B, cfg.n, cfg.nc, cuda_device)
    args = [x[:B].contiguous() for x in big]
    before = solve_batched.warp_launches, solve_batched.launches
    out = solve_batched(cfg, *args, device=cuda_device)
    assert (solve_batched.warp_launches, solve_batched.launches) == (before[0] + 1, before[1] + 1)
    again = solve_batched(cfg, *args, device=cuda_device)
    whole = solve_batched(cfg, *big, device=cuda_device)
    torch.cuda.synchronize()
    for o, a, w in zip(out, again, whole):
        assert torch.equal(o, a) and torch.equal(o, w[:B])
    for o, r in zip(out, solve_reference(cfg, *args)):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    cfg = CONFIGS["anymal"]
    args = _rand_system(6, 8, cfg.n, cfg.nc, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        solve_batched(cfg, *[a.double() for a in args], device=cuda_device)
    bad = list(args)
    bad[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)  # J, strided
    with pytest.raises(ValueError, match="contiguous"):
        solve_batched(cfg, *bad, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        solve_batched(cfg, *[a[:, :-1] if a.dim() == 2 else a for a in args], device=cuda_device)


@pytest.mark.cuda
def test_env_step_goes_through_the_kernel(cuda_device):
    """constraint_solver="kernel": 4 K1 launches per env step; each
    substep equals the inline plain chain from the same inputs."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(observe="state", constraint_solver="kernel", device=cuda_device)
    inline = ANYmalEnv(observe="state", constraint_solver="inline", device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = env.reset(gen, 256)
    before = solve_batched.launches
    state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert solve_batched.launches == before + 4
    u = env._action_to_command(torch.zeros(256, 12, device=cuda_device), state.sim)
    nk = env.engine.step(state.sim, u, n_substeps=1)
    ni = inline.engine.step(state.sim, u, n_substeps=1)
    torch.testing.assert_close(nk.q, ni.q, atol=ATOL, rtol=0)
    torch.testing.assert_close(nk.v, ni.v, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_gantry_env_step_goes_through_the_kernel(cuda_device):
    """The gantry ANYmal (a weld and a lock) through ``"auto"``: the chain
    kernel, 4 K1 launches per env step and no whole-substep launch; each
    substep equals the inline plain chain from the same inputs; an
    explicit ``"substep"`` raises at construction."""
    from jiminy_tpu_torch.envs import ANYmalGantryEnv

    env = ANYmalGantryEnv(observe="state", device=cuda_device)
    inline = ANYmalGantryEnv(observe="state", constraint_solver="inline", device=cuda_device)
    assert env.engine.backend == "kernel" and env.engine.nc == 31
    with pytest.raises(ValueError, match="FrameConstraint, JointConstraint outside"):
        ANYmalGantryEnv(observe="state", constraint_solver="substep", device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    before = solve_batched.launches, substep_batched.launches, substep_batched_multi.launches
    state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert (solve_batched.launches, substep_batched.launches,
            substep_batched_multi.launches) == (before[0] + 4, before[1], before[2])
    u = env._action_to_command(torch.zeros(256, 12, device=cuda_device), state.sim)
    nk = env.engine.step(state.sim, u, n_substeps=1)
    ni = inline.engine.step(state.sim, u, n_substeps=1)
    for f in ("q", "v", "lam"):
        torch.testing.assert_close(getattr(nk, f), getattr(ni, f), atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_external_forces_and_friction_take_the_chain_kernel(cuda_device):
    """``fext_user`` and per-env friction keep ANYmal's ``"substep"``
    engine off K2 and K3: one K1 launch per substep, each substep equal to
    the inline plain chain's from the same inputs."""
    from jiminy_tpu_torch.engine.contact import ContactParams

    eng, inline = _anymal_engine(cuda_device), _anymal_engine(cuda_device, solver="inline")
    q, v, cmd, lam0, wrench = _substep_inputs(3, 512, eng)
    state = eng.reset(q, v)
    state.lam = lam0
    fext = torch.zeros(512, eng.tree.nb, 6, device=cuda_device)
    fext[:, 6, 3:] = 30.0
    kw = dict(base_wrench=wrench, fext_user=fext, contact_params=ContactParams(
        friction=torch.linspace(0.2, 1.2, 512, device=cuda_device)))
    before = solve_batched.launches, substep_batched.launches, substep_batched_multi.launches
    nk = eng.step(state, cmd, n_substeps=4, **kw)
    assert (solve_batched.launches, substep_batched.launches,
            substep_batched_multi.launches) == (before[0] + 4, before[1], before[2])
    nk = eng.step(state, cmd, **kw)
    ni = inline.step(state, cmd, **kw)
    for f in ("q", "v", "lam"):
        torch.testing.assert_close(getattr(nk, f), getattr(ni, f), atol=ATOL, rtol=0)


def _anymal_engine(dev, fusion=True, solver="substep"):
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.quadruped import make_anymal

    tree, motors, _ = make_anymal(device=dev)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         constraint_solver=solver,
                         substep_fusion=fusion)
    return Engine(tree, opts, motors=motors, controller=PDController(80.0, 2.0), device=dev)


def _substep_inputs(seed, B, engine, stand=None):
    """Perturbed stand poses (feet penetrating, hovering and clear; around
    ``stand``, else ANYmal's), PD targets, λ0 ≥ 0 and a root wrench, made
    with numpy."""
    rng = np.random.default_rng(seed)
    q = np.tile(stand_q(engine.tree) if stand is None else stand, (B, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.15, 0.15, (B, 12))
    q[:, 2] += rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([rng.uniform(-0.05, 0.05, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    arrays = (
        q, 0.3 * rng.standard_normal((B, 18)), q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12)),
        np.abs(0.05 * rng.standard_normal((B, engine.nc))),
        np.concatenate([5 * rng.standard_normal((B, 3)), 20 * rng.standard_normal((B, 3))], 1),
    )
    return [torch.as_tensor(a, dtype=torch.float32, device=engine.device) for a in arrays]


def _assert_outputs_close(out, ref, dt):
    names = ("q", "v", "lam", "residual", "impulse", "a", "tau")
    for name, o, r in zip(names, out, ref):
        if name == "a":
            atol = ATOL / dt
        elif name == "tau":
            atol = ATOL * max(1.0, r.abs().max().item())
        else:
            atol = ATOL
        torch.testing.assert_close(o, r, atol=atol, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi"])
def test_substep_kernels_match_plain_versions(cuda_device, kernel, B):
    """K3, and K2 over one substep, from the same inputs."""
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = _substep_inputs(7, B, eng)
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        before = substep_batched.launches
        out = substep_batched(spec, q, v, tau, lam0, wrench)
        launched = substep_batched.launches - before
        ref = substep_reference(spec, q, v, tau, lam0, wrench)
    else:
        before = substep_batched_multi.launches
        out = substep_batched_multi(spec, 1, q, v, cmd, lam0, wrench)
        launched = substep_batched_multi.launches - before
        ref = substep_multi_reference(spec, 1, q, v, cmd, lam0, wrench)
    torch.cuda.synchronize()
    assert launched == 1
    _assert_outputs_close(out, ref, spec.dt)


@pytest.mark.cuda
def test_substep_kernels_reject_bad_inputs(cuda_device):
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = _substep_inputs(8, 8, eng)
    with pytest.raises(TypeError, match="float32"):
        substep_batched_multi(spec, 4, q.double(), v, cmd, lam0, wrench)
    with pytest.raises(ValueError, match="contiguous"):
        substep_batched(spec, q, v, v.t().contiguous().t(), lam0, wrench)
    with pytest.raises(ValueError, match="shape"):
        substep_batched_multi(spec, 4, q, v, cmd[:, :-1], lam0, wrench)
    with pytest.raises(ValueError, match="tensors on"):
        substep_batched(spec, q, v, v, lam0, wrench.cpu())
    with pytest.raises(ValueError, match="n_sub"):
        substep_batched_multi(spec, 0, q, v, cmd, lam0, wrench)


@pytest.mark.cuda
def test_env_main_path_is_one_fused_launch(cuda_device):
    """The default env: one K2 launch per env step, no K1 or K3; with
    substep_fusion off, 4 K3 launches; each substep equals the inline
    plain engine from the same inputs."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(observe="state", device=cuda_device)
    inline = ANYmalEnv(observe="state", constraint_solver="inline", device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    counts = (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches)
    state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    after = (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches)
    assert (after[0] - counts[0], after[1] - counts[1], after[2] - counts[2]) == (0, 0, 1)
    unfused = _anymal_engine(cuda_device, fusion=False)
    u = env._action_to_command(torch.zeros(256, 12, device=cuda_device), state.sim)
    before = substep_batched.launches
    unfused.step(state.sim, u, n_substeps=4)
    assert substep_batched.launches == before + 4
    sim = state.sim
    for _ in range(4):
        nk = env.engine.step(sim, u, n_substeps=1)
        ni = inline.engine.step(sim, u, n_substeps=1)
        torch.testing.assert_close(nk.q, ni.q, atol=ATOL, rtol=0)
        torch.testing.assert_close(nk.v, ni.v, atol=ATOL, rtol=0)
        sim = nk


def _sensor_setup(eng, seed, B, k_obs=1, n_upd=1):
    """ANYmal's suite at the flagship's settings, its kernel spec, ring
    buffers of distinct slots and the corruption of ``n_upd`` updates."""
    from jiminy_tpu_torch.models.quadruped import make_anymal
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    _, _, suite = make_anymal(device=eng.device, sensor_period=5e-3 * k_obs,
                              sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    q, v, cmd, lam0, wrench = _substep_inputs(seed, B, eng)
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
    bufs = bufs + 0.1 * torch.randn(bufs.shape, generator=gen, device=eng.device)
    eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_upd)], 1)
    return SensorKernelSpec(eng.tree, suite, k_obs), (q, v, cmd, lam0, wrench), bufs, eps


def _assert_bufs_close(sens, out, ref):
    """Each reading (a group's dim) scaled by max(1, its largest value):
    |Δ| / scale ≤ ATOL (the accelerometer and the contact forces read
    Δv/dt and λ/dt, 10²–10³ in size)."""
    o, B = 0, out.shape[0]
    for g in sens.suite.groups:
        n = g.ns * g.buf_len * g.dim
        o_, r_ = (x[:, o:o + n].reshape(B, g.ns, g.buf_len, g.dim) for x in (out, ref))
        scale = r_.abs().amax(dim=(0, 1, 2)).clamp(min=1.0)
        torch.testing.assert_close(o_ / scale, r_ / scale, atol=ATOL, rtol=0, msg=g.type)
        o += n


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
def test_sensor_stage_matches_plain_version(cuda_device, B):
    """K2 with the sensor stage over one substep against its plain
    version from the same inputs, buffers and eps; its physics equals the
    sensor-free K2's bit for bit."""
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    sens, args, bufs, eps = _sensor_setup(eng, 9, B)
    before = substep_batched_multi.launches, substep_batched_multi.sensor_launches
    out = substep_batched_multi(spec, 1, *args, sensors=sens, bufs=bufs, eps=eps)
    assert (substep_batched_multi.launches, substep_batched_multi.sensor_launches) == (
        before[0], before[1] + 1)
    ref = substep_multi_reference(spec, 1, *args, sensors=sens, bufs=bufs, eps=eps)
    bare = substep_batched_multi(spec, 1, *args)
    torch.cuda.synchronize()
    _assert_outputs_close(out[:7], ref[:7], spec.dt)
    _assert_bufs_close(sens, out[7], ref[7])
    for o, b in zip(out[:7], bare):
        assert torch.equal(o, b)


@pytest.mark.cuda
def test_sensor_stage_k_obs2_pushes_every_other_substep(cuda_device):
    """k_obs = 2 over 2 substeps: one update, at the second substep's
    accepted state. The kernel returns that substep's q⁺, v⁺, a, τ and
    impulses, so the plain stage applied to them from the same buffers
    and eps must give the kernel's buffers."""
    from jiminy_tpu_torch.ops.substep_kernel import sensor_stage_reference

    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    sens, args, bufs, eps = _sensor_setup(eng, 10, 64, k_obs=2)
    out = substep_batched_multi(spec, 2, *args, sensors=sens, bufs=bufs, eps=eps)
    q, v, _, _, impulse, a, tau, kb = out
    ref = sensor_stage_reference(sens, q, v, a, impulse / spec.dt, tau, eps, bufs)
    torch.cuda.synchronize()
    _assert_bufs_close(sens, kb, ref)


@pytest.mark.cuda
def test_sensor_stage_rejects_bad_inputs(cuda_device):
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    sens, args, bufs, eps = _sensor_setup(eng, 11, 8)
    with pytest.raises(ValueError, match="expected"):
        substep_batched_multi(spec, 4, *args, sensors=sens, bufs=bufs, eps=eps)  # 1 update of 4
    with pytest.raises(ValueError, match="all three"):
        substep_batched_multi(spec, 1, *args, sensors=sens, bufs=bufs)
    with pytest.raises(TypeError, match="float32"):
        substep_batched_multi(spec, 1, *args, sensors=sens, bufs=bufs.double(), eps=eps)
    with pytest.raises(ValueError, match="tensors on"):
        substep_batched_multi(spec, 1, *args, sensors=sens, bufs=bufs, eps=eps.cpu())


@pytest.mark.cuda
def test_sensor_env_is_one_fused_launch(cuda_device):
    """The default env observes through sensors: one K2 launch per env
    step, no K1 or K3; the chunked fallback takes four."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, device=cuda_device)
    assert env._fused_sensors
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    def counts():
        return (solve_batched.launches, substep_batched.launches,
                substep_batched_multi.launches, substep_batched_multi.sensor_launches)

    before = counts()
    state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 1)
    assert state.obs.shape == (256, 33) and bool(torch.isfinite(state.obs).all())
    env._fused_sensors = False
    before = counts()
    env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 4, 0)


def _ground_setup(kind, seed, B, dev, sensors=False):
    """An engine on a ``kind`` ground, B per-env grounds of it (numpy-made
    coefficients: Fourier 16 terms of amplitude 0.08, Perlin [seed, 1/1.5,
    0.08], Stairs with random x0 so that some feet stand on risers), and
    substep inputs over ±2 m of it, the bases raised by the height under
    them."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.engine import ground as pg
    from jiminy_tpu_torch.models.quadruped import make_anymal

    rng = np.random.default_rng(seed)
    if kind == "fourier":
        K = 16
        octave = np.arange(K) % 3
        amp = 0.08 * 0.5**octave / np.sqrt(np.bincount(octave)[octave] * 1.3125)
        th, mag = rng.uniform(0, 2 * np.pi, (B, K)), rng.uniform(0.75, 1.25, (B, K))
        mag = mag * 2 * np.pi / 1.5 * 2.0**octave
        gc = np.concatenate([np.tile(amp, (B, 1)), mag * np.cos(th), mag * np.sin(th),
                             rng.uniform(0, 2 * np.pi, (B, K))], 1)
        make = pg.FourierGround
    elif kind == "perlin":
        gc = np.stack([rng.integers(0, 1 << 24, B), np.full(B, 1 / 1.5), np.full(B, 0.08)], 1)
        make = lambda c: pg.PerlinGround(c, 3)  # noqa: E731
    else:
        gc = np.stack([np.full(B, 0.4), np.full(B, 0.08), np.full(B, 10.0), np.full(B, 0.05),
                       rng.uniform(-0.4, 0.0, B)], 1)
        make = pg.StairsGround
    gc = torch.as_tensor(gc, dtype=torch.float32, device=dev)
    tree, motors, suite = make_anymal(device=dev, sensor_period=5e-3, sensor_delay=0.004,
                                      imu_noise=0.02, encoder_noise=0.005)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         constraint_solver="substep")
    eng = Engine(tree, opts, motors=motors, controller=PDController(80.0, 2.0),
                 ground=make(gc[0]), device=dev)
    q, v, cmd, lam0, wrench = _substep_inputs(seed, B, eng)
    if kind != "stairs":
        q[:, 0:2] = torch.as_tensor(rng.uniform(-2.0, 2.0, (B, 2)), dtype=torch.float32, device=dev)
    q[:, 2] += make(gc).query(q[:, :2])[0]
    return eng, suite, (q, v, cmd, lam0, wrench), gc


def _assert_env_by_env_vs_f64(name, k, p32, p64):
    """``chip_smoke.py`` `_gate_vs_f64`: on terrain one substep is not well
    posed at 1e-4 in every env (in a few envs of 1000 the plain float32
    version is itself 1e-4–1e-3 from float64), so the kernel's output k
    is held env by env against the float64 plain version p64 beside the
    float32 plain version p32: |k − p64| ≤ 2·|p32 − p64| + 1e-4 in all
    but 1 % of the envs, no more envs off by 1e-4 than 1.5 × the plain
    version's + 4, and the worst env within 2 × the plain version's worst
    + 1e-4."""
    def per_env(a, b):
        return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(dim=1)

    dk, dp = per_env(k, p64), per_env(p32, p64)
    B = k.shape[0]
    assert int((dk > 2.0 * dp + ATOL).sum()) <= 0.01 * B, name
    assert int((dk > ATOL).sum()) <= 1.5 * int((dp > ATOL).sum()) + 4, name
    assert dk.max().item() <= 2.0 * dp.max().item() + ATOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi", "substep_multi_sensors"])
@pytest.mark.parametrize("kind", ["fourier", "perlin", "stairs"])
def test_ground_kernels_match_plain_versions(cuda_device, kind, kernel, B):
    """K3, K2 and K2 with the sensor stage on per-env analytic grounds,
    one substep from the same inputs, each through its own instantiation
    (its own launch counter), held env by env against the float64 plain
    version; τ (from the inputs alone) within 1e-4 of its size."""
    from jiminy_tpu_torch.engine import Engine, PDController
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    eng, suite, args, gc = _ground_setup(kind, 12, B, cuda_device)
    eng64 = Engine(eng.tree.to(dtype=torch.float64), eng.options,
                   motors=eng.motors.to(dtype=torch.float64), controller=PDController(80.0, 2.0),
                   ground=eng.ground, device=cuda_device)
    spec, spec64 = eng.substep_spec, eng64.substep_spec
    q, v, cmd, lam0, wrench = args
    a64 = [x.double() for x in args]
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        before = substep_batched.ground_launches
        out = substep_batched(spec, q, v, tau, lam0, wrench, gc=gc)
        launched = substep_batched.ground_launches - before
        ref = substep_reference(spec, q, v, tau, lam0, wrench, gc=gc)
        ref64 = substep_reference(spec64, a64[0], a64[1], tau.double(), a64[3], a64[4],
                                  gc=gc.double())
    else:
        sw, sw64 = {}, {}
        if kernel == "substep_multi_sensors":
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
            sw = dict(sensors=SensorKernelSpec(eng.tree, suite, 1), bufs=bufs,
                      eps=suite.sample_eps(gen, B))
            sw64 = dict(sensors=SensorKernelSpec(eng64.tree, suite.to(dtype=torch.float64), 1),
                        bufs=bufs.double(), eps=sw["eps"].double())
        name = "sensor_ground_launches" if sw else "ground_launches"
        before = getattr(substep_batched_multi, name)
        out = substep_batched_multi(spec, 1, *args, gc=gc, **sw)
        launched = getattr(substep_batched_multi, name) - before
        ref = substep_multi_reference(spec, 1, *args, gc=gc, **sw)
        ref64 = substep_multi_reference(spec64, 1, *a64, gc=gc.double(), **sw64)
        if sw:
            scale = ref64[7].abs().amax(dim=0).clamp(min=1.0)
            _assert_env_by_env_vs_f64("bufs", out[7] / scale, ref[7] / scale, ref64[7] / scale)
        tau_atol = ATOL * max(1.0, ref[6].abs().max().item())
        torch.testing.assert_close(out[6], ref[6], atol=tau_atol, rtol=0)
    torch.cuda.synchronize()
    assert launched == 1
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_env_by_env_vs_f64(name, out[i], ref[i], ref64[i])


@pytest.mark.cuda
def test_ground_kernels_reject_bad_inputs(cuda_device):
    eng, _, args, gc = _ground_setup("fourier", 13, 8, cuda_device)
    spec = eng.substep_spec
    with pytest.raises(ValueError, match="needs its coefficients"):
        substep_batched_multi(spec, 4, *args)
    with pytest.raises(ValueError, match="needs its coefficients"):
        substep_batched_multi(spec, 4, *args, gc=gc[:, :-4])
    with pytest.raises(TypeError, match="float32"):
        substep_batched_multi(spec, 4, *args, gc=gc.double())
    with pytest.raises(ValueError, match="contiguous"):
        substep_batched_multi(spec, 4, *args, gc=gc.t().contiguous().t())
    flat = _anymal_engine(cuda_device).substep_spec
    with pytest.raises(ValueError, match="flat ground"):
        substep_batched_multi(flat, 4, *args, gc=gc)


@pytest.mark.cuda
def test_terrain_env_is_one_fused_launch(cuda_device):
    """The slice's env (per-env Fourier ground, pushes, sensors): one
    launch of K2 with the sensor stage and the ground query per env step,
    and no other kernel; the flat instantiations are not launched."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(terrain="fourier", push_magnitude=100.0, push_duration=0.2,
                    sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, device=cuda_device)
    assert env._fused_sensors
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)

    def counts():
        return (solve_batched.launches, substep_batched.launches, substep_batched.ground_launches,
                substep_batched_multi.launches, substep_batched_multi.sensor_launches,
                substep_batched_multi.ground_launches,
                substep_batched_multi.sensor_ground_launches)

    before = counts()
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 0, 0, 0, 3)
    assert bool(torch.isfinite(state.obs).all())


def _rand_params(eng, seed, B, nominal=False):
    """Each env's packed model parameters at the slice's ranges (mass and
    inertia 0.8–1.2, centre of mass ±0.02 m, motor gain 0.9–1.1) with the
    armature 0.7–1.3 and the friction 0.5–2.0, made with numpy; or the
    nominal ones."""
    from jiminy_tpu_torch.engine.randomization import ModelParams

    t, nm, dev = eng.tree, eng.motors.nm, eng.device
    if nominal:
        return eng._pack_model_params(ModelParams.nominal(t, eng.motors, B))
    rng = np.random.default_rng(seed)
    ranges = {"mass_scale": ((B, t.nb), 0.8, 1.2), "com_offset": ((B, t.nb, 3), -0.02, 0.02),
              "inertia_scale": ((B, t.nb), 0.8, 1.2), "armature_scale": ((B, t.nv), 0.7, 1.3),
              "motor_gain": ((B, nm), 0.9, 1.1), "motor_friction_scale": ((B, nm), 0.5, 2.0)}
    mp = ModelParams(*(torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)
                       for shape, lo, hi in ranges.values()))
    return eng._pack_model_params(mp)


def _rand_run(kernel, eng, suite, args, gc, mp, f64=False):
    """One substep of ``kernel`` with the model parameters ``mp``: the
    kernel (None for f64) and its plain version, in float32 or float64."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec, unpack_model_params

    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = args
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v, unpack_model_params(spec, mp)[1])
        if f64:
            return substep_reference(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
        return substep_batched(spec, q, v, tau, lam0, wrench, gc=gc, mp=mp)
    sw = {}
    if kernel == "substep_multi_sensors":
        gen = torch.Generator(device=q.device).manual_seed(3)
        s32 = suite.to(dtype=torch.float32)
        bufs = s32.flatten_buffers(s32.reset(s32.sample_eps(gen, q.shape[0]), q.float(), v.float()))
        sw = dict(sensors=SensorKernelSpec(eng.tree, suite, 1), bufs=bufs.to(q.dtype),
                  eps=s32.sample_eps(gen, q.shape[0]).to(q.dtype))
    if f64:
        return substep_multi_reference(spec, 1, *args, gc=gc, mp=mp, **sw)
    return substep_batched_multi(spec, 1, *args, gc=gc, mp=mp, **sw)


RAND_COUNTERS = {"substep": "rand_launches", "substep_multi": "rand_launches",
                 "substep_multi_sensors": "rand_sensor_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("ground", ["flat", "fourier"])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi", "substep_multi_sensors"])
def test_randomized_kernels_match_plain_versions(cuda_device, kernel, ground, B):
    """K3, K2 and K2 with the sensor stage with per-env model parameters,
    one substep from the same inputs, each through its own randomized
    instantiation: on flat ground within 1e-4 of the plain version (as
    the nominal kernels); on the Fourier ground env by env against the
    float64 plain version (as the nominal ground kernels)."""
    from jiminy_tpu_torch.engine import Engine, PDController
    from jiminy_tpu_torch.models.quadruped import make_anymal

    if ground == "flat":
        eng = _anymal_engine(cuda_device)
        suite = make_anymal(device=cuda_device, sensor_period=5e-3, sensor_delay=0.004,
                            imu_noise=0.02, encoder_noise=0.005)[2]
        args, gc = _substep_inputs(14, B, eng), None
    else:
        eng, suite, args, gc = _ground_setup("fourier", 14, B, cuda_device)
    mp = _rand_params(eng, 15, B)
    fn = substep_batched if kernel == "substep" else substep_batched_multi
    name = RAND_COUNTERS[kernel].replace("launches", "ground_launches" if gc is not None else "launches")
    before = getattr(fn, name)
    out = _rand_run(kernel, eng, suite, args, gc, mp)
    launched = getattr(fn, name) - before
    ref = _rand_run(kernel, eng, suite, args, gc, mp, f64=True)
    torch.cuda.synchronize()
    assert launched == 1
    if gc is None:
        _assert_outputs_close(out[:7], ref[:7], eng.substep_spec.dt)
        return
    eng64 = Engine(eng.tree.to(dtype=torch.float64), eng.options,
                   motors=eng.motors.to(dtype=torch.float64), controller=PDController(80.0, 2.0),
                   ground=eng.ground, device=cuda_device)
    a64 = [x.double() for x in args]
    ref64 = _rand_run(kernel, eng64, suite.to(dtype=torch.float64), a64, gc.double(), mp.double(),
                      f64=True)
    for i, n in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_env_by_env_vs_f64(n, out[i], ref[i], ref64[i])


@pytest.mark.cuda
def test_nominal_parameters_through_the_randomized_kernel(cuda_device):
    """The nominal parameters through the randomized K2 give the
    unrandomized K2's step to 1e-5 (the inertia is rebuilt as I_c + shift,
    so not bit for bit); other parameters move it."""
    eng = _anymal_engine(cuda_device)
    args = _substep_inputs(16, 1000, eng)
    bare = substep_batched_multi(eng.substep_spec, 4, *args)
    nom = substep_batched_multi(eng.substep_spec, 4, *args, mp=_rand_params(eng, 0, 1000, True))
    rand = substep_batched_multi(eng.substep_spec, 4, *args, mp=_rand_params(eng, 17, 1000))
    for name, a, b in zip(("q", "v", "lam"), nom, bare):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)
    assert (rand[1] - bare[1]).abs().max().item() > 1e-3


@pytest.mark.cuda
def test_randomized_kernels_reject_bad_inputs(cuda_device):
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    args = _substep_inputs(18, 8, eng)
    mp = _rand_params(eng, 19, 8)
    with pytest.raises(ValueError, match="model parameters"):
        substep_batched_multi(spec, 4, *args, mp=mp[:, :-1].contiguous())
    with pytest.raises(ValueError, match="model parameters"):
        substep_batched_multi(spec, 4, *args, mp=mp[:4])
    with pytest.raises(TypeError, match="float32"):
        substep_batched_multi(spec, 4, *args, mp=mp.double())
    with pytest.raises(ValueError, match="contiguous"):
        substep_batched_multi(spec, 4, *args, mp=mp.t().contiguous().t())
    with pytest.raises(ValueError, match="tensors on"):
        substep_batched_multi(spec, 4, *args, mp=mp.cpu())


@pytest.mark.cuda
def test_sim2real_env_is_one_fused_launch(cuda_device):
    """The slice's env (model randomization, per-env Fourier ground,
    pushes, sensors): one launch of the randomized K2 with the sensor
    stage and the ground query per env step, and no other kernel."""
    from jiminy_tpu_torch.engine.randomization import ModelRandomization
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(terrain="fourier", push_magnitude=100.0, push_duration=0.2,
                    sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005,
                    model_randomization=ModelRandomization(
                        mass_scale=(0.8, 1.2), com_offset=0.02, inertia_scale=(0.8, 1.2),
                        motor_gain=(0.9, 1.1)),
                    device=cuda_device)
    assert env._fused_sensors
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches")] + [
        (fn, pre + n) for fn in (substep_batched, substep_batched_multi) for pre in ("", "rand_")
        for n in ("launches", "ground_launches", "sensor_launches", "sensor_ground_launches")
        if fn is substep_batched_multi or "sensor" not in n]

    def counts():
        return [getattr(fn, n) for fn, n in names]

    before = counts()
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 12, device=cuda_device))
    launched = {f"{fn.__name__}.{n}": a - b for (fn, n), a, b in zip(names, counts(), before) if a != b}
    assert launched == {"substep_batched_multi.rand_sensor_ground_launches": 3}
    assert bool(torch.isfinite(state.obs).all())
    assert state.info["model_params"].shape == (256, 172)


# ---- Cassie (pushrod closed loops, shin springs; the large frame)

def _cassie_engine(dev, dtype=torch.float32, fusion=True, pairs=(), flexibility=False):
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.biped import make_cassie

    tree, motors, suite, rods, stand = make_cassie(sensor_period=2e-3, sensor_delay=0.004,
                                                   imu_noise=0.02, encoder_noise=0.005,
                                                   flexibility=flexibility, device=dev)
    opts = EngineOptions(contact_model="constraint", dt=2e-3, pgs_iters=8,
                         constraint_solver="substep", substep_fusion=fusion)
    eng = Engine(tree.to(dtype=dtype), opts, motors=motors.to(dtype=dtype),
                 controller=PDController(150.0, 6.0), constraints=rods, collision_pairs=pairs,
                 device=dev)
    return eng, suite.to(dtype=dtype), stand


def _cassie_inputs(seed, B, engine, stand):
    """Stand poses with the motor joints and springs ±0.05 rad (the loops
    open by millimetres), the base 1 cm low to 0.5 cm high, PD targets,
    λ0 ≥ 0 and a root wrench, made with numpy; on the flexible-hip model
    each hip quaternion turned U(0, 0.5) rad about a random axis, a
    quarter of them negated (w < 0) and an eighth the identity."""
    rng = np.random.default_rng(seed)
    t = engine.tree
    q = np.tile(stand, (B, 1)).astype(np.float64)
    qi = list(engine.motors.q_idx)
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, 10))
    q[:, [t.q_off[t.joint_index(n)] for n in ("L_shin_spring", "R_shin_spring")]] += \
        rng.uniform(-0.05, 0.05, (B, 2))
    for qo in t.sprung_spherical[1]:
        axis = rng.standard_normal((B, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        half = 0.5 * rng.uniform(0.0, 0.5, B)[:, None]
        quat = np.concatenate([axis * np.sin(half), np.cos(half)], 1)
        quat[rng.uniform(size=B) < 0.25] *= -1.0
        quat[: max(1, B // 8)] = [0.0, 0.0, 0.0, 1.0]
        q[:, qo:qo + 4] = quat
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    arrays = (
        q, 0.3 * rng.standard_normal((B, t.nv)), q[:, qi] + rng.uniform(-0.1, 0.1, (B, 10)),
        np.abs(0.05 * rng.standard_normal((B, engine.nc))),
        np.concatenate([5 * rng.standard_normal((B, 3)), 20 * rng.standard_normal((B, 3))], 1),
    )
    return [torch.as_tensor(a, dtype=torch.float32, device=engine.device) for a in arrays]


def _assert_distribution_vs_f64(name, k, p32, p64):
    """``chip_smoke.py`` `_gate_dist_vs_f64`: on Cassie no float32 version
    of one substep is within 1e-4 of float64 (its mass matrix's condition
    is of order 1e4; the plain float32 version is 1e-4–3e-3 off in most envs),
    so the kernel's per-env distance to the float64 plain version is held
    by its distribution beside the float32 plain version's: the 50th,
    90th and 99th percentiles within 1.5 × + 1e-5, the worst env within
    2 × + 1e-4, the envs off by 1e-4 within 1.5 × + 4."""
    def per_env(a, b):
        return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(dim=1)

    dk, dp = per_env(k, p64), per_env(p32, p64)
    qs = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=dk.device)
    assert bool((torch.quantile(dk, qs) <= 1.5 * torch.quantile(dp, qs) + 1e-5).all()), name
    assert dk.max().item() <= 2.0 * dp.max().item() + ATOL, name
    assert int((dk > ATOL).sum()) <= 1.5 * int((dp > ATOL).sum()) + 4, name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi", "substep_multi_sensors"])
def test_cassie_kernels_match_plain_versions(cuda_device, kernel, B):
    """K3, K2 and K2 with the sensor stage on the Cassie spec (two distance
    rows, the springs, the large frame) over one substep: the torque
    within 1e-4 of its size, q, v, λ and the impulses held to the float64
    plain version by their distribution."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    eng, suite, stand = _cassie_engine(cuda_device)
    eng64, suite64, _ = _cassie_engine(cuda_device, torch.float64)
    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = args = _cassie_inputs(30, B, eng, stand)
    a64 = [x.double() for x in args]
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        out = substep_batched(spec, q, v, tau, lam0, wrench)
        p32 = substep_reference(spec, q, v, tau, lam0, wrench)
        p64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3], a64[4])
    else:
        sw, sw64 = {}, {}
        if kernel == "substep_multi_sensors":
            gen = torch.Generator(device=cuda_device).manual_seed(31)
            bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
            eps = suite.sample_eps(gen, B)
            sw = dict(sensors=SensorKernelSpec(eng.tree, suite, 1), bufs=bufs, eps=eps)
            sw64 = dict(sensors=SensorKernelSpec(eng64.tree, suite64, 1), bufs=bufs.double(),
                        eps=eps.double())
        out = substep_batched_multi(spec, 1, *args, **sw)
        p32 = substep_multi_reference(spec, 1, *args, **sw)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *a64, **sw64)
        tau_scale = max(1.0, p32[6].abs().max().item())
        torch.testing.assert_close(out[6], p32[6], atol=ATOL * tau_scale, rtol=0)
        if sw:
            bare = substep_batched_multi(spec, 1, *args)
            assert all(torch.equal(out[i], bare[i]) for i in range(7))
    torch.cuda.synchronize()
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_distribution_vs_f64(f"{kernel} {name}", out[i], p32[i], p64[i])
    assert (p32[2][:, :2] != 0).any()  # the pushrods carry load


@pytest.mark.cuda
def test_cassie_k2_carries_lambda_across_substeps(cuda_device):
    """K2 over ten substeps equals ten chained K2 launches of one substep,
    bit for bit: λ, the distance rows' slots included, is carried in the
    kernel as it is through memory."""
    eng, _, stand = _cassie_engine(cuda_device)
    spec = eng.substep_spec
    q, v, cmd, lam, wrench = args = _cassie_inputs(32, 256, eng, stand)
    whole = substep_batched_multi(spec, 10, *args)
    for _ in range(10):
        out = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = out[:3]
    for i in range(7):
        assert torch.equal(whole[i], out[i]), i


@pytest.mark.cuda
def test_world_anchored_loop_k3_matches_plain_version(cuda_device):
    """The two-pendulum loop tied to a frame of the world (one distance
    row, no contact, no bounds): K3 within 1e-4 of its plain version."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.constraints import DistanceConstraint

    place = TreeBuilder.make_placement
    b = TreeBuilder()
    b.add_body("l1", -1, JointType.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1))
    b.add_body("l2", -1, JointType.REVOLUTE, placement=place((0.5, 0, 0)), axis=(0, 1, 0),
               mass=1.0, com=(0, 0, -1))
    f1 = b.add_frame("tip1", 0, place((0, 0, -1)))
    f2 = b.add_frame("anchor", -1, place((0.5, 0, -1)))
    eng = Engine(b.build(device=cuda_device), EngineOptions(contact_model="constraint", dt=1e-3,
                                                            constraint_solver="substep"),
                 constraints=(DistanceConstraint(f1, f2, 0.6, 20.0),), device=cuda_device)
    rng = np.random.default_rng(33)
    B = 1000
    q, v, tau, lam = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (
        rng.uniform(0.4, 0.8, (B, 2)), rng.standard_normal((B, 2)),
        5 * rng.standard_normal((B, 2)), 0.1 * rng.standard_normal((B, 1))))
    w = torch.zeros(B, 6, device=cuda_device)
    before = substep_batched.launches
    out = substep_batched(eng.substep_spec, q, v, tau, lam, w)
    ref = substep_reference(eng.substep_spec, q, v, tau, lam, w)
    torch.cuda.synchronize()
    assert substep_batched.launches == before + 1
    for name, o, r in zip(("q", "v", "lam", "residual"), out, ref):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=0, msg=name)
    assert out[4].shape == (B, 0, 3) and float(ref[2].abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["state", "sensors", "push"])
def test_cassie_env_is_one_fused_launch(cuda_device, path):
    """CassieEnv(sim_dt=2e-3, target_speed=0.4) on the state, sensor and
    push paths: one K2 launch per env step (with the sensor stage on the
    sensor path), and no other kernel."""
    from jiminy_tpu_torch.envs import CassieEnv

    kw = {"state": dict(observe="state"),
          "sensors": dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                          encoder_noise=0.005),
          "push": dict(observe="state", push_magnitude=50.0, push_duration=0.2)}[path]
    env = CassieEnv(sim_dt=2e-3, target_speed=0.4, device=cuda_device, **kw)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches"), (substep_batched, "launches"),
             (substep_batched_multi, "launches"), (substep_batched_multi, "sensor_launches")]
    before = [getattr(fn, n) for fn, n in names]
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 10, device=cuda_device))
    launched = [getattr(fn, n) - b for (fn, n), b in zip(names, before)]
    assert launched == ([0, 0, 0, 3] if path == "sensors" else [0, 0, 3, 0])
    assert bool(torch.isfinite(state.obs).all()) and state.obs.shape == (256, 29)


# ---- collision pairs (B.7) and sphere sites

def _pair_set(kind):
    """Pair sets on Cassie's tree (as chip_smoke.py `_pair_sets`): the
    legs' three capsule pairs (seg); a box on the pelvis against the L
    thigh (ptbox, 5 contacts); a 6-point cloud on the R tarsus against the
    L tarsus (ptseg)."""
    from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair, ConvexMesh
    from jiminy_tpu_torch.models.biped import cassie_self_collision_pairs

    leg = lambda b: Capsule(b, (0.0, 0.0, 0.0), (0.0, 0.0, -0.35), 0.04)  # noqa: E731
    if kind == "seg":
        return cassie_self_collision_pairs()
    if kind == "ptbox":
        return (CollisionPair(Box("pelvis", (0.0, 0.0, -0.15), (0.06, 0.08, 0.08)),
                              leg("L_thigh")),)
    cloud = ((0.06, 0, -0.17), (-0.06, 0, -0.17), (0, 0.08, -0.17), (0, -0.08, -0.17),
             (0, 0, -0.05), (0, 0, -0.29))
    return (CollisionPair(ConvexMesh("R_tarsus", cloud), leg("L_tarsus"), friction=0.6),)


def _selfcol_inputs(seed, B, engine, stand):
    """`_cassie_inputs` with the hip rolls inward (L −U(0, 0.4), R U(0,
    0.4) rad) and the hip yaws U(−0.3, 0.3) rad: the legs together."""
    q, v, cmd, lam0, wrench = _cassie_inputs(seed, B, engine, stand)
    rng = np.random.default_rng(seed + 1)
    t = engine.tree
    j = [t.q_off[t.joint_index(n)] for n in ("L_hip_roll", "R_hip_roll", "L_hip_yaw", "R_hip_yaw")]
    q[:, j[0]] = torch.as_tensor(-rng.uniform(0.0, 0.4, B), dtype=q.dtype, device=q.device)
    q[:, j[1]] = torch.as_tensor(rng.uniform(0.0, 0.4, B), dtype=q.dtype, device=q.device)
    q[:, j[2:]] = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 2)), dtype=q.dtype, device=q.device)
    return q, v, cmd, lam0, wrench


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi"])
@pytest.mark.parametrize("kind", ["seg", "ptbox", "ptseg"])
def test_pair_kernels_match_plain_versions(cuda_device, kind, kernel, B):
    """K3 and K2 with each narrow phase on Cassie's tree over one substep:
    q, v, λ (the pair rows included) and the impulses held to the float64
    plain version by their distribution; some pair rows active."""
    eng, _, stand = _cassie_engine(cuda_device, pairs=_pair_set(kind))
    eng64, _, _ = _cassie_engine(cuda_device, torch.float64, pairs=_pair_set(kind))
    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = args = _selfcol_inputs(40, B, eng, stand)
    a64 = [x.double() for x in args]
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        out = substep_batched(spec, q, v, tau, lam0, wrench)
        p32 = substep_reference(spec, q, v, tau, lam0, wrench)
        p64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3], a64[4])
    else:
        out = substep_batched_multi(spec, 1, *args)
        p32 = substep_multi_reference(spec, 1, *args)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *a64)
    torch.cuda.synchronize()
    assert (p64[2][:, spec.pair_off:] != 0).any()  # a pair row pushes
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_distribution_vs_f64(f"{kind} {kernel} {name}", out[i], p32[i], p64[i])


@pytest.mark.cuda
def test_pair_k2_carries_lambda_across_substeps(cuda_device):
    """With the self-collision pairs, K2 over ten substeps equals ten
    chained K2 launches of one substep, bit for bit."""
    eng, _, stand = _cassie_engine(cuda_device, pairs=_pair_set("seg"))
    spec = eng.substep_spec
    q, v, cmd, lam, wrench = args = _selfcol_inputs(41, 256, eng, stand)
    whole = substep_batched_multi(spec, 10, *args)
    for _ in range(10):
        out = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = out[:3]
    for i in range(7):
        assert torch.equal(whole[i], out[i]), i


def _forest_engine(dev, dtype, motor=False):
    """Two free balls in one tree (two FREE roots, no ground contact, no
    bounds; the small frame): a sphere pair and a box against a capsule
    (ptbox, 5 contacts, one color); with ``motor`` a frictionless direct
    motor on the first ball's x (K2 needs a torque path)."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.collision import Box, Capsule, CollisionPair, Sphere
    from jiminy_tpu_torch.hardware.motors import Motors

    b = TreeBuilder(gravity=(0.0, 0.0, 0.0))
    for name in ("ball_a", "ball_b"):
        b.add_frame(name, b.add_body(name, -1, JointType.FREE, mass=1.0,
                                     inertia=(4e-3, 4e-3, 4e-3)))
    pairs = (CollisionPair(Sphere("ball_a", (0, 0, 0), 0.1), Sphere("ball_b", (0, 0, 0), 0.1)),
             CollisionPair(Box("ball_a", (0.01, 0, 0), (0.09, 0.07, 0.06)),
                           Capsule("ball_b", (0, 0, -0.06), (0, 0, 0.06), 0.03),
                           friction=0.7))
    return Engine(b.build(device=dev, dtype=dtype),
                  EngineOptions(contact_model="constraint", dt=1e-3,
                                constraint_solver="substep"), collision_pairs=pairs,
                  motors=Motors.create([0], device=dev, dtype=dtype) if motor else None,
                  device=dev)


def _forest_inputs(seed, B, dev):
    """Random orientations, the second ball 0.12–0.3 m from the first in a
    random direction (the pairs touching in about half the envs), v, τ
    and λ0 ≥ 0, made with numpy."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 14))
    for o in (3, 10):
        quat = rng.standard_normal((B, 4))
        q[:, o:o + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    d = rng.standard_normal((B, 3))
    q[:, 7:10] = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.12, 0.3, (B, 1))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        q, 0.3 * rng.standard_normal((B, 12)), rng.standard_normal((B, 12)),
        np.abs(0.05 * rng.standard_normal((B, 18))))]


@pytest.mark.cuda
def test_forest_pairs_k3_matches_plain_version(cuda_device):
    """K3 on the forest of two free balls (`_forest_engine`), env by env
    against the float64 plain version (the float32 plain version's worst
    env is itself about as far from it in v on these inputs as K3's
    worst, so 1e-4 against float32 is not well posed)."""
    eng, eng64 = _forest_engine(cuda_device, torch.float32), _forest_engine(cuda_device,
                                                                            torch.float64)
    assert eng.nc == 3 * 6 and eng.backend == "substep"
    B = 1000
    q, v, tau, lam = _forest_inputs(42, B, cuda_device)
    w = torch.zeros(B, 6, device=cuda_device)
    before = substep_batched.launches
    out = substep_batched(eng.substep_spec, q, v, tau, lam, w)
    ref = substep_reference(eng.substep_spec, q, v, tau, lam, w)
    ref64 = substep_reference(eng64.substep_spec, *(x.double() for x in (q, v, tau, lam, w)))
    torch.cuda.synchronize()
    assert substep_batched.launches == before + 1
    for i, name in enumerate(("q", "v", "lam", "residual")):
        _assert_env_by_env_vs_f64(f"forest {name}", out[i], ref[i], ref64[i])
    assert out[4].shape == (B, 0, 3) and float((ref[2] != 0).any(1).double().mean()) > 0.25


def _mismatched_pairs(spec, case):
    """``spec`` with its packed generators' contact counts off its pair
    colors: one of Cassie's three seg generators dropped (the generators
    write 2 contacts, the colors hold 3), or a ptbox generator with 4 of
    its 5 points."""
    import copy

    pairs = spec.pairs = copy.copy(spec.pairs)
    if case == "seg_dropped":
        pairs.gens = pairs.gens[:2]
    else:
        kind, g = pairs.gens[0]
        pairs.gens = [(kind, {**g, "pts": g["pts"][:4]})]
    spec._packed.clear()
    return spec


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seg_dropped", "ptbox_short"])
def test_pair_layout_is_checked(cuda_device, case):
    """The entry points refuse, before any launch, a packed spec whose
    generators' contact counts do not match the pair colors."""
    eng, _, stand = _cassie_engine(cuda_device, pairs=_pair_set(case.split("_")[0]))
    args = _selfcol_inputs(43, 32, eng, stand)
    spec = _mismatched_pairs(eng.substep_spec, case)
    before = substep_batched_multi.launches
    with pytest.raises(ValueError, match="do not match the pair colors"):
        substep_batched_multi(spec, 1, *args)
    assert substep_batched_multi.launches == before


def _sphere_engine(dev, dtype=torch.float32, ground=None):
    """ANYmal with its four foot sites as spheres of radius 0.02."""
    from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.quadruped import make_anymal

    tree, motors, _ = make_anymal(device=dev)
    d = {k: getattr(tree, k) for k in STATIC_FIELDS + ARRAY_FIELDS}
    d = {k: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for k, x in d.items()}
    d["contact_radius"] = np.full(tree.ncp, 0.02, np.float32)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         constraint_solver="substep")
    return Engine(tree_from_arrays(d, device=dev, dtype=dtype), opts,
                  motors=motors.to(dtype=dtype), controller=PDController(80.0, 2.0),
                  ground=ground, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["substep", "substep_multi"])
@pytest.mark.parametrize("ground", ["flat", "fourier"])
def test_sphere_site_kernels_match_plain_versions(cuda_device, ground, kernel):
    """K3 and K2 with sphere sites (the offset before the Jacobians; on
    the Fourier ground the two-pass query) over one substep, env by env
    against the float64 plain version."""
    gc = None
    if ground == "fourier":
        eng0, _, _, gc = _ground_setup("fourier", 44, 1000, cuda_device)
        tmpl = eng0.ground
    else:
        tmpl = None
    eng, eng64 = _sphere_engine(cuda_device, ground=tmpl), _sphere_engine(
        cuda_device, torch.float64, ground=tmpl.to(dtype=torch.float64) if tmpl else None)
    spec = eng.substep_spec
    q, v, cmd, lam0, wrench = args = _substep_inputs(44, 1000, eng)
    if gc is not None:
        xy = np.random.default_rng(45).uniform(-2.0, 2.0, (1000, 2))
        q[:, 0:2] = torch.as_tensor(xy, dtype=torch.float32, device=cuda_device)
        q[:, 2] += type(tmpl).from_coef(gc, tmpl).query(q[:, :2])[0]
    a64 = [x.double() for x in args]
    g64 = gc.double() if gc is not None else None
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        out = substep_batched(spec, q, v, tau, lam0, wrench, gc=gc)
        p32 = substep_reference(spec, q, v, tau, lam0, wrench, gc=gc)
        p64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3], a64[4],
                                gc=g64)
    else:
        out = substep_batched_multi(spec, 1, *args, gc=gc)
        p32 = substep_multi_reference(spec, 1, *args, gc=gc)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *a64, gc=g64)
    torch.cuda.synchronize()
    assert spec.spheres and float((p64[4][..., 2] != 0).any(1).double().mean()) > 0.5
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_env_by_env_vs_f64(f"{ground} {kernel} {name}", out[i], p32[i], p64[i])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["state", "sensors", "push"])
def test_selfcol_env_is_one_fused_launch(cuda_device, path):
    """CassieEnv(sim_dt=2e-3, target_speed=0.4, self_collision=True) on the
    state, sensor and push paths: one K2 launch per env step, no other."""
    from jiminy_tpu_torch.envs import CassieEnv

    kw = {"state": dict(observe="state"),
          "sensors": dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                          encoder_noise=0.005),
          "push": dict(observe="state", push_magnitude=50.0, push_duration=0.2)}[path]
    env = CassieEnv(sim_dt=2e-3, target_speed=0.4, self_collision=True, device=cuda_device, **kw)
    assert env.engine.nc == 37 and env.engine.backend == "substep"
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches"), (substep_batched, "launches"),
             (substep_batched_multi, "launches"), (substep_batched_multi, "sensor_launches")]
    before = [getattr(fn, n) for fn, n in names]
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 10, device=cuda_device))
    launched = [getattr(fn, n) - b for (fn, n), b in zip(names, before)]
    assert launched == ([0, 0, 0, 3] if path == "sensors" else [0, 0, 3, 0])
    assert bool(torch.isfinite(state.obs).all()) and state.obs.shape == (256, 29)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["state", "sensors", "selfcol", "selfcol_sensors"])
def test_atlas_env_is_one_fused_launch(cuda_device, path):
    """AtlasEnv(target_speed=0.3) (examples/train.py --env atlas) on the state
    and sensor paths, without and with its self-collision pairs (nc 47,
    83): ``constraint_solver="auto"`` resolves to the whole-substep kernel
    on the card, one K2 launch per env step, no other, all through the warp
    body."""
    from jiminy_tpu_torch.envs import AtlasEnv

    sensors = path.endswith("sensors")
    kw = (dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)
          if sensors else dict(observe="state"))
    env = AtlasEnv(target_speed=0.3, self_collision=path.startswith("selfcol"),
                   device=cuda_device, **kw)
    assert env.engine.backend == "substep" and env._fused_sensors == sensors
    assert env.engine.nc == (83 if path.startswith("selfcol") else 47)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches"), (substep_batched, "launches"),
             (substep_batched_multi, "launches"), (substep_batched_multi, "sensor_launches"),
             (substep_batched_multi, "warp_launches")]
    before = [getattr(fn, n) for fn, n in names]
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 23, device=cuda_device))
    launched = [getattr(fn, n) - b for (fn, n), b in zip(names, before)]
    assert launched == ([0, 0, 0, 3, 3] if sensors else [0, 0, 3, 0, 3])
    assert bool(torch.isfinite(state.obs).all()) and state.obs.shape == (256, 55)


# ---- spherical flexibility (B.8): the flexible-hip Cassie

@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 1000])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi", "substep_multi_sensors"])
def test_flex_kernels_match_plain_versions(cuda_device, kernel, B):
    """K3, K2 and K2 with the sensor stage (the pelvis and both hip IMUs)
    on the flexible-hip Cassie spec over one substep, from states with the
    hips deflected (every branch of the spring's log): the torque within
    1e-4 of its size, q, v, λ and the impulses held to the float64 plain
    version by their distribution, the sensor variant's physics K2's."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    eng, suite, stand = _cassie_engine(cuda_device, flexibility=True)
    eng64, suite64, _ = _cassie_engine(cuda_device, torch.float64, flexibility=True)
    spec = eng.substep_spec
    assert spec.tree.nv == 26 and spec.nc == 28
    q, v, cmd, lam0, wrench = args = _cassie_inputs(60, B, eng, stand)
    a64 = [x.double() for x in args]
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v)
        out = substep_batched(spec, q, v, tau, lam0, wrench)
        p32 = substep_reference(spec, q, v, tau, lam0, wrench)
        p64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3], a64[4])
    else:
        sw, sw64 = {}, {}
        if kernel == "substep_multi_sensors":
            gen = torch.Generator(device=cuda_device).manual_seed(61)
            bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
            eps = suite.sample_eps(gen, B)
            sw = dict(sensors=SensorKernelSpec(eng.tree, suite, 1), bufs=bufs, eps=eps)
            sw64 = dict(sensors=SensorKernelSpec(eng64.tree, suite64, 1), bufs=bufs.double(),
                        eps=eps.double())
        out = substep_batched_multi(spec, 1, *args, **sw)
        p32 = substep_multi_reference(spec, 1, *args, **sw)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *a64, **sw64)
        tau_scale = max(1.0, p32[6].abs().max().item())
        torch.testing.assert_close(out[6], p32[6], atol=ATOL * tau_scale, rtol=0)
        if sw:
            bare = substep_batched_multi(spec, 1, *args)
            assert all(torch.equal(out[i], bare[i]) for i in range(7))
    torch.cuda.synchronize()
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_distribution_vs_f64(f"{kernel} {name}", out[i], p32[i], p64[i])


@pytest.mark.cuda
def test_flex_k2_carries_lambda_across_substeps(cuda_device):
    """On the flexible-hip spec, K2 over ten substeps equals ten chained
    K2 launches of one substep, bit for bit."""
    eng, _, stand = _cassie_engine(cuda_device, flexibility=True)
    spec = eng.substep_spec
    q, v, cmd, lam, wrench = args = _cassie_inputs(62, 256, eng, stand)
    whole = substep_batched_multi(spec, 10, *args)
    for _ in range(10):
        out = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = out[:3]
    for i in range(7):
        assert torch.equal(whole[i], out[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["state", "sensors", "push"])
def test_flex_env_is_one_fused_launch(cuda_device, path):
    """CassieEnv(sim_dt=2e-3, target_speed=0.4, flexibility=True) on the
    state, sensor and push paths: one K2 launch per env step (with the
    sensor stage on the sensor path), and no other kernel."""
    from jiminy_tpu_torch.envs import CassieEnv

    kw = {"state": dict(observe="state"),
          "sensors": dict(observe="sensors", sensor_delay=0.004, imu_noise=0.02,
                          encoder_noise=0.005),
          "push": dict(observe="state", push_magnitude=50.0, push_duration=0.2)}[path]
    env = CassieEnv(sim_dt=2e-3, target_speed=0.4, flexibility=True, device=cuda_device, **kw)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches"), (substep_batched, "launches"),
             (substep_batched_multi, "launches"), (substep_batched_multi, "sensor_launches")]
    before = [getattr(fn, n) for fn, n in names]
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 10, device=cuda_device))
    launched = [getattr(fn, n) - b for (fn, n), b in zip(names, before)]
    assert launched == ([0, 0, 0, 3] if path == "sensors" else [0, 0, 3, 0])
    assert bool(torch.isfinite(state.obs).all()) and state.obs.shape == (256, 29)


def _prismatic_engine(dev, scene, dtype=torch.float32):
    """The B.10 scenes: tests/test_box_pairs.py's sprung PRISMATIC slab and
    free cube with their ptbox pair (friction 0.8, nc 48, the large frame),
    the slider along z or along the oblique (0.6, 0, 0.8), a frictionless
    direct motor on it; or ``make_cartpole()`` with a direct motor on the
    cart (effort 30) and its ±2.4 m bound row (nc 1)."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.collision import Box, CollisionPair
    from jiminy_tpu_torch.hardware.motors import Motors
    from jiminy_tpu_torch.models.toys import make_cartpole

    if scene == "cartpole":
        motors = Motors.create([0], effort_limit=30.0, device=dev, dtype=dtype)
        return Engine(make_cartpole(device=dev, dtype=dtype),
                      EngineOptions(contact_model="constraint", constraint_solver="substep"),
                      motors=motors, device=dev)
    b = TreeBuilder()
    b.add_body("slab", -1, JointType.PRISMATIC, axis=(0.6, 0.0, 0.8) if scene == "oblique"
               else (0, 0, 1), mass=100.0, com=(0, 0, 0.05), inertia=np.diag([10.0] * 3),
               stiffness=1e7, damping=1e4)
    b.add_body("cube", -1, JointType.FREE, mass=1.0, inertia=np.diag([0.004] * 3))
    pair = CollisionPair(Box("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                         Box("cube", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8)
    opts = EngineOptions(contact_model="constraint", dt=1e-3, pgs_iters=8,
                         constraint_solver="substep")
    return Engine(b.build(device=dev, dtype=dtype), opts,
                  motors=Motors.create([0], device=dev, dtype=dtype), collision_pairs=(pair,),
                  device=dev)


def _prismatic_inputs(seed, B, engine, scene):
    """Made with numpy: the slab scenes around tests/test_box_pairs.py's
    landing (the cube 3 mm into to 7 mm above the slab's face, lateral
    speed (−0.3, 0.2) scaled 0.5–1.5, the slab sagging 0–2e-4 m), or carts
    over ±2.6 m with a third at a limit moving outward; a motor command,
    λ0 ≥ 0 and a root wrench."""
    rng = np.random.default_rng(seed)
    if scene == "cartpole":
        q = np.stack([rng.uniform(-2.6, 2.6, B), rng.uniform(-0.5, 0.5, B)], 1)
        v = rng.standard_normal((B, 2))
        n = B // 3
        side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        q[:n, 0] = side * (2.4 + rng.uniform(-0.002, 0.002, n))
        v[:n, 0] = side * rng.uniform(0.5, 2.5, n)
        cmd, wrench = rng.uniform(-40, 40, (B, 1)), np.zeros((B, 6))
    else:
        q = np.zeros((B, 8))
        q[:, 0] = rng.uniform(-2e-4, 0.0, B)
        q[:, 1:3] = rng.uniform(-0.1, 0.1, (B, 2))
        q[:, 3] = rng.uniform(0.197, 0.207, B)
        quat = np.concatenate([rng.uniform(-0.03, 0.03, (B, 3)), np.ones((B, 1))], 1)
        q[:, 4:8] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        s = rng.uniform(0.5, 1.5, B)
        v = np.zeros((B, 7))
        v[:, 0], v[:, 1], v[:, 2] = 0.01 * rng.standard_normal(B), -0.3 * s, 0.2 * s
        v[:, 3], v[:, 4:7] = rng.uniform(-0.3, 0.0, B), 0.5 * rng.standard_normal((B, 3))
        cmd = rng.uniform(-50, 50, (B, 1))
        wrench = np.concatenate([5 * rng.standard_normal((B, 3)),
                                 20 * rng.standard_normal((B, 3))], 1)
    arrays = (q, v, cmd, np.abs(0.05 * rng.standard_normal((B, engine.nc))), wrench)
    return [torch.as_tensor(a, dtype=torch.float32, device=engine.device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("kernel", ["substep", "substep_multi"])
@pytest.mark.parametrize("scene", ["slab", "oblique", "cartpole"])
def test_prismatic_kernels_match_plain_versions(cuda_device, scene, kernel, randomized):
    """K3 and K2 (n_sub = 1), nominal and with each env's model
    parameters, on the PRISMATIC scenes (B.10: the slider's subspace [0;
    axis], its transform (I, axis·q), its spring and bound row) over one
    substep, env by env against the float64 plain version; the rows that
    the scene exercises engaged in a quarter of the envs at least."""
    from jiminy_tpu_torch.ops.substep_kernel import unpack_model_params

    B = 1000
    eng, eng64 = (_prismatic_engine(cuda_device, scene),
                  _prismatic_engine(cuda_device, scene, torch.float64))
    spec = eng.substep_spec
    assert spec.tree.joint_type[0] == 2 and spec.nc == (1 if scene == "cartpole" else 48)
    q, v, cmd, lam0, wrench = args = _prismatic_inputs(70, B, eng, scene)
    a64 = [x.double() for x in args]
    mp = _rand_params(eng, 71, B) if randomized else None
    mp64 = mp.double() if randomized else None
    if kernel == "substep":
        tau = eng._joint_torque(cmd, q, v, unpack_model_params(spec, mp)[1] if randomized else None)
        out = substep_batched(spec, q, v, tau, lam0, wrench, mp=mp)
        p32 = substep_reference(spec, q, v, tau, lam0, wrench, mp=mp)
        p64 = substep_reference(eng64.substep_spec, a64[0], a64[1], tau.double(), a64[3], a64[4],
                                mp=mp64)
    else:
        out = substep_batched_multi(spec, 1, *args, mp=mp)
        p32 = substep_multi_reference(spec, 1, *args, mp=mp)
        p64 = substep_multi_reference(eng64.substep_spec, 1, *a64, mp=mp64)
    torch.cuda.synchronize()
    engaged = (p64[2] != 0).any(1).double().mean().item()
    assert engaged >= 0.25, engaged
    for i, name in ((0, "q"), (1, "v"), (2, "lam")):
        _assert_env_by_env_vs_f64(f"{scene} {kernel} {name}", out[i], p32[i], p64[i])


@pytest.mark.cuda
def test_prismatic_slab_step_is_one_fused_launch(cuda_device):
    """The slab scene through Engine.step (6 substeps of 1 ms, the
    reference test's step): one K2 launch per step, the cube resting on
    the slab."""
    eng = _prismatic_engine(cuda_device, "slab")
    q, v, _, _, _ = _prismatic_inputs(72, 256, eng, "slab")
    sim = eng.reset(q, v)
    before = (substep_batched.launches, substep_batched_multi.launches)
    for _ in range(5):
        sim = eng.step(sim, torch.zeros(256, 1, device=cuda_device), n_substeps=6)
    after = (substep_batched.launches, substep_batched_multi.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 5)
    assert bool(torch.isfinite(sim.q).all()) and sim.q[:, 3].min().item() > 0.19


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["state", "sensors"])
@pytest.mark.parametrize("walker", ["ant", "spotmicro"])
def test_walker_env_is_one_fused_launch(cuda_device, walker, path):
    """AntEnv and SpotmicroEnv (20 substeps per env step; Ant's sensor
    update every second substep) on the state and sensor paths: one K2
    launch per env step (with the sensor stage on the sensor path), and
    no other kernel."""
    from jiminy_tpu_torch.envs import AntEnv, SpotmicroEnv

    env = {"ant": AntEnv, "spotmicro": SpotmicroEnv}[walker](observe=path, device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    names = [(solve_batched, "launches"), (substep_batched, "launches"),
             (substep_batched_multi, "launches"), (substep_batched_multi, "sensor_launches")]
    before = [getattr(fn, n) for fn, n in names]
    for _ in range(3):
        state = env.step(state, torch.zeros(256, env.motors.nm, device=cuda_device))
    launched = [getattr(fn, n) - b for (fn, n), b in zip(names, before)]
    assert launched == ([0, 0, 0, 3] if path == "sensors" else [0, 0, 3, 0])
    nobs = {"ant": 25, "spotmicro": 33}[walker]
    assert bool(torch.isfinite(state.obs).all()) and state.obs.shape == (256, nobs)


# ---- K2's warp body (csrc/substep_warp.cuh): every model of the ANYmal
# frame, each held as its own card test holds it


def _world_loop_engine(dev, dtype):
    """The two-pendulum loop tied to a frame of the world (one distance
    row, an equality block of the PGS), with direct motors on both joints."""
    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.constraints import DistanceConstraint
    from jiminy_tpu_torch.hardware.motors import Motors

    place = TreeBuilder.make_placement
    b = TreeBuilder()
    b.add_body("l1", -1, JointType.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1))
    b.add_body("l2", -1, JointType.REVOLUTE, placement=place((0.5, 0, 0)), axis=(0, 1, 0),
               mass=1.0, com=(0, 0, -1))
    f1 = b.add_frame("tip1", 0, place((0, 0, -1)))
    f2 = b.add_frame("anchor", -1, place((0.5, 0, -1)))
    return Engine(b.build(device=dev, dtype=dtype),
                  EngineOptions(contact_model="constraint", dt=1e-3, constraint_solver="substep"),
                  constraints=(DistanceConstraint(f1, f2, 0.6, 20.0),),
                  motors=Motors.create([0, 1], effort_limit=20.0, device=dev, dtype=dtype),
                  device=dev)


def _walker_case(name, seed, B, dev, dtype=torch.float32):
    """The Ant's or the Spotmicro's engine and suite, and substep inputs
    from reset states (made on the card from a seed): a uniform action's
    command, λ0 ≥ 0 and a root wrench."""
    from jiminy_tpu_torch.envs import AntEnv, SpotmicroEnv

    env = {"ant": AntEnv, "spotmicro": SpotmicroEnv}[name](observe="sensors", device=dev,
                                                          dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(gen, B)
    act = torch.rand(B, env.motors.nm, generator=gen, device=dev) * 2.0 - 1.0
    cmd = env._action_to_command(act, state.sim)
    lam0 = 0.05 * torch.rand(B, env.engine.nc, generator=gen, device=dev)
    wrench = torch.randn(B, 6, generator=gen, device=dev) * torch.tensor(
        [5.0, 5.0, 5.0, 20.0, 20.0, 20.0], device=dev)
    args = [x.to(dtype).contiguous() for x in (state.sim.q, state.sim.v, cmd, lam0, wrench)]
    return env.engine, env.sensors, args


WARP_MODELS = ("anymal", "anymal_fourier", "anymal_randomized", "ant", "spotmicro", "cartpole",
               "forest", "sphere_feet", "world_loop")


def _warp_case(model, B, dev):
    """(spec, its float64 twin, float32 inputs, their float64 copies, the
    kernel's extra arguments in float32 and float64, the suite or None,
    whether 1e-4 against the float32 plain version is well posed there)."""
    from jiminy_tpu_torch.engine import Engine, PDController
    from jiminy_tpu_torch.models.quadruped import make_anymal

    f64 = torch.float64
    kw = kw64 = {}
    if model in ("anymal", "anymal_randomized"):
        eng = _anymal_engine(dev)
        suite = make_anymal(device=dev, sensor_period=5e-3, sensor_delay=0.004, imu_noise=0.02,
                            encoder_noise=0.005)[2]
        args = _substep_inputs(60, B, eng)
        eng64 = Engine(eng.tree.to(dtype=f64), eng.options, motors=eng.motors.to(dtype=f64),
                       controller=PDController(80.0, 2.0), device=dev)
        if model == "anymal_randomized":
            mp = _rand_params(eng, 61, B)
            kw, kw64 = dict(mp=mp), dict(mp=mp.double())
    elif model == "anymal_fourier":
        eng, suite, args, gc = _ground_setup("fourier", 62, B, dev)
        eng64 = Engine(eng.tree.to(dtype=f64), eng.options, motors=eng.motors.to(dtype=f64),
                       controller=PDController(80.0, 2.0), ground=eng.ground, device=dev)
        kw, kw64 = dict(gc=gc), dict(gc=gc.double())
    elif model in ("ant", "spotmicro"):
        eng, suite, args = _walker_case(model, 63, B, dev)
        eng64 = _walker_case(model, 63, 1, dev, f64)[0]
    elif model == "cartpole":
        eng, eng64 = _prismatic_engine(dev, model), _prismatic_engine(dev, model, f64)
        suite, args = None, _prismatic_inputs(64, B, eng, model)
    elif model == "forest":
        eng, eng64 = _forest_engine(dev, torch.float32, True), _forest_engine(dev, f64, True)
        q, v, tau, lam = _forest_inputs(42, B, dev)  # the K3 forest test's inputs
        suite, args = None, [q, v, tau[:, :1].contiguous(), lam, torch.zeros(B, 6, device=dev)]
    elif model == "sphere_feet":
        eng, eng64 = _sphere_engine(dev), _sphere_engine(dev, f64)
        suite, args = None, _substep_inputs(66, B, eng)
    else:
        eng, eng64 = _world_loop_engine(dev, torch.float32), _world_loop_engine(dev, f64)
        rng = np.random.default_rng(67)
        suite, args = None, [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.uniform(0.4, 0.8, (B, 2)), rng.standard_normal((B, 2)),
            20 * rng.standard_normal((B, 2)), 0.1 * rng.standard_normal((B, 1)),
            np.zeros((B, 6)))]
    # the forest: float32 is as ill posed as on Cassie in a few envs (one
    # env of 4097 from seed 65 sits 0.023 from float64 in v for K2 and K3
    # alike, bit-equal, the plain version 0.005)
    well_posed = model in ("anymal", "world_loop")
    return (eng.substep_spec, eng64.substep_spec, args, [x.double() for x in args], kw, kw64,
            suite, well_posed)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 1000, 4097])
@pytest.mark.parametrize("model", WARP_MODELS)
def test_warp_k2_matches_plain_versions(cuda_device, model, B):
    """K2's warp body over one substep on each model of the ANYmal frame,
    at batches that are not multiples of the envs per block: through the
    warp body (its counter) and the instantiation's own counter; two
    launches from the same inputs bit-equal; held within 1e-4 of the
    float32 plain version where that is well posed (ANYmal from the
    perturbed stand, the world-anchored loop), else env by env against the
    float64 plain version; with the sensor stage (where the model has a
    suite) its physics bit-equal to the sensor-free launch and its buffers
    held as the physics is."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    spec, spec64, args, a64, kw, kw64, suite, well_posed = _warp_case(model, B, cuda_device)
    assert spec.warp_workspace() is not None
    counter = ("rand_" if "mp" in kw else "") + ("ground_" if "gc" in kw else "") + "launches"
    before = substep_batched_multi.warp_launches, getattr(substep_batched_multi, counter)
    out = substep_batched_multi(spec, 1, *args, **kw)
    assert (substep_batched_multi.warp_launches, getattr(substep_batched_multi, counter)) == (
        before[0] + 1, before[1] + 1)
    again = substep_batched_multi(spec, 1, *args, **kw)
    p32 = substep_multi_reference(spec, 1, *args, **kw)
    torch.cuda.synchronize()
    for i in range(7):
        assert torch.equal(out[i], again[i]), i
    if well_posed:
        _assert_outputs_close(out, p32, spec.dt)
    else:
        p64 = substep_multi_reference(spec64, 1, *a64, **kw64)
        for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
            if out[i].numel():  # no impulses without ground contacts
                _assert_env_by_env_vs_f64(f"{model} {name}", out[i], p32[i], p64[i])
    if model == "forest":
        # K3 (the same τ) computes the same bits: what
        # the K3 forest test holds against float64
        from jiminy_tpu_torch.ops.substep_kernel import torque_reference

        q, v, cmd, lam, w = args
        k3 = substep_batched(spec, q, v, torque_reference(spec, q, v, cmd).contiguous(), lam, w)
        for i in range(4):
            assert torch.equal(out[i], k3[i]), i
    if suite is None:
        return
    gen = torch.Generator(device=cuda_device).manual_seed(68)
    q, v = args[:2]
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), q, v))
    sw = dict(sensors=SensorKernelSpec(spec.tree, suite, 1), bufs=bufs,
              eps=suite.sample_eps(gen, B))
    outs = substep_batched_multi(spec, 1, *args, **kw, **sw)
    ps32 = substep_multi_reference(spec, 1, *args, **kw, **sw)
    torch.cuda.synchronize()
    for i in range(7):
        assert torch.equal(outs[i], out[i]), i
    if well_posed:
        _assert_bufs_close(sw["sensors"], outs[7], ps32[7])
        return
    s64 = suite.to(dtype=torch.float64)
    ps64 = substep_multi_reference(
        spec64, 1, *a64, **kw64, sensors=SensorKernelSpec(spec64.tree, s64, 1),
        bufs=bufs.double(), eps=sw["eps"].double())
    scale = ps64[7].abs().amax(dim=0).clamp(min=1.0)
    _assert_env_by_env_vs_f64(f"{model} bufs", outs[7] / scale, ps32[7] / scale, ps64[7] / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("sensors", [False, True])
def test_warp_k2_steps_as_chained_launches(cuda_device, sensors):
    """The warp body over an env step's four substeps equals four chained
    launches of one substep, bit for bit (q, v, λ carried in shared memory
    as through device memory); with the sensor stage, its physics equals
    the sensor-free launch's."""
    eng = _anymal_engine(cuda_device)
    spec = eng.substep_spec
    sens, args, bufs, eps = _sensor_setup(eng, 69, 1000, n_upd=4)
    q, v, cmd, lam, wrench = args
    whole = substep_batched_multi(spec, 4, *args)
    for _ in range(4):
        out = substep_batched_multi(spec, 1, q, v, cmd, lam, wrench)
        q, v, lam = out[:3]
    for i in range(7):
        assert torch.equal(whole[i], out[i]), i
    if sensors:
        fused = substep_batched_multi(spec, 4, *args, sensors=sens, bufs=bufs, eps=eps)
        for i in range(7):
            assert torch.equal(fused[i], whole[i]), i


# the large frame on the warp body: Cassie (its state and sensor paths'
# spec), its three pair sets, its flexible hips, the PRISMATIC slab along z
# and along the oblique axis, Atlas without and with its pairs (nc 47, 83)
LARGE_WARP_MODELS = ("cassie", "cassie_selfcol", "cassie_ptbox", "cassie_ptseg", "cassie_flex",
                     "slab", "slab_oblique", "atlas", "atlas_selfcol")
LARGE_B = 4097  # the batch the gates read; smaller batches are its first envs


def _atlas_engine(dev, dtype=torch.float32, pairs=False, solver="substep"):
    """AtlasEnv's engine (PD kp 300, kd 15, 4 ms, 8 sweeps), with its
    self-collision pairs with ``pairs``, and atlas_sensors_run's suite."""
    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.humanoid import atlas_self_collision_pairs, make_atlas

    tree, motors, suite = make_atlas(device=dev, sensor_period=4e-3, sensor_delay=0.004,
                                     imu_noise=0.02, encoder_noise=0.005)
    eng = Engine(tree.to(dtype=dtype),
                 EngineOptions(contact_model="constraint", dt=4e-3, pgs_iters=8,
                               compute_solver_residual=True, constraint_solver=solver),
                 motors=motors.to(dtype=dtype), controller=PDController(300.0, 15.0),
                 collision_pairs=atlas_self_collision_pairs() if pairs else (), device=dev)
    return eng, suite.to(dtype=dtype)


def _atlas_inputs(seed, B, engine):
    """Stand poses with the motor joints ±0.05 rad, the knees of a quarter
    of the envs at their lower limit, in the second half the hip and
    shoulder rolls turned inward (the legs' and the arms' pair rows
    active), the base 1 cm low to 0.5 cm high and tilted, PD targets, λ0 ≥ 0
    and a root wrench, made with numpy."""
    from jiminy_tpu_torch.models.humanoid import atlas_stand_q

    rng = np.random.default_rng(seed)
    t, dev = engine.tree, engine.device
    qi = list(engine.motors.q_idx)
    q = np.tile(atlas_stand_q(t).astype(np.float64), (B, 1))
    q[:, qi] += rng.uniform(-0.05, 0.05, (B, len(qi)))

    def j(name):
        return t.q_off[t.joint_index(name)]

    q[:B // 4, [j("l_leg_kny"), j("r_leg_kny")]] = rng.uniform(-0.01, 0.01, (B // 4, 2))
    h = B // 2
    q[h:, j("l_leg_hpx")] = -rng.uniform(0.05, 0.3, B - h)
    q[h:, j("r_leg_hpx")] = rng.uniform(0.05, 0.3, B - h)
    q[h:, j("l_arm_shx")] = -rng.uniform(0.2, 0.5, B - h)
    q[h:, j("r_arm_shx")] = rng.uniform(0.2, 0.5, B - h)
    q[:, 2] += rng.uniform(-0.01, 0.005, B)
    quat = np.concatenate([rng.uniform(-0.03, 0.03, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    arrays = (q, 0.3 * rng.standard_normal((B, t.nv)),
              q[:, qi] + rng.uniform(-0.1, 0.1, (B, len(qi))),
              np.abs(0.05 * rng.standard_normal((B, engine.nc))),
              np.concatenate([5.0 * rng.standard_normal((B, 3)),
                              20.0 * rng.standard_normal((B, 3))], 1))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def _large_case(model, dev):
    """(spec, its float64 twin, float32 inputs at LARGE_B, the suite and
    its float64 twin or None, the gate): Cassie's models held by the
    distribution of the per-env distance to float64, the slab and Atlas
    (κ(M) of a few hundred, ANYmal's regime) env by env, Atlas with its
    pairs by the distribution (its arm-against-torso contacts make the
    solve ill posed in float32, PERF.md §6)."""
    if model.startswith("atlas"):
        pairs = model == "atlas_selfcol"
        (eng, suite), (eng64, suite64) = (_atlas_engine(dev, dt, pairs)
                                          for dt in (torch.float32, torch.float64))
        return (eng.substep_spec, eng64.substep_spec, _atlas_inputs(76, LARGE_B, eng), suite,
                suite64, _assert_distribution_vs_f64 if pairs else _assert_env_by_env_vs_f64)
    if model.startswith("slab"):
        scene = "oblique" if model == "slab_oblique" else "slab"
        eng, eng64 = _prismatic_engine(dev, scene), _prismatic_engine(dev, scene, torch.float64)
        return (eng.substep_spec, eng64.substep_spec, _prismatic_inputs(73, LARGE_B, eng, scene),
                None, None, _assert_env_by_env_vs_f64)
    kind = model.partition("_")[2]
    pairs = _pair_set(kind if kind != "selfcol" else "seg") if kind not in ("", "flex") else ()
    flex = kind == "flex"
    eng, suite, stand = _cassie_engine(dev, pairs=pairs, flexibility=flex)
    eng64, suite64, _ = _cassie_engine(dev, torch.float64, pairs=pairs, flexibility=flex)
    make = _selfcol_inputs if pairs else _cassie_inputs
    args = make(74, LARGE_B, eng, stand)
    with_sensors = kind in ("", "flex")  # the state and sensor paths' models
    return (eng.substep_spec, eng64.substep_spec, args, suite if with_sensors else None,
            suite64 if with_sensors else None, _assert_distribution_vs_f64)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, LARGE_B])
@pytest.mark.parametrize("model", LARGE_WARP_MODELS)
def test_warp_k2_large_frame_matches_plain_versions(cuda_device, model, B):
    """K2's warp body over one substep on each large-frame model (nc 28 to
    83: the strided stages, X's nc + 1 right-hand sides and A's nc columns
    past one, and at Atlas's nc 83 two, per lane, the pair contacts one per
    row item): through the
    warp body (its counter); two launches from the same inputs bit-equal;
    each env's bits those of the same env in a launch of LARGE_B envs (a
    warp's env does not depend on the batch or its ragged edge); q, v, λ
    and the impulses held to the float64 plain version by the model's gate
    at B ≥ 31 (Cassie by the distribution of the per-env distance, the
    slab and Atlas env by env; one env is no distribution); on Cassie, its
    flexible twin and Atlas with and without its pairs the sensor stage's
    physics bit-equal to the sensor-free launch and its buffers held as the
    physics is; on the slab (no equality rows) K3 given K2's applied τ
    bit-equal."""
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    spec, spec64, big, suite, suite64, gate = _large_case(model, cuda_device)
    ws = spec.warp_workspace()
    assert ws.W == 4 and (spec.tree.nb > 13 or spec.tree.nv > 18 or spec.nc > 24)
    args = [x[:B].contiguous() for x in big]
    a64 = [x.double() for x in args]
    before = substep_batched_multi.warp_launches, substep_batched_multi.launches
    out = substep_batched_multi(spec, 1, *args)
    assert (substep_batched_multi.warp_launches, substep_batched_multi.launches) == (
        before[0] + 1, before[1] + 1)
    again = substep_batched_multi(spec, 1, *args)
    whole = substep_batched_multi(spec, 1, *big)
    torch.cuda.synchronize()
    for i in range(7):
        assert torch.equal(out[i], again[i]), i
        assert torch.equal(out[i], whole[i][:B]), i
    if B >= 31:
        p32 = substep_multi_reference(spec, 1, *args)
        p64 = substep_multi_reference(spec64, 1, *a64)
        assert (p64[2] != 0).any()
        for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
            if out[i].numel():  # no impulses without ground contacts
                gate(f"{model} {name}", out[i], p32[i], p64[i])
        if spec.n_pc:
            assert (p64[2][:, spec.pair_off:] != 0).any()  # a pair row pushes
    if model.startswith("slab"):
        q, v, _, lam, w = args
        k3 = substep_batched(spec, q, v, out[6], lam, w)
        for i in range(4):
            assert torch.equal(out[i], k3[i]), i
    if suite is None:
        return
    gen = torch.Generator(device=cuda_device).manual_seed(75)
    q, v = big[:2]
    bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, LARGE_B), q, v))[:B]
    sw = dict(sensors=SensorKernelSpec(spec.tree, suite, 1), bufs=bufs.contiguous(),
              eps=suite.sample_eps(gen, LARGE_B)[:B].contiguous())
    outs = substep_batched_multi(spec, 1, *args, **sw)
    torch.cuda.synchronize()
    for i in range(7):
        assert torch.equal(outs[i], out[i]), i
    if B < 31:
        return
    ps32 = substep_multi_reference(spec, 1, *args, **sw)
    ps64 = substep_multi_reference(
        spec64, 1, *a64, sensors=SensorKernelSpec(spec64.tree, suite64, 1),
        bufs=sw["bufs"].double(), eps=sw["eps"].double())
    scale = ps64[7].abs().amax(dim=0).clamp(min=1.0)
    gate(f"{model} bufs", outs[7] / scale, ps32[7] / scale, ps64[7] / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, LARGE_B])
@pytest.mark.parametrize("model", WARP_MODELS + LARGE_WARP_MODELS)
def test_k3_equals_k2_given_its_tau(cuda_device, model, B):
    """K3 and K2 run one substep body: K3 given K2's applied τ at n_sub = 1
    is bit-equal to K2 on q, v, λ, the residual and the impulses, on every
    model of both frames (ANYmal flat, on a Fourier ground and randomized;
    the Ant, the Spotmicro, the cartpole, the two-ball forest, sphere feet,
    the world-anchored loop; Cassie, its three pair sets and its flexible
    hips; the slab along z and oblique), through the warp body (its
    counter), and each env's bits those of the same env in a launch of
    LARGE_B envs."""
    if model in LARGE_WARP_MODELS:
        spec, _, big, _, _, _ = _large_case(model, cuda_device)
        kw = {}
    else:
        spec, _, big, _, kw, _, _, _ = _warp_case(model, LARGE_B, cuda_device)
    args = [x[:B].contiguous() for x in big]
    kb = {k: x[:B].contiguous() for k, x in kw.items()}
    q, v, _, lam, w = args
    k2 = substep_batched_multi(spec, 1, *args, **kb)
    before = substep_batched.warp_launches
    k3 = substep_batched(spec, q, v, k2[6], lam, w, **kb)
    assert substep_batched.warp_launches == before + 1
    tau = substep_batched_multi(spec, 1, *big, **kw)[6]
    whole = substep_batched(spec, big[0], big[1], tau, big[3], big[4], **kw)
    torch.cuda.synchronize()
    for i in range(5):
        assert torch.equal(k3[i], k2[i]), i
        assert torch.equal(k3[i], whole[i][:B]), i


@pytest.mark.cuda
def test_large_frame_takes_the_warp_body(cuda_device):
    """Cassie (nb 15, nv 20, nc 28), past the ANYmal frame, has a warp
    workspace, and every launch there runs the warp body, each counter
    rising by one per launch: K2 with and without the sensor stage, K3 in
    K2's workspace, and K1 on Cassie's chain (its ``"kernel"`` path's
    system) in its own."""
    from jiminy_tpu_torch.ops.constraint_solve import warp_workspace
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec, torque_reference

    eng, suite, stand = _cassie_engine(cuda_device)
    spec = eng.substep_spec
    assert (spec.tree.nb, spec.tree.nv, spec.nc) == (15, 20, 28)
    assert spec.warp_workspace().bytes_per_env == 11072
    q, v, cmd, lam, wrench = args = _cassie_inputs(70, 16, eng, stand)
    gen = torch.Generator(device=cuda_device).manual_seed(76)
    sw = dict(sensors=SensorKernelSpec(eng.tree, suite, 1),
              bufs=suite.flatten_buffers(suite.reset(suite.sample_eps(gen, 16), q, v)),
              eps=suite.sample_eps(gen, 16))
    before = (substep_batched_multi.warp_launches, substep_batched_multi.launches,
              substep_batched_multi.sensor_launches)
    substep_batched_multi(spec, 1, *args)
    substep_batched_multi(spec, 10, *args)
    substep_batched_multi(spec, 1, *args, **sw)
    torch.cuda.synchronize()
    assert (substep_batched_multi.warp_launches, substep_batched_multi.launches,
            substep_batched_multi.sensor_launches) == (before[0] + 3, before[1] + 2,
                                                       before[2] + 1)
    before = substep_batched.warp_launches, substep_batched.launches
    substep_batched(spec, q, v, torque_reference(spec, q, v, cmd).contiguous(), lam, wrench)
    assert (substep_batched.warp_launches, substep_batched.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    cfg = spec.cfg
    assert warp_workspace(cfg).bytes_per_env == 10592
    before = solve_batched.warp_launches, solve_batched.launches
    solve_batched(cfg, *_rand_system(78, 16, cfg.n, cfg.nc, cuda_device), device=cuda_device)
    torch.cuda.synchronize()
    assert (solve_batched.warp_launches, solve_batched.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["overlap", "too_large", "misaligned", "no_layout",
                                   "slab_overlap", "slab_short_lda", "k3_overlap",
                                   "k3_no_layout", "k3_slab_overlap", "k3_slab_short_lda",
                                   "k1_overlap", "k1_short_ldx", "k1_no_layout",
                                   "k1_wide_span"])
def test_warp_layout_is_checked(cuda_device, fault, monkeypatch):
    """A layout the warp body cannot take raises, nothing falls back:
    two live regions on one another, more shared memory than a block may
    take, an offset off 16 bytes, or no layout at all (ANYmal); on the slab
    scene (nc 48, past one row per lane) A onto X in the chain's view, or
    A's row stride short of nc. K3 (``k3_``) refuses K2's faults in K2's
    layout; K1 (``k1_``, on the Atlas system, nc 47) refuses A onto X, X's
    row stride short of nc + 1, no layout, and a PGS group wider than a
    warp (a bounds span of 33 rows; within nc ≤ 48 a color has at most 16
    contacts), which its wrapper would refuse first (``kernel_takes``)."""
    import dataclasses

    if fault.startswith("k1_"):
        from jiminy_tpu_torch.ops import constraint_solve as cs

        cfg = CONFIGS["atlas"]
        if fault == "k1_wide_span":
            cfg = dataclasses.replace(cfg, bounds_span=(0, 33), contact_colors=((33, 4),))
            monkeypatch.setattr(cs, "kernel_takes", lambda c: True)
        ws = cs.warp_workspace.__wrapped__(cfg)  # past the cache: no layout kept for it
        ints = list(ws.ints)
        if fault == "k1_overlap":  # A onto X
            ints[6 + 10] = ints[6 + 9]
        elif fault == "k1_short_ldx":  # X's row stride nc: no room for p's column
            ints[4] = cfg.nc
        elif fault == "k1_no_layout":
            ints = []
        monkeypatch.setattr(cs, "warp_workspace", lambda c: dataclasses.replace(ws, ints=tuple(ints)))
        args = _rand_system(79, 8, cfg.n, cfg.nc, cuda_device)
        before = solve_batched.launches
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            solve_batched(cfg, *args, device=cuda_device)
        assert solve_batched.launches == before
        return
    k3 = fault.startswith("k3_")
    fault = fault.removeprefix("k3_")
    if fault.startswith("slab"):
        eng = _prismatic_engine(cuda_device, "slab")
        args = _prismatic_inputs(77, 8, eng, "slab")
    else:
        eng = _anymal_engine(cuda_device)
        args = _substep_inputs(71, 8, eng)
    spec = eng.substep_spec
    ws = spec.warp_workspace()
    ints = list(ws.ints)
    if fault == "overlap":  # J onto M
        ints[8 + 13] = ints[8 + 10]
    elif fault == "too_large":  # one env's slice past the block's shared memory
        ints[1] = 232_448 // 4 + 4
    elif fault == "misaligned":
        ints[8 + 13] += 1
    elif fault == "no_layout":
        ints = []
    elif fault == "slab_overlap":  # A (the chain view's second region) onto X
        ints[8 + 32] = ints[8 + 31]
    else:  # lda = nc − 1
        ints[7] = spec.nc - 1
    spec._warp[0] = dataclasses.replace(ws, ints=tuple(ints))
    if k3:
        from jiminy_tpu_torch.ops.substep_kernel import torque_reference

        q, v, cmd, lam, w = args
        tau = torque_reference(spec, q, v, cmd).contiguous()
        fn, launch = substep_batched, lambda: substep_batched(spec, q, v, tau, lam, w)
    else:
        fn, launch = substep_batched_multi, lambda: substep_batched_multi(spec, 1, *args)
    try:
        before = fn.launches
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            launch()
        assert fn.launches == before
    finally:
        spec._warp.clear()


def _ppo(env, B, rollout_len, minibatches, epochs):
    from jiminy_tpu_torch.rl import PPOConfig
    from jiminy_tpu_torch.rl.ppo import PPO

    cfg = PPOConfig(num_envs=B, rollout_len=rollout_len, minibatches=minibatches, epochs=epochs,
                    hidden=(256, 256), ent_coef=0.005, symmetry_coef=0.1, anneal_lr=True,
                    total_iters=100)
    return PPO(env, cfg, env.symmetry_fn)


@pytest.mark.cuda
def test_learner_on_card_matches_cpu(cuda_device):
    """2 epochs × 4 minibatch updates of 1,024 rows (symmetry and the lr
    schedule on) from the same params, batch and permutations: within 1e-5
    of the CPU's, relative to the params' largest |value| (f32, TF32
    off); the aux metrics within 1e-5."""
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.rl.networks import map_params, param_leaves
    from jiminy_tpu_torch.rl.ppo import adam_init

    env = ANYmalEnv(observe="state", device=cuda_device)
    ppo = _ppo(env, 512, 8, 4, 2)
    gen = torch.Generator().manual_seed(3)
    params = ppo.policy.init(gen)
    n = 4096
    obs = torch.randn(n, 33, generator=gen)
    with torch.no_grad():
        action = ppo.policy.action_dist(params, obs)[0] + torch.randn(n, 12, generator=gen)
        flat = {"obs": obs, "action": action, "logp": ppo.policy.log_prob(params, obs, action),
                "value": ppo.policy.value(params, obs), "adv": torch.randn(n, generator=gen),
                "ret": torch.randn(n, generator=gen)}
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(2)])
    cpu = ppo.learn(params, adam_init(params), flat, perms, 0.005)
    card = map_params(lambda x: x.to(cuda_device), params)
    gpu = ppo.learn(card, adam_init(card), {k: v.to(cuda_device) for k, v in flat.items()},
                    perms.to(cuda_device), 0.005)
    pairs = list(zip(param_leaves(cpu[0]), param_leaves(gpu[0])))
    scale = max(a.abs().max() for a, _ in pairs)
    assert max((b.cpu() - a).abs().max() for a, b in pairs) <= 1e-5 * scale
    for k in cpu[2]:
        torch.testing.assert_close(gpu[2][k].cpu(), cpu[2][k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_train_step_launches_k2_once_per_env_step(cuda_device):
    """One PPO iteration at B = 4096 (rollout 8) on the main path's env:
    exactly one K2 launch per rollout env step and no other launch of
    ours; finite params and metrics."""
    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.ops.constraint_solve import solve_batched
    from jiminy_tpu_torch.rl.networks import param_leaves

    env = ANYmalEnv(observe="state", max_steps=500, device=cuda_device)
    ppo = _ppo(env, 4096, 8, 4, 1)
    carry = ppo.init(0, 4096)
    torch.cuda.synchronize()
    before = (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches)
    carry, metrics = ppo.train_step(carry)
    torch.cuda.synchronize()
    after = (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 8)
    assert all(bool(torch.isfinite(x).all()) for x in param_leaves(carry[0]))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert carry[4] == 1 and carry[2].obs.shape == (4096, 33)


# ---- the URDF builders (A.20) and scale-out (A.18)
def _capsule_engine(dev, dtype=torch.float32):
    """The capsule-foot ANYmal (foot_radius 0.02, foot_len 0.08: 8 sphere
    sites, nc 36) through ``build_robot``, its engine at 5 ms, 8 PGS
    sweeps, and its stand pose."""
    import dataclasses

    from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
    from jiminy_tpu_torch.models.quadruped import ANYMAL, quadruped_hardware, quadruped_urdf
    from jiminy_tpu_torch.robot import build_robot

    p = dataclasses.replace(ANYMAL, foot_radius=0.02, foot_len=0.08)
    robot = build_robot(quadruped_urdf(p), quadruped_hardware(p), freeflyer=True, device=dev,
                        dtype=dtype)
    opts = EngineOptions(contact_model="constraint", dt=5e-3, pgs_iters=8,
                         constraint_solver="substep")
    return Engine(robot.tree, opts, motors=robot.motors, controller=PDController(80.0, 2.0),
                  device=dev), stand_q(robot.tree, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [1, 4])
def test_capsule_feet_k2_matches_plain_version(cuda_device, n_sub):
    """K2 on the capsule-foot ANYmal (the sphere-site branch at nc 36),
    env by env against the float64 plain version, at B = 1000."""
    (eng, stand), (eng64, _) = _capsule_engine(cuda_device), _capsule_engine(cuda_device,
                                                                             torch.float64)
    spec = eng.substep_spec
    assert spec.spheres and spec.nc == 36
    args = _substep_inputs(46, 1000, eng, stand)
    out = substep_batched_multi(spec, n_sub, *args)
    p32 = substep_multi_reference(spec, n_sub, *args)
    p64 = substep_multi_reference(eng64.substep_spec, n_sub, *[x.double() for x in args])
    torch.cuda.synchronize()
    assert float((p64[4][..., 2] != 0).any(1).double().mean()) > 0.5
    for i, name in ((0, "q"), (1, "v"), (2, "lam"), (4, "impulse")):
        _assert_env_by_env_vs_f64(f"capsule feet n_sub={n_sub} {name}", out[i], p32[i], p64[i])


@pytest.mark.cuda
def test_distributed_world_size_one_is_bit_identical(cuda_device):
    """``make_distributed_train`` over NCCL at world size 1: one train
    step from ``init_fn(0)`` equals the single-device step from
    ``init_fn(0, B)`` bit for bit (params, Adam's state, metrics) and
    launches K2 as often, once per rollout env step."""
    import torch.distributed as dist

    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.rl.distributed import make_distributed_train
    from jiminy_tpu_torch.rl.launch import initialize_cluster
    from jiminy_tpu_torch.rl.networks import param_leaves

    env = ANYmalEnv(observe="state", max_steps=500, device=cuda_device)
    ppo = _ppo(env, 1024, 8, 4, 1)
    initialize_cluster(num_processes=1, process_id=0, backend="nccl")
    try:
        init_fn, train_step, _ = make_distributed_train(env, ppo.cfg, symmetry_fn=env.symmetry_fn)
        outs = []
        for init, step in ((init_fn, train_step), (lambda s: ppo.init(s, 1024), ppo.train_step)):
            carry = init(0)
            torch.cuda.synchronize()
            before = substep_batched_multi.launches
            outs.append(step(carry) + (substep_batched_multi.launches - before,))
    finally:
        dist.destroy_process_group()
    (a, ma, na), (b, mb, nb) = outs
    assert na == nb == 8
    for x, y in zip(param_leaves(a[0]) + a[1]["mu"] + a[1]["nu"],
                    param_leaves(b[0]) + b[1]["mu"] + b[1]["nu"]):
        assert torch.equal(x, y)
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)


# ---- the convenience layer (A.19)
def _counts():
    return (solve_batched.launches, substep_batched.launches, substep_batched_multi.launches,
            substep_batched_multi.sensor_launches)


def _launched(before):
    torch.cuda.synchronize()
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.cuda
def test_simulator_runs_k2_and_its_log_rebuilds(cuda_device, tmp_path):
    """``Simulator.simulate`` of ANYmal built from its URDF at B = 1: one
    K2 launch per engine step and no other; the log read back bit for
    bit, the robot rebuilt from it simulates the same log bit for bit;
    ``simulate_batch`` at B = 64 bit for bit the hand-written loop of
    ``Engine.step``, one K2 launch per control step."""
    from jiminy_tpu_torch.engine import EngineOptions
    from jiminy_tpu_torch.io.serialization import build_robot_from_log
    from jiminy_tpu_torch.simulator import Simulator
    from jiminy_tpu_torch.telemetry import TelemetryLog

    opts = EngineOptions(dt=2.5e-3, contact_model="constraint", pgs_iters=8)
    sim = Simulator.build("data/anymal.urdf", "data/anymal_hardware.toml", freeflyer=True,
                          options=opts, device=cuda_device)
    q0 = torch.as_tensor(stand_q(sim.tree), device=cuda_device)
    tgt = q0[None, list(sim.robot.motors.q_idx)]

    def pd(q, v, t):
        qm, vm = sim.robot.motors.joint_state(q, v)
        return 80.0 * (tgt - qm) - 2.0 * vm

    torch.cuda.synchronize()
    before = _counts()
    _, log = sim.simulate(0.1, q0=q0, controller=pd)
    assert _launched(before) == (0, 0, 40, 0) and len(log) == 40
    log.write_binary(tmp_path / "run.jtpu")
    back = TelemetryLog.read_binary(tmp_path / "run.jtpu")
    assert all(np.array_equal(back.columns[k], c) for k, c in log.columns.items())
    sim2 = Simulator(build_robot_from_log(back, device=cuda_device), options=opts,
                     device=cuda_device)
    _, log2 = sim2.simulate(0.1, q0=q0, controller=pd)
    assert all(np.array_equal(log2.columns[k], c) for k, c in log.columns.items())
    sim.engine.set_options({"dt": 5e-3})
    qb = q0.repeat(64, 1)
    qb[:, 7:] += 0.05 * torch.rand(64, 12, generator=torch.Generator(device=cuda_device)
                                   .manual_seed(0), device=cuda_device)
    vb = torch.zeros(64, sim.tree.nv, device=cuda_device)
    before = _counts()
    fin = sim.simulate_batch(0.2, qb, vb, controller=pd, control_dt=0.02)
    assert _launched(before) == (0, 0, 10, 0)
    st = sim.engine.reset(qb, vb)
    for _ in range(10):
        st = sim.engine.step(st, pd(st.q, st.v, st.t), n_substeps=4)
    for f in ("q", "v", "lam"):
        assert torch.equal(getattr(st, f), getattr(fin, f)), f


@pytest.mark.cuda
def test_set_options_reroutes_the_sensor_env(cuda_device):
    """``engine.set_options({"substep_fusion": False})`` on a live sensor
    env: its next step runs the chunked path (K3 × 4, no sensor K2); with
    fusion on again, one K2 with the sensor stage. ``pgs_iters`` 16 on the
    state env steps bit for bit as a freshly built engine."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    env = ANYmalEnv(observe="sensors", sensor_delay=0.004, device=cuda_device)
    st = env.reset(torch.Generator(device=cuda_device).manual_seed(0), 256)
    a = torch.zeros(256, 12, device=cuda_device)
    env.engine.set_options({"substep_fusion": False})
    before = _counts()
    st = env.step(st, a)
    assert not env._fused_sensors and _launched(before) == (0, 4, 0, 0)
    env.engine.set_options({"substep_fusion": True})
    before = _counts()
    st = env.step(st, a)
    assert env._fused_sensors and _launched(before) == (0, 0, 0, 1)
    state_env = ANYmalEnv(observe="state", device=cuda_device)
    fresh = ANYmalEnv(observe="state", pgs_iters=16, device=cuda_device).engine
    state_env.engine.set_options({"pgs_iters": 16})
    s0 = state_env.reset(torch.Generator(device=cuda_device).manual_seed(1), 256).sim
    u = state_env._action_to_command(a, s0)
    x, y = state_env.engine.step(s0, u, n_substeps=4), fresh.step(s0, u, n_substeps=4)
    for f in ("q", "v", "lam"):
        assert torch.equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.cuda
def test_pcg32_and_parity_on_the_card(cuda_device):
    """PCG32 on the card bit for bit the CPU's; ``parity.compare`` of a
    fixture in float64 on the card within 1e-9 of the CPU's report."""
    from jiminy_tpu_torch import parity
    from jiminy_tpu_torch.utils.pcg_torch import pcg32_init, pcg32_next

    seeds = torch.arange(1000, dtype=torch.int64)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        st, xs = pcg32_init(seeds.to(dev), device=dev), []
        for _ in range(8):
            st, x = pcg32_next(st)
            xs.append(x.cpu())
        outs.append(torch.stack(xs))
    assert torch.equal(*outs)
    card = parity.compare("parity/fixtures/ball_drop_impact", device=cuda_device)
    cpu = parity.compare("parity/fixtures/ball_drop_impact", device="cpu")
    assert card.ok and cpu.ok and card.device.startswith("cuda")
    assert abs(card.max_drift_q - cpu.max_drift_q) <= 1e-9
    assert abs(card.max_drift_v - cpu.max_drift_v) <= 1e-9
