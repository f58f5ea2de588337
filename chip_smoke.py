"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``jiminy_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version, drives the flagship
ANYmal env step (B = 4096, 4 substeps of 5 ms, 8 PGS sweeps) through the
port's public entry points, and times the env step and each kernel. It
imports nothing of JAX and nothing of ``jiminy_tpu``.

Phases (any failure raises and the script exits non-zero):

0. a CUDA GPU is present; card name and power limit; nvcc build time;
1. the constraint-solve kernel against ``solve_reference`` on random SPD
   systems (ANYmal, Atlas and Cassie layouts, with and without the KKT
   residual; ANYmal at B = 4096 with 8 sweeps; a ragged B = 1000),
   max |Δ| ≤ 1e-4 on v⁺, λ and the residual;
2. the main path: ``ANYmalEnv(observe="state", device="cuda")`` reset
   from a seeded generator and 25 env steps with uniform actions; q, v,
   obs and reward finite; the kernel launched exactly 4 × 25 times; one
   env step through the kernel equals the same step through the inline
   plain chain to 1e-4 on q and v, each substep from the same inputs;
3. env-steps/s (3 timed loops of 25 steps) and the kernel's and the
   plain version's times with CUDA events, beside the kernel's bound.

The line before the last is a JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # non-tensor-core float32

TOL = 1e-4  # f32 reassociation between the kernel and the plain version
B_MAIN = 4096
STEPS = 25


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _rand_system(gen, B, n, nc, dev, active_p=0.7):
    """Random well-conditioned systems, made as tests/test_pallas_solve.py
    makes them."""
    kw = dict(generator=gen, device=dev)
    R = torch.randn(B, n, n, **kw) * 0.3
    M = R @ R.transpose(1, 2) + 2.0 * torch.eye(n, device=dev)
    p = torch.randn(B, n, **kw)
    v = torch.randn(B, n, **kw) * 0.5
    J = torch.randn(B, nc, n, **kw) * 0.5
    target = torch.randn(B, nc, **kw) * 0.1
    mu = torch.full((B, nc), 0.8, device=dev)
    active = (torch.rand(B, nc, **kw) < active_p).float()
    lam0 = torch.randn(B, nc, **kw) * 0.01
    return M, p, v, J, target, mu, active, lam0


def _solve_flops(cfg) -> int:
    """Floating-point operations of one env's chain (a multiply-add is
    2), counted from the algorithm; no part of it depends on the data."""
    n, nc, m = cfg.n, cfg.nc, cfg.nc + 1
    chol = sum(2 * (n - j) * j + (n - j) for j in range(n))
    solves = 2 * (2 * (n * (n - 1) // 2) * m + n * m)
    delassus = 2 * nc * nc * n + 2 * nc * n + 2 * n
    pgs = cfg.iters * nc * (2 * nc + 4)
    vnext = 2 * n * nc
    resid = 2 * nc * nc if cfg.compute_residual else 0
    return chol + solves + delassus + pgs + vnext + resid


def _solve_bytes(cfg, B) -> int:
    """Bytes in (M, p, v, J, target, mu, active, λ0) and out (v⁺, λ,
    residual), each read or written once, float32."""
    n, nc = cfg.n, cfg.nc
    return 4 * B * (n * n + 2 * n + nc * n + 4 * nc + n + nc + 1)


def _time_cuda(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel_vs_plain(dev) -> float:
    from jiminy_tpu_torch.engine.solver import BlockSpec
    from jiminy_tpu_torch.ops.constraint_solve import (
        SolveConfig,
        solve_batched,
        solve_reference,
    )

    base = {
        "anymal": SolveConfig(
            n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
            contact_colors=((12, 2), (18, 2)), iters=4,
        ),
        "atlas": SolveConfig(
            n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
            contact_colors=((23, 4), (35, 4)), iters=4,
        ),
        "cassie": SolveConfig(
            n=22, nc=26, dt=2e-3, eq_blocks=(BlockSpec("equality", 0, 4),),
            bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)),
            iters=4, relax=0.9,
        ),
    }
    cases = []
    for name, cfg in base.items():
        for resid in (True, False):
            cases.append((f"{name} residual={resid}", dataclasses.replace(cfg, compute_residual=resid), 64))
    main_cfg = dataclasses.replace(base["anymal"], iters=8)
    cases += [
        ("anymal B=4096 iters=8", main_cfg, B_MAIN),
        ("anymal B=4096 iters=8 residual", dataclasses.replace(main_cfg, compute_residual=True), B_MAIN),
        ("anymal ragged B=1000 iters=8", dataclasses.replace(main_cfg, compute_residual=True), 1000),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for label, cfg, B in cases:
        args = _rand_system(gen, B, cfg.n, cfg.nc, dev)
        vk, lk, rk = solve_batched(cfg, *args, device=dev)
        vr, lr, rr = solve_reference(cfg, *args)
        torch.cuda.synchronize()
        errs = [
            (vk - vr).abs().max().item(),
            (lk - lr).abs().max().item(),
            (rk - rr).abs().max().item() if cfg.compute_residual else 0.0,
        ]
        print(f"[phase 1] {label}: max|dv|={errs[0]:.3g} max|dlam|={errs[1]:.3g} "
              f"max|dres|={errs[2]:.3g}")
        if not all(e <= TOL for e in errs):
            raise AssertionError(f"kernel disagrees with the plain version on {label}: {errs}")
        if "B=4096" in label and not cfg.compute_residual:
            worst = max(worst, errs[0], errs[1])
    return worst


def _as_f64(state):
    sim = type(state.sim)(**{k: getattr(state.sim, k).double() for k in state.sim.FIELDS})
    return state.replace(sim=sim, obs=state.obs.double())


def _ab_env_step(env, state, act_gen, dev):
    """One env step through the kernel against the same step through the
    inline plain chain. Each of the 4 substeps feeds both backends the same
    inputs (the kernel's trajectory), so the check holds the kernel to
    1e-4 where float32 is well posed. The free-running steps are reported
    too, beside the inline chain in float64: from the same state, float32
    rounding compounds over the substeps to ~1e-3 in a few envs of 4096,
    for any two float32 implementations."""
    from jiminy_tpu_torch.envs import ANYmalEnv

    kw = dict(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    inline = ANYmalEnv(constraint_solver="inline", **kw)
    inline64 = ANYmalEnv(constraint_solver="inline", dtype=torch.float64, **kw)
    a = torch.rand(state.obs.shape[0], 12, generator=act_gen, device=dev) * 2.0 - 1.0
    u = env._action_to_command(a, state.sim)
    sim, dq, dv = state.sim, 0.0, 0.0
    for _ in range(env.n_substeps):
        nk = env.engine.step(sim, u, n_substeps=1)
        ni = inline.engine.step(sim, u, n_substeps=1)
        dq = max(dq, (nk.q - ni.q).abs().max().item())
        dv = max(dv, (nk.v - ni.v).abs().max().item())
        sim = nk
    s_k = env.step_no_reset(state, a)
    s_i = inline.step_no_reset(state, a)
    s_64 = inline64.step_no_reset(_as_f64(state), a.double())

    def gap(x, y):
        d = (x.double() - y.double()).abs().amax(dim=1)
        return {"max": d.max().item(), "envs_over_1e-4": int((d > TOL).sum())}

    free = {
        "kernel_vs_inline_v": gap(s_k.sim.v, s_i.sim.v),
        "kernel_vs_inline_f64_v": gap(s_k.sim.v, s_64.sim.v),
        "inline_vs_inline_f64_v": gap(s_i.sim.v, s_64.sim.v),
    }
    return dq, dv, free


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU available")
    dev = torch.device("cuda")
    gpu = _gpu_line()
    print(f"[phase 0] {gpu}")
    print(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from jiminy_tpu_torch.envs import ANYmalEnv
    from jiminy_tpu_torch.ops import _build
    from jiminy_tpu_torch.ops.constraint_solve import (
        solve_batched,
        solve_reference,
    )

    t0 = time.perf_counter()
    build = _build.build_all()
    print(f"[phase 0] nvcc build {json.dumps(build)} "
          f"wall {time.perf_counter() - t0:.2f} s")

    # ---- phase 1: every kernel against its plain version
    main_err = phase_kernel_vs_plain(dev)

    # ---- phase 2: the main path through the public entry points
    env = ANYmalEnv(observe="state", step_dt=0.02, sim_dt=5e-3, pgs_iters=8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    act_gen = torch.Generator(device=dev).manual_seed(1)
    state = env.reset(gen, B_MAIN)
    torch.cuda.synchronize()
    solve_batched.launches = 0
    for _ in range(STEPS):
        a = torch.rand(B_MAIN, 12, generator=act_gen, device=dev) * 2.0 - 1.0
        state = env.step(state, a)
    torch.cuda.synchronize()
    launches = solve_batched.launches
    print(f"[phase 2] {STEPS} env steps at B={B_MAIN}: constraint_solve launches={launches}")
    if launches != env.n_substeps * STEPS:
        raise AssertionError(f"expected {env.n_substeps * STEPS} kernel launches, saw {launches}")
    for name, x in (("q", state.sim.q), ("v", state.sim.v), ("obs", state.obs),
                    ("reward", state.reward)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name} after the main path")
    print(f"[phase 2] finite q, v, obs, reward; done this step "
          f"{int(state.done.sum())}/{B_MAIN}; mean reward {state.reward.mean().item():.4f}")

    dq, dv, free = _ab_env_step(env, state, act_gen, dev)
    print(f"[phase 2] one env step, kernel vs inline chain on the same substep inputs: "
          f"max|dq|={dq:.3g} max|dv|={dv:.3g}")
    print("[phase 2] free-running (f32 rounding compounds over 4 substeps; the "
          "f64 inline chain is the yardstick): " + json.dumps(free))
    if not (dq <= TOL and dv <= TOL):
        raise AssertionError(f"kernel env step disagrees with the inline chain: {dq}, {dv}")

    # ---- phase 3: times
    for _ in range(STEPS):  # warm-up
        state = env.step(state, torch.rand(B_MAIN, 12, generator=act_gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        acts = [torch.rand(B_MAIN, 12, generator=act_gen, device=dev) * 2 - 1
                for _ in range(STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        rates.append(B_MAIN * STEPS / (time.perf_counter() - t0))
    print(f"[phase 3] env-steps/s at B={B_MAIN}: {[round(r, 1) for r in rates]} "
          f"(max {max(rates):.1f})")

    cfg = env.engine.solve_config
    args = _rand_system(torch.Generator(device=dev).manual_seed(2), B_MAIN, cfg.n, cfg.nc, dev)
    ms = _time_cuda(lambda: solve_batched(cfg, *args, device=dev), 50)
    plain_ms = _time_cuda(lambda: solve_reference(cfg, *args), 5)
    t_bytes = _solve_bytes(cfg, B_MAIN) / HBM_BYTES_PER_S
    t_ops = _solve_flops(cfg) * B_MAIN / F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    print(f"[phase 3] constraint_solve B={B_MAIN}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({_solve_bytes(cfg, B_MAIN)} B, "
          f"{_solve_flops(cfg) * B_MAIN} FLOP)")

    kernels = [{
        "name": "constraint_solve",
        "route": "cuda",
        "source": "jiminy_tpu_torch/csrc/constraint_solve.cu",
        "replaces": "jiminy_tpu/ops/constraint_solve.py:358",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"env_steps_per_s": rates, "nvcc_build_s": build}))
    print(json.dumps({"kernels": kernels}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
