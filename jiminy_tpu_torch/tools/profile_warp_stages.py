"""Where the time of K2's warp body goes, stage by stage, on a GPU.

    python -m jiminy_tpu_torch.tools.profile_warp_stages [--batch 4096]

Runs K2 (``substep_batched_multi``) through the measuring build of the
nominal library (``csrc/substep_stages.cu``: ``csrc/substep.cuh`` with
``JT_WARP_STAGES``, each warp adding up ``clock64`` between the stages of
its env) on the ANYmal state and sensor paths' substep (4 substeps, the
flagship's suite), the Ant's (20) and the Spotmicro's (20), from reset
states, and prints one JSON line per model: the card (``nvidia-smi`` name
and power limit), the cycles per env per substep of each stage and its
share of the launch. The shares are those of one warp's own time; with
several warps resident on an SM each one's cycles include the time it
waits for the others. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

STAGES = ("torque", "FK + RNEA forward", "RNEA backward + composite inertias", "CRBA (M)",
          "rows (diagonal, bounds, contacts, pairs)", "Cholesky + M⁻¹[p | Jᵀ]",
          "v_free + Delassus + rhs", "PGS", "v⁺ + residual", "impulses + Euler", "sensor stage",
          "copies in and out")


def _stage_library():
    from jiminy_tpu_torch.ops import _build
    from jiminy_tpu_torch.ops import substep_kernel as sk

    lib = sk.bind(_build.load("substep_stages"))
    lib.jt_stage_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    if lib.jt_stage_count() != len(STAGES):
        raise RuntimeError(f"the stage build counts {lib.jt_stage_count()} stages, not "
                           f"{len(STAGES)}")
    return lib


def stage_cycles(spec, n_sub, args, **kw) -> dict:
    """One launch of K2 through the measuring build: {stage: cycles per env
    per substep}, and the sum."""
    from jiminy_tpu_torch.ops import substep_kernel as sk

    lib = _stage_library()
    if spec.warp_workspace(kw.get("sensors")) is None:
        raise ValueError("the model is outside the warp body's frame")
    kernel, sk._kernel = sk._kernel, lambda randomized: lib
    try:
        sk.substep_batched_multi(spec, n_sub, *args, **kw)  # warm-up
        torch.cuda.synchronize()
        if lib.jt_stage_reset() != 0:
            raise RuntimeError("jt_stage_reset failed")
        sk.substep_batched_multi(spec, n_sub, *args, **kw)
        torch.cuda.synchronize()
    finally:
        sk._kernel = kernel
    out = (ctypes.c_ulonglong * (len(STAGES) + 1))()
    if lib.jt_stage_read(out) != 0:
        raise RuntimeError("jt_stage_read failed")
    envs = out[len(STAGES)]
    cyc = {name: out[k] / envs / n_sub for k, name in enumerate(STAGES)}
    cyc["total"] = sum(cyc.values())
    return cyc


def _inputs(env, B, gen):
    dev = env.engine.device
    state = env.reset(gen, B)
    act = torch.rand(B, env.motors.nm, generator=gen, device=dev) * 2.0 - 1.0
    cmd = env._action_to_command(act, state.sim)
    return (state.sim.q, state.sim.v, cmd, state.sim.lam, torch.zeros(B, 6, device=dev))


def profile(B: int, dev) -> list[dict]:
    from jiminy_tpu_torch.envs import AntEnv, ANYmalEnv, SpotmicroEnv
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    rows = []
    for name, make in (("anymal", ANYmalEnv), ("ant", AntEnv), ("spotmicro", SpotmicroEnv)):
        env = make(observe="sensors", device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        args = _inputs(env, B, gen)
        spec, n_sub, suite = env.engine.substep_spec, env.n_substeps, env.sensors
        sens = SensorKernelSpec(env.tree, suite, env.n_substeps_per_obs)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), *args[:2]))
        eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_sub // sens.k_obs)], 1)
        for path, kw in (("state", {}), ("sensors", dict(sensors=sens, bufs=bufs, eps=eps))):
            cyc = stage_cycles(spec, n_sub, args, **kw)
            rows.append({
                "model": name, "path": path, "B": B, "n_sub": n_sub,
                "cycles_per_env_substep": {k: round(v, 1) for k, v in cyc.items()},
                "share": {k: round(v / cyc["total"], 4) for k, v in cyc.items() if k != "total"},
            })
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_warp_stages: no CUDA GPU available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for row in profile(args.batch, torch.device("cuda")):
        print(json.dumps({"card": card, **row}))


if __name__ == "__main__":
    main()
