"""Where the time of K2's warp body goes, stage by stage, on a GPU.

    python -m jiminy_tpu_torch.tools.profile_warp_stages [--batch 4096]
        [--env walkers|anymal|ant|spotmicro|cassie|slab] [--self-collision] [--flexibility]

Runs K2 (``substep_batched_multi``) through the measuring build of the
nominal library (``csrc/substep_stages.cu``: ``csrc/substep.cuh`` with
``JT_WARP_STAGES``, each warp adding up ``clock64`` between the stages of
its env) from reset states, on the state and sensor paths' env step:
ANYmal's (4 substeps, the flagship's suite), the Ant's (20) and the
Spotmicro's (20) with ``--env walkers`` (the default), one of them alone,
or the large frame: ``--env cassie`` the biped of ``examples/train.py
--env cassie`` (``CassieEnv(sim_dt=2e-3, target_speed=0.4)``, 10
substeps, ``cassie_sensors_run``'s sensing), with ``--self-collision``
its legs' capsule pairs (nc 37) and ``--flexibility`` its flexible hips
(nv 26); ``--env slab`` the reference's PRISMATIC kernel scene
(tests/test_box_pairs.py's sprung slab and free cube with their box pair,
nc 48; 6 substeps of 1 ms, the cube landing; no sensors). Prints one JSON
line per model and path: the card (``nvidia-smi`` name and power limit),
the cycles per env per substep of each stage and its share of the
launch. The shares are those of one warp's own time; with several warps
resident on an SM each one's cycles include the time it waits for the
others. Needs a CUDA GPU.
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
    spec.warp_workspace(kw.get("sensors"))  # raises for a model past the caps
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


def _slab_case(B, dev, gen):
    """The slab scene's engine (a frictionless direct motor on the slider,
    1 ms, 8 sweeps) and inputs: the cube resting 3 mm into to 7 mm above
    the slab's face, sliding at up to 0.45 m/s."""
    import numpy as np

    from jiminy_tpu_torch.core.tree import JointType, TreeBuilder
    from jiminy_tpu_torch.engine import Engine, EngineOptions
    from jiminy_tpu_torch.engine.collision import Box, CollisionPair
    from jiminy_tpu_torch.hardware.motors import Motors

    b = TreeBuilder()
    b.add_body("slab", -1, JointType.PRISMATIC, axis=(0, 0, 1), mass=100.0, com=(0, 0, 0.05),
               inertia=np.diag([10.0] * 3), joint_name="slab_z", stiffness=1e7, damping=1e4)
    b.add_body("cube", -1, JointType.FREE, mass=1.0, inertia=np.diag([0.004] * 3))
    pair = CollisionPair(Box("slab", (0, 0, 0.05), (0.3, 0.3, 0.05)),
                         Box("cube", (0, 0, 0), (0.1, 0.1, 0.1)), friction=0.8)
    eng = Engine(b.build(device=dev),
                 EngineOptions(contact_model="constraint", dt=1e-3, pgs_iters=8,
                               constraint_solver="substep"),
                 motors=Motors.create([0], names=["slab_z"], device=dev), collision_pairs=(pair,),
                 device=dev)
    kw = dict(generator=gen, device=dev)
    q = torch.zeros(B, 8, device=dev)
    q[:, 1:3] = 0.2 * torch.rand(B, 2, **kw) - 0.1
    q[:, 3] = 0.197 + 0.01 * torch.rand(B, **kw)
    q[:, 7] = 1.0
    v = torch.zeros(B, 7, device=dev)
    v[:, 1:3] = 0.6 * torch.rand(B, 2, **kw) - 0.3
    return eng, (q, v, torch.zeros(B, 1, device=dev), torch.zeros(B, eng.nc, device=dev),
                 torch.zeros(B, 6, device=dev))


def _cases(env_name, self_collision, flexibility, B, dev):
    """(model name, spec, substeps, inputs, {path: kernel keywords}) of
    each model ``env_name`` names."""
    from jiminy_tpu_torch.envs import AntEnv, ANYmalEnv, CassieEnv, SpotmicroEnv
    from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec

    gen = torch.Generator(device=dev).manual_seed(0)
    if env_name == "slab":
        eng, args = _slab_case(B, dev, gen)
        return [("slab", eng.substep_spec, 6, args, {"state": {}})]
    names = ("anymal", "ant", "spotmicro") if env_name == "walkers" else (env_name,)
    out = []
    for name in names:
        if name == "cassie":
            env = CassieEnv(sim_dt=2e-3, target_speed=0.4, observe="sensors", sensor_delay=0.004,
                            imu_noise=0.02, encoder_noise=0.005, self_collision=self_collision,
                            flexibility=flexibility, device=dev)
            name += "".join(f"_{f}" for f, on in (("selfcol", self_collision),
                                                   ("flex", flexibility)) if on)
        else:
            env = {"anymal": ANYmalEnv, "ant": AntEnv, "spotmicro": SpotmicroEnv}[name](
                observe="sensors", device=dev)
        args = _inputs(env, B, gen)
        spec, n_sub, suite = env.engine.substep_spec, env.n_substeps, env.sensors
        sens = SensorKernelSpec(env.tree, suite, env.n_substeps_per_obs)
        bufs = suite.flatten_buffers(suite.reset(suite.sample_eps(gen, B), *args[:2]))
        eps = torch.cat([suite.sample_eps(gen, B) for _ in range(n_sub // sens.k_obs)], 1)
        out.append((name, spec, n_sub, args,
                    {"state": {}, "sensors": dict(sensors=sens, bufs=bufs, eps=eps)}))
    return out


def profile(B: int, dev, env: str = "walkers", self_collision: bool = False,
            flexibility: bool = False) -> list[dict]:
    rows = []
    for name, spec, n_sub, args, paths in _cases(env, self_collision, flexibility, B, dev):
        for path, kw in paths.items():
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
    ap.add_argument("--env", default="walkers",
                    choices=("walkers", "anymal", "ant", "spotmicro", "cassie", "slab"))
    ap.add_argument("--self-collision", action="store_true",
                    help="with --env cassie: the legs' self-collision pairs")
    ap.add_argument("--flexibility", action="store_true",
                    help="with --env cassie: the flexible hips")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_warp_stages: no CUDA GPU available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for row in profile(args.batch, torch.device("cuda"), args.env, args.self_collision,
                       args.flexibility):
        print(json.dumps({"card": card, **row}))


if __name__ == "__main__":
    main()
