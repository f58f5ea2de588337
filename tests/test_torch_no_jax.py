"""The port reaches neither JAX nor the reference package.

The machine with the GPU has no jax, flax, optax or orbax, so every
module of ``jiminy_tpu_torch`` and ``chip_smoke.py`` must import without
them. In a fresh interpreter a ``sys.meta_path`` finder refuses the
top-level names below (exact names: ``jiminy_tpu_torch`` still loads);
then every module of the port is imported, ``chip_smoke`` is imported
without running, and one CPU env step is taken at B = 2 on the
state-observing env's whole-substep path (the kernels' plain versions)
and chain-kernel path, on the sensor-observing env's fused and chunked
paths, and on the terrain and push env (per-env Fourier ground, fused
and chunked; the ``"perlin_grid"`` heightmap), on the sim-to-real
env with model randomization (fused and chunked), and on the Cassie env
(pushrod closed loops and shin springs) on the state path and the
sensor path fused and chunked, with the self-collision pairs too, and
the flexible-hip Cassie on the state path and the fused sensor path, the
Ant and the Spotmicro on the state path and the fused and chunked sensor
paths, the Atlas humanoid with its self-collision pairs on the state path
and the fused sensor path, the PRISMATIC cartpole through ``Engine.step``,
ANYmal on the reference's default penalty contacts (the continuous path)
and the ``CartPoleEnv``; a step of the declarative ANYmal MDP through
``mahony``, ``stack:4`` and ``normalize``; the ANYmal of
``data/anymal.urdf`` and its hardware TOML through ``build_robot`` and a
``WalkerEnv`` step, and through the ``Simulator`` (a log written, read,
its robot rebuilt, an HTML report, a rendered frame), a PCG32 draw; then
one PPO
``train_step`` (B = 2, the symmetry loss on) and one ``evaluate`` step on
the state-observing env. The
modules that hold kernels, the sensor suite, the grounds, the terrain
generators, the random processes, the model randomization, the
constraints, the collision pairs, the registered forces, the steppers,
the biped, the humanoid, the Ant, the toys, the legged and toy envs, the
RL modules (the distributed train step and the launcher too), the
checkpoint, the train and evaluate entry points, the declarative layer's
modules, the URDF parser, the STL reader and the robot builder are named,
so a rename cannot drop them from the walk. A second test imports each kernel module
first in a fresh interpreter: the engine and ops packages import each
other, and any order must work.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "jiminy_tpu"}
KERNEL_MODULES = ("jiminy_tpu_torch.ops.constraint_solve", "jiminy_tpu_torch.ops.substep_kernel",
                  "jiminy_tpu_torch.hardware.sensors", "jiminy_tpu_torch.engine.ground",
                  "jiminy_tpu_torch.engine.terrain", "jiminy_tpu_torch.utils.random",
                  "jiminy_tpu_torch.engine.randomization", "jiminy_tpu_torch.engine.constraints",
                  "jiminy_tpu_torch.models.biped", "jiminy_tpu_torch.models.humanoid",
                  "jiminy_tpu_torch.envs.legged",
                  "jiminy_tpu_torch.engine.collision", "jiminy_tpu_torch.models.ant",
                  "jiminy_tpu_torch.models.toys", "jiminy_tpu_torch.rl.networks",
                  "jiminy_tpu_torch.rl.ppo", "jiminy_tpu_torch.rl.evaluate",
                  "jiminy_tpu_torch.rl.logging", "jiminy_tpu_torch.checkpoint",
                  "jiminy_tpu_torch.tools.train", "jiminy_tpu_torch.tools.evaluate",
                  "jiminy_tpu_torch.engine.forces", "jiminy_tpu_torch.engine.steppers",
                  "jiminy_tpu_torch.envs.cartpole", "jiminy_tpu_torch.envs.acrobot",
                  "jiminy_tpu_torch.envs.blocks", "jiminy_tpu_torch.envs.quantities",
                  "jiminy_tpu_torch.envs.compositions", "jiminy_tpu_torch.envs.pipeline",
                  "jiminy_tpu_torch.envs.gym_adapter", "jiminy_tpu_torch.envs.registration",
                  "jiminy_tpu_torch.io.urdf", "jiminy_tpu_torch.io.stl", "jiminy_tpu_torch.robot",
                  "jiminy_tpu_torch.rl.distributed", "jiminy_tpu_torch.rl.launch",
                  "jiminy_tpu_torch.simulator", "jiminy_tpu_torch.telemetry",
                  "jiminy_tpu_torch.dynamics", "jiminy_tpu_torch.io.serialization",
                  "jiminy_tpu_torch.utils.health", "jiminy_tpu_torch.utils.pcg_torch",
                  "jiminy_tpu_torch.plot", "jiminy_tpu_torch.viewer", "jiminy_tpu_torch.viewer3d",
                  "jiminy_tpu_torch.parity")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ImportError(f"import of {name!r} refused")
        return None


sys.meta_path.insert(0, Refuse())
try:
    import jiminy_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the finder did not refuse jiminy_tpu")

import jiminy_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(jiminy_tpu_torch.__path__, "jiminy_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
for m in KERNEL_MODULES:
    assert m in mods, m
import chip_smoke  # noqa: F401  (module only: main() is not run)

import torch
from jiminy_tpu_torch.envs import ANYmalEnv

torch.set_num_threads(1)  # six xdist workers share the CPU

for solver in ("substep", "kernel"):
    env = ANYmalEnv(observe="state", constraint_solver=solver, device="cpu")
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 12))
    assert bool(torch.isfinite(st.sim.q).all()) and st.obs.shape == (2, 33)
for fused in (True, False):
    env = ANYmalEnv(sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005, device="cpu")
    env._fused_sensors = fused
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 12))
    assert bool(torch.isfinite(st.obs).all()) and st.obs.shape == (2, 33)
for terrain, fused in (("fourier", True), ("fourier", False), ("perlin_grid", False)):
    env = ANYmalEnv(terrain=terrain, push_magnitude=100.0, push_duration=0.2, sensor_delay=0.004,
                    device="cpu")
    env._fused_sensors = fused
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 12))
    assert bool(torch.isfinite(st.obs).all()) and "push_force" in st.info
from jiminy_tpu_torch.engine.randomization import ModelRandomization

for fused in (True, False):
    env = ANYmalEnv(terrain="fourier", push_magnitude=100.0, push_duration=0.2, sensor_delay=0.004,
                    model_randomization=ModelRandomization(mass_scale=(0.8, 1.2)), device="cpu")
    env._fused_sensors = fused
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 12))
    assert bool(torch.isfinite(st.obs).all()) and "model_params" in st.info
from jiminy_tpu_torch.envs import CassieEnv

for observe, fused, pairs, flex in (("state", False, False, False), ("sensors", True, False, False),
                                    ("sensors", False, False, False), ("state", False, True, False),
                                    ("sensors", True, True, False), ("state", False, False, True),
                                    ("sensors", True, False, True)):
    env = CassieEnv(sim_dt=2e-3, target_speed=0.4, observe=observe, sensor_delay=0.004,
                    imu_noise=0.02, encoder_noise=0.005, self_collision=pairs, flexibility=flex,
                    device="cpu")
    env._fused_sensors = fused
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 10))
    assert bool(torch.isfinite(st.obs).all()) and st.obs.shape == (2, 29)
from jiminy_tpu_torch.envs import AntEnv, SpotmicroEnv

for Env, nm, nobs in ((AntEnv, 8, 25), (SpotmicroEnv, 12, 33)):
    for observe, fused in (("state", False), ("sensors", True), ("sensors", False)):
        env = Env(observe=observe, device="cpu")
        env._fused_sensors = fused
        st = env.reset(torch.Generator().manual_seed(0), 2)
        st = env.step(st, torch.zeros(2, nm))
        assert bool(torch.isfinite(st.obs).all()) and st.obs.shape == (2, nobs)
from jiminy_tpu_torch.envs import AtlasEnv

for observe, fused, pairs in (("state", False, True), ("sensors", True, True)):
    env = AtlasEnv(observe=observe, self_collision=pairs, sensor_delay=0.004, device="cpu")
    env._fused_sensors = fused
    st = env.reset(torch.Generator().manual_seed(0), 2)
    st = env.step(st, torch.zeros(2, 23))
    assert env.engine.nc == 83 and bool(torch.isfinite(st.obs).all()) and st.obs.shape == (2, 55)
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.hardware.motors import Motors
from jiminy_tpu_torch.models import make_cartpole

eng = Engine(make_cartpole(device="cpu"), EngineOptions(contact_model="constraint"),
             motors=Motors.create([0], effort_limit=30.0, device="cpu"), device="cpu")
sim = eng.step(eng.reset(torch.tensor([[2.399, 0.1], [-1.0, -0.1]])), torch.full((2, 1), 30.0),
               n_substeps=20)
assert eng.backend == "substep" and float(sim.q[0, 0]) <= 2.4 + 1e-3
env = ANYmalEnv(observe="state", engine_options=EngineOptions(dt=1e-3), device="cpu")
st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.zeros(2, 12))
assert not env.engine.impulse and bool(torch.isfinite(st.sim.q).all())  # penalty contacts
from jiminy_tpu_torch.envs import CartPoleEnv

env = CartPoleEnv(device="cpu")
st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.ones(2, dtype=torch.long))
assert st.obs.shape == (2, 4) and bool(torch.isfinite(st.obs).all())
from jiminy_tpu_torch.rl import PPOConfig, evaluate, greedy_policy, make_train_fn

env = ANYmalEnv(observe="state", device="cpu")
cfg = PPOConfig(num_envs=2, rollout_len=2, minibatches=2, epochs=1, hidden=(8, 8),
                symmetry_coef=0.1)
init_fn, train_step, policy = make_train_fn(env, cfg, symmetry_fn=env.symmetry_fn)
carry, metrics = train_step(init_fn(0, 2))
assert all(bool(torch.isfinite(v)) for v in metrics.values())
stats = evaluate(env, greedy_policy(policy, carry[0]), n_envs=2, n_steps=1)
assert stats["length_mean"] == 1.0 and stats["fall_fraction"] == 0.0
from jiminy_tpu_torch.envs import anymal_declarative_mdp, build_pipeline

r, t = anymal_declarative_mdp()
env = build_pipeline(ANYmalEnv(sensor_delay=0.004, reward_fn=r, termination_fn=t, device="cpu"),
                     [{"type": "mahony"}, {"type": "stack", "n": 4}, {"type": "normalize"}])
st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.zeros(2, 12))
assert st.obs.shape == (2, 148) and bool(torch.isfinite(st.obs).all())
from jiminy_tpu_torch.envs.locomotion import WalkerEnv
from jiminy_tpu_torch.models import stand_q
from jiminy_tpu_torch.robot import build_robot

robot = build_robot("data/anymal.urdf", "data/anymal_hardware.toml", freeflyer=True, device="cpu")
env = WalkerEnv(robot, stand_pose=stand_q(robot.tree), observe="state", device="cpu")
st = env.step(env.reset(torch.Generator().manual_seed(0), 2), torch.zeros(2, 12))
assert env.engine.nc == 24 and bool(torch.isfinite(st.obs).all())
import tempfile
from pathlib import Path

from jiminy_tpu_torch.io.serialization import build_robot_from_log
from jiminy_tpu_torch.plot import export_html
from jiminy_tpu_torch.simulator import Simulator
from jiminy_tpu_torch.telemetry import read_log
from jiminy_tpu_torch.utils.pcg_torch import pcg32_init, pcg32_next

sim = Simulator(robot, EngineOptions(dt=5e-3, contact_model="constraint", pgs_iters=8),
                device="cpu")
final, log = sim.simulate(0.01, q0=stand_q(robot.tree))
with tempfile.TemporaryDirectory() as d:
    log.write_binary(Path(d) / "run.jtpu")
    back = read_log(Path(d) / "run.jtpu")
    export_html(back, Path(d) / "report.html")
assert len(back) == 2 and build_robot_from_log(back, device="cpu").tree.nq == 19
assert sim.render(size=64).shape == (64, 64, 3)
assert int(pcg32_next(pcg32_init(42, device="cpu"))[1]) >= 0
leaked = sorted(k for k in sys.modules if k.partition(".")[0] in BLOCKED)
assert not leaked, leaked
print("NO_JAX_OK", len(mods))
"""


def test_port_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
    assert int(r.stdout.split("NO_JAX_OK")[1]) >= 20  # every port module walked


def test_kernel_modules_import_first():
    for mod in ("jiminy_tpu_torch.ops.substep_kernel", "jiminy_tpu_torch.ops.constraint_solve",
                "jiminy_tpu_torch.ops"):
        r = subprocess.run(
            [sys.executable, "-c", f"import {mod}"],
            capture_output=True, text=True, cwd=REPO, timeout=300,
        )
        assert r.returncode == 0, mod + "\n" + r.stderr
