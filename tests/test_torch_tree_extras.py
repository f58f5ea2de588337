"""The tree pieces that go with the builders, and ``BaseEnv``'s
``observe_dt``, against jiminy_tpu.

- ``so3.rpy_to_quat`` on seeded angles, ``map_configuration`` and
  ``map_velocity`` both ways between the rigid and the flexible Atlas
  (built from ``data/atlas.urdf`` with and without the hardware's torso
  flexibility), in float64 within 1e-12 (q drawn at float32 values: the
  reference writes into its float32 neutral pose).
- ``TreeBuilder.insert_backlash``: the reference's ``TestBacklash``
  topology, and the tree field for field against the reference's.
- The backlash pendulum (a link on a PD-held pivot behind a play of 0.2
  rad; ``tests/test_steppers_extras.py``), 200 substeps of 1 ms on the
  impulse engine from q = (0, 0.5), in float64 within 1e-9 of the
  reference's engine (``"xla"``), the backlash DoF bounded by its play.
- ``BaseEnv(observe_dt=)`` (ROADMAP C.8) with and without a sensor
  suite: the same ``observe_dt``, ``n_obs_updates`` and
  ``n_substeps_per_obs`` as the reference's, and the same ValueError for
  an ``observe_dt`` off the suite's period and for a step that is not a
  multiple of it.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core.tree import JointType as JJointType
from jiminy_tpu.core.tree import TreeBuilder as JTreeBuilder
from jiminy_tpu.core.tree import map_configuration as j_map_configuration
from jiminy_tpu.core.tree import map_velocity as j_map_velocity
from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.ground import FlatGround as JFlatGround
from jiminy_tpu.envs.base import BaseEnv as JBaseEnv
from jiminy_tpu.hardware.sensors import SensorSuite as JSensorSuite
from jiminy_tpu.math import so3 as j_so3
from jiminy_tpu.models.toys import make_pendulum as j_make_pendulum
from jiminy_tpu.robot import build_robot as j_build_robot
from jiminy_tpu_torch.core.tree import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    JointType,
    TreeBuilder,
    map_configuration,
    map_velocity,
    tree_from_arrays,
)
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.envs.base import BaseEnv
from jiminy_tpu_torch.hardware.sensors import SensorSuite
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.models import make_pendulum
from jiminy_tpu_torch.robot import build_robot

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "data"


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)  # the conftest fixture restores it


def test_rpy_to_quat_matches_reference(x64):
    rpy = np.random.default_rng(0).uniform(-np.pi, np.pi, (16, 3))
    got = so3.rpy_to_quat(torch.as_tensor(rpy))
    want = np.stack([np.asarray(j_so3.rpy_to_quat(jnp.asarray(r))) for r in rpy])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-12)


def test_state_maps_match_reference(x64):
    rigid_hw = tomllib.loads((DATA / "atlas_hardware.toml").read_text())
    del rigid_hw["Flexibility"]
    trees = {}
    for name, hw in (("rigid", rigid_hw), ("flexible", DATA / "atlas_hardware.toml")):
        trees[name] = (j_build_robot(DATA / "atlas.urdf", hw, freeflyer=True).tree,
                       build_robot(DATA / "atlas.urdf", hw, freeflyer=True, device="cpu").tree)
    rng = np.random.default_rng(1)
    for src, dst in (("rigid", "flexible"), ("flexible", "rigid")):
        (jsrc, psrc), (jdst, pdst) = trees[src], trees[dst]
        # float32 values: the reference fills the neutral float32 pose
        q = rng.standard_normal((3, psrc.nq)).astype(np.float32).astype(np.float64)
        v = rng.standard_normal((3, psrc.nv))
        got_q = map_configuration(psrc, pdst, torch.as_tensor(q))
        got_v = map_velocity(psrc, pdst, torch.as_tensor(v))
        assert got_q.shape == (3, pdst.nq) and got_v.dtype == torch.float64
        for i in range(3):
            np.testing.assert_allclose(
                got_q[i].numpy(), np.asarray(j_map_configuration(jsrc, jdst, jnp.asarray(q[i]))),
                rtol=0, atol=1e-12)
            np.testing.assert_allclose(
                got_v[i].numpy(), np.asarray(j_map_velocity(jsrc, jdst, jnp.asarray(v[i]))),
                rtol=0, atol=1e-12)
    assert trees["flexible"][1].nf == trees["rigid"][1].nf


def _backlash(play, builder, jtype, dtype):
    b = builder()
    b.add_body("link", -1, jtype.REVOLUTE, axis=(0, 1, 0), mass=1.0, com=(0, 0, -1.0),
               joint_name="pivot", armature=0.02)
    b.insert_backlash("pivot", play=play, armature=1e-3)
    return b.build(dtype=dtype) if builder is JTreeBuilder else b.build(device="cpu", dtype=dtype)


def test_backlash_topology_matches_reference():
    tree = _backlash(0.1, TreeBuilder, JointType, torch.float32)
    assert tree.nb == 2
    assert tree.body_name == ("link_backlash", "link")
    assert tree.joint_type == (JointType.REVOLUTE, JointType.REVOLUTE)
    assert float(tree.q_min[0]) == pytest.approx(-0.05)
    assert float(tree.q_max[0]) == pytest.approx(0.05)
    jtree = _backlash(0.1, JTreeBuilder, JJointType, jnp.float32)
    fields = STATIC_FIELDS + ARRAY_FIELDS
    want = tree_from_arrays({k: np.asarray(getattr(jtree, k)) for k in fields}, device="cpu")
    for k in STATIC_FIELDS:
        assert getattr(tree, k) == getattr(want, k), k
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tree, k).numpy(), getattr(want, k).numpy(), k)


def test_backlash_pendulum_matches_reference(x64):
    n_sub = 200
    jtree = _backlash(0.2, JTreeBuilder, JJointType, jnp.float64)
    jeng = JEngine(jtree, JEngineOptions(dt=1e-3, contact_model="constraint",
                                         constraint_solver="xla"),
                   ground=JFlatGround(height=jnp.float64(-100.0)))
    jeng.internal_dynamics = lambda q, v, t: jnp.array([0.0, 200.0 * (0.5 - q[1]) - 5.0 * v[1]])
    jst = jeng.reset(q=jnp.array([0.0, 0.5]))
    jst = jax.jit(lambda s: jeng.step(s, jnp.zeros(2), n_substeps=n_sub))(jst)

    def ctrl(q, v, t):
        return torch.stack([torch.zeros_like(q[:, 0]), 200.0 * (0.5 - q[:, 1]) - 5.0 * v[:, 1]], -1)

    tree = _backlash(0.2, TreeBuilder, JointType, torch.float64)
    eng = Engine(tree, EngineOptions(dt=1e-3, contact_model="constraint"),
                 ground=FlatGround(height=-100.0), internal_dynamics=ctrl, device="cpu")
    st = eng.reset(torch.tensor([[0.0, 0.5]], dtype=torch.float64))
    st = eng.step(st, torch.zeros(1, 2, dtype=torch.float64), n_substeps=n_sub)
    np.testing.assert_allclose(st.q[0].numpy(), np.asarray(jst.q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.v[0].numpy(), np.asarray(jst.v), rtol=0, atol=1e-9)
    assert -0.1 - 1e-3 <= float(st.q[0, 0]) < -0.05  # swung through the play to near its edge


class _JEnv(JBaseEnv):
    pass


class _Env(BaseEnv):
    pass


def _envs(observe_dt, step_dt=0.02, period=None):
    """(reference env, port env) on the pendulum, dt 1 ms, with an
    encoder suite of ``period`` (None: no suite); a ValueError's text
    where the constructor raises."""
    jtree, tree = j_make_pendulum(), make_pendulum(device="cpu")
    spec = [dict(type="encoder", name="e", target=tree.joint_name[0])]
    out = []
    for env_cls, eng, suite in (
            (_JEnv, JEngine(jtree, JEngineOptions(dt=1e-3)),
             period and JSensorSuite.build(jtree, spec, period)),
            (_Env, Engine(tree, EngineOptions(dt=1e-3), device="cpu"),
             period and SensorSuite.build(tree, spec, period))):
        try:
            env = env_cls(eng, step_dt, sensors=suite, observe_dt=observe_dt)
            out.append((env.observe_dt, env.n_obs_updates, env.n_substeps_per_obs))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("observe_dt,step_dt,period", [
    (None, 0.02, None), (0.005, 0.02, None), (None, 0.02, 0.005), (0.005, 0.02, 0.005),
    (0.01, 0.02, 0.005), (None, 0.0125, 0.005)])
def test_observe_dt_matches_reference(observe_dt, step_dt, period):
    want, got = _envs(observe_dt, step_dt, period)
    assert got == want
    if period is not None and observe_dt not in (None, period) or step_dt == 0.0125:
        assert isinstance(got, str) and "must" in got
