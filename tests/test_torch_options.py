"""The Engine's options and conveniences, and the ``_fused_sensors``
repair, against jiminy_tpu's.

- ``BaseEnv._fused_sensors`` is a property read at every step, as the
  reference's (``envs/base.py:115-133``): after
  ``engine.set_options({"substep_fusion": False})`` the port's sensor env
  says False as the reference's does (its engine on ``"pallas_substep"``,
  whose sensor fusion is what the option turns off; no reference program
  compiles for it), and one env step is then the chunked step, bit for
  bit the port's chunked step forced by ``_fused_sensors = False``, which
  ``tests/test_torch_sensor_env.py`` holds against the reference's
  chunked step within its tolerances (so this file compiles no second
  ~45 s ANYmal program for the same comparison); after
  ``{"substep_fusion": True}`` both say True again, and the step is the
  fused one, bit for bit.
- ``get_options`` / ``set_options`` (dt, pgs_iters, the contact model,
  the contacts sub-dict): the port's options dict equals the reference's
  after the same updates (the backend named in each package's words), and
  a step of the changed engine equals a freshly built one's bit for bit.
- ``reset()`` gives the neutral state; ``n_constraint_rows`` equals the
  reference's on ANYmal (state path and penalty contacts), Cassie and
  Atlas with its pairs (static: nothing compiles); ``Engine.simulate`` on
  the pendulum against the reference's within 1e-5 (float32).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JOptions
from jiminy_tpu.engine.ground import FlatGround as JFlat
from jiminy_tpu.envs import AtlasEnv as JAtlas
from jiminy_tpu.envs import CassieEnv as JCassie
from jiminy_tpu.envs.anymal import ANYmalEnv as JANYmalEnv
from jiminy_tpu.models.toys import make_pendulum as jmake_pendulum
from jiminy_tpu_torch.engine import Engine, EngineOptions
from jiminy_tpu_torch.engine.ground import FlatGround
from jiminy_tpu_torch.envs import ANYmalEnv, AtlasEnv, CassieEnv
from jiminy_tpu_torch.models.toys import make_free_box, make_pendulum

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

KW = dict(step_dt=0.02, sim_dt=5e-3, pgs_iters=8, sensor_delay=0.004)
B = 4
# the reference's backend names for the port's
SOLVER_NAMES = {"inline": "xla", "kernel": "pallas", "substep": "pallas_substep", "auto": "auto"}


def test_fused_sensors_follows_set_options():
    jenv = JANYmalEnv(observe="sensors", engine_options=JOptions(
        dt=5e-3, contact_model="constraint", pgs_iters=8, compute_solver_residual=False,
        constraint_solver="pallas_substep"), sensor_delay=0.004)
    env = ANYmalEnv(observe="sensors", device="cpu", **KW)
    assert env._fused_sensors and jenv._fused_sensors
    st = env.reset(torch.Generator().manual_seed(0), B)
    action = torch.as_tensor(np.random.default_rng(0).uniform(-1.2, 1.2, (B, 12)),
                             dtype=torch.float32)
    for fusion in (False, True):
        env.engine.set_options({"substep_fusion": fusion})
        jenv.engine.set_options({"substep_fusion": fusion})
        assert env._fused_sensors == jenv._fused_sensors == fusion
        # the step is the path the flag names: bit for bit an env whose
        # path is forced by the opt-out
        other = ANYmalEnv(observe="sensors", device="cpu", **KW)
        other._fused_sensors = fusion
        a, b = env.step_no_reset(st, action), other.step_no_reset(st, action)
        for x, y in ((a.sim.q, b.sim.q), (a.sim.v, b.sim.v),
                     (a.info["sensor_bufs"], b.info["sensor_bufs"]), (a.obs, b.obs)):
            assert torch.equal(x, y)
    # the opt-out keeps working beside the options
    env._fused_sensors = False
    assert not env._fused_sensors
    env._fused_sensors = True
    assert env._fused_sensors


def _options_dict(opts: dict) -> dict:
    """An options dict with JAX scalars as floats and the backend in the
    reference's words."""
    out = {k: v for k, v in opts.items() if k != "contacts"}
    out["contacts"] = {k: float(np.asarray(v)) for k, v in opts["contacts"].items()}
    out["constraint_solver"] = SOLVER_NAMES.get(out["constraint_solver"],
                                                out["constraint_solver"])
    return out


UPDATES = [{"dt": 2e-3}, {"pgs_iters": 3}, {"contact_model": "constraint"},
           {"contacts": {"friction": 0.5}},
           {"dt": 2.5e-3, "pgs_iters": 12, "contacts": {"stiffness": 2e4, "damping": 50.0}}]


@pytest.mark.parametrize("updates", UPDATES, ids=lambda u: ",".join(u))
def test_set_options_matches_reference_and_fresh_engine(updates):
    base = dict(contact_model="constraint", pgs_iters=8, dt=1e-3)
    eng = Engine(make_free_box(device="cpu"), EngineOptions(**base), device="cpu")
    jeng = JEngine(_jfree_box(), JOptions(**base))
    eng.set_options(updates)
    jeng.set_options(dict(updates))
    got, want = _options_dict(eng.get_options()), _options_dict(jeng.get_options())
    assert got.keys() == want.keys()
    for k in want:
        if k == "contacts":
            for c in want[k]:
                assert got[k][c] == pytest.approx(want[k][c], rel=1e-7), (k, c)
        else:
            assert got[k] == want[k], k
    assert eng.n_constraint_rows == jeng.n_constraint_rows
    # the changed engine steps as a freshly built one, bit for bit
    contacts = {**dataclasses.asdict(EngineOptions().contacts), **updates.get("contacts", {})}
    opts = dataclasses.replace(EngineOptions(**base), **{k: v for k, v in updates.items()
                                                         if k != "contacts"})
    from jiminy_tpu_torch.engine.contact import ContactParams

    fresh = Engine(make_free_box(device="cpu"),
                   dataclasses.replace(opts, contacts=ContactParams(**contacts)), device="cpu")
    assert fresh.options == eng.options and fresh.backend == eng.backend
    q0 = torch.as_tensor(eng.tree.neutral_q())[None].repeat(2, 1)
    q0[:, 2] = torch.tensor([0.08, 0.12])
    a = eng.step(eng.reset(q0), torch.zeros(2, 6), n_substeps=3)
    b = fresh.step(fresh.reset(q0), torch.zeros(2, 6), n_substeps=3)
    for f in ("t", "q", "v", "lam"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_set_options_switches_the_contact_model():
    eng = Engine(make_free_box(device="cpu"), EngineOptions(), device="cpu")
    assert not eng.impulse and eng.n_constraint_rows == 0
    eng.set_options({"contact_model": "constraint"})
    assert eng.impulse and eng.n_constraint_rows == eng.nc == 24
    eng.set_options({"contact_model": "spring_damper"})
    assert not eng.impulse and eng.n_constraint_rows == 0 and eng.contact_m_eff is not None


def _jfree_box():
    from tests.test_constraints import make_free_box as jmake_free_box

    return jmake_free_box()


def test_reset_gives_the_neutral_state():
    eng = Engine(make_free_box(device="cpu"), EngineOptions(contact_model="constraint"),
                 device="cpu")
    jst = JEngine(_jfree_box(), JOptions(contact_model="constraint")).reset()
    for B in (1, 3):
        st = eng.reset(batch_size=B)
        for f in ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau"):
            want = np.broadcast_to(np.asarray(getattr(jst, f)), getattr(st, f).shape)
            np.testing.assert_array_equal(getattr(st, f).numpy(), want, err_msg=f)


@pytest.mark.parametrize("name", ["anymal", "anymal_penalty", "cassie", "atlas_pairs"])
def test_n_constraint_rows_matches_reference(name):
    if name == "anymal":
        port, ref = ANYmalEnv(observe="state", device="cpu"), JANYmalEnv(observe="state")
    elif name == "anymal_penalty":
        port = ANYmalEnv(observe="state", engine_options=EngineOptions(dt=1e-3), device="cpu")
        ref = JANYmalEnv(observe="state", engine_options=JOptions(dt=1e-3))
    elif name == "cassie":
        port = CassieEnv(sim_dt=2e-3, observe="state", device="cpu")
        ref = JCassie(sim_dt=2e-3, observe="state")
    else:
        port = AtlasEnv(observe="state", self_collision=True, device="cpu")
        ref = JAtlas(observe="state", self_collision=True)
    want = {"anymal": 24, "anymal_penalty": 0, "cassie": 28, "atlas_pairs": 83}[name]
    assert port.engine.n_constraint_rows == ref.engine.n_constraint_rows == want


def test_simulate_matches_reference_on_the_pendulum():
    """Engine.simulate under a PD controller on the continuous path (the
    bob out of the ground's reach), t, q and v at every control step."""
    jeng = JEngine(jmake_pendulum(), JOptions(dt=1e-3), ground=JFlat(height=jnp.float32(-10.0)))
    eng = Engine(make_pendulum(device="cpu"), EngineOptions(dt=1e-3),
                 ground=FlatGround(height=-10.0), device="cpu")
    jfinal, jlog = jeng.simulate(jeng.reset(q=jnp.array([0.8])), 0.2,
                                 controller=lambda q, v, t: -3.0 * q - 0.5 * v, control_dt=4e-3)
    final, log = eng.simulate(eng.reset(torch.tensor([[0.8]])), 0.2,
                              controller=lambda q, v, t: -3.0 * q - 0.5 * v, control_dt=4e-3)
    assert log["q"].shape == (50, 1, 1)
    for k in ("t", "q", "v"):
        np.testing.assert_allclose(log[k][:, 0], np.asarray(jlog[k]).reshape(log[k][:, 0].shape),
                                   atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(final.q[0].numpy(), np.asarray(jfinal.q), atol=1e-5, rtol=0)
