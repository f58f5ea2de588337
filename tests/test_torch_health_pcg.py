"""Health checks, PCG32, the periodic processes, the checkpoint manager's
partial restore and the left-out public functions (A.25), against
jiminy_tpu's.

- ``state_flags`` / ``is_bad_state`` on a batch of states with NaN and
  infinite q, NaN, huge and healthy v and bad residuals: the reference's
  per-state flags (vmapped) bit for bit; ``checkify_fn`` raises with the
  reference's message for each failed check and path; ``debug_nans``
  raises FloatingPointError at the operation that makes the NaN, named as
  the reference names it.
- The PCG32 stream on batched int64 tensors: bit for bit ``pcg_jax``'s
  and the host ``PCG32``'s (the C++ reference's stream, its six known
  draws), and ``pcg32_uniform`` within one float32 ulp of ``pcg_jax``'s
  (XLA fuses its multiply-add).
- ``PeriodicGaussianProcess`` and ``PeriodicFourierProcess`` within 1e-12.
- ``CheckpointManager.restore(partial=True)`` takes the entries that the
  template and the file share; ``close``.
- A.25 in float64 within 1e-9: ``so3.quat_rotate`` and
  ``quat_rotate_inv``, ``Motors.command_from_joint``, ``SensorSuite.names``,
  ``ModelParams.apply_to_motors``, ``PDController.bind``, and
  ``algos.frame_kinematics`` and ``difference``, on ANYmal built from
  ``data/anymal.urdf`` by both packages.

The reference runs eagerly (its PCG32 draws under one small jit).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu.core import algos as jalgos
from jiminy_tpu.engine.engine import PDController as JPD
from jiminy_tpu.engine.engine import SimState as JSimState
from jiminy_tpu.engine.randomization import ModelParams as JModelParams
from jiminy_tpu.math import so3 as jso3
from jiminy_tpu.robot import build_robot as jbuild_robot
from jiminy_tpu.utils import health as jhealth
from jiminy_tpu.utils import pcg_jax
from jiminy_tpu.utils import random as jrandom
from jiminy_tpu_torch.checkpoint import CheckpointManager
from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.engine import PDController
from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.engine.randomization import ModelParams
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.robot import build_robot
from jiminy_tpu_torch.utils import health, random
from jiminy_tpu_torch.utils.pcg_torch import pcg32_init, pcg32_next, pcg32_uniform

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "data"
F64 = dict(dtype=torch.float64)


def _states():
    """Six states (nq 2, nv 2): healthy, NaN q, inf q, NaN v, huge v, and
    a residual past its limit with a huge v."""
    q = np.zeros((6, 2))
    v = np.full((6, 2), 0.5)
    res = np.zeros(6)
    q[1, 0], q[2, 1], v[3, 1], v[4, 0] = np.nan, np.inf, np.nan, 2e4
    res[5], v[5, 1] = 2e6, -3e4
    return q, v, res


def test_state_flags_match_reference():
    q, v, res = _states()
    port = SimState(t=torch.zeros(6), q=torch.as_tensor(q), v=torch.as_tensor(v),
                    contact_forces=torch.zeros(6, 0, 3), solver_residual=torch.as_tensor(res),
                    lam=torch.zeros(6, 0), a=torch.zeros(6, 2), tau=torch.zeros(6, 2))
    flags = health.state_flags(port)
    want = [int(jhealth.state_flags(JSimState(t=0.0, q=jnp.asarray(q[i]), v=jnp.asarray(v[i]),
                                              contact_forces=None,
                                              solver_residual=jnp.asarray(res[i]))))
            for i in range(6)]
    assert flags.dtype == torch.int32 and flags.tolist() == want == [0, 1, 1, 2, 4, 12]
    assert health.is_bad_state(port).tolist() == [w != 0 for w in want]
    assert (health.NONFINITE_Q, health.NONFINITE_V, health.VEL_EXPLOSION,
            health.RESIDUAL_BLOWUP) == (jhealth.NONFINITE_Q, jhealth.NONFINITE_V,
                                        jhealth.VEL_EXPLOSION, jhealth.RESIDUAL_BLOWUP)


def _sim(q, v):
    return SimState(t=torch.zeros(1), q=torch.as_tensor(q)[None], v=torch.as_tensor(v)[None],
                    contact_forces=torch.zeros(1, 0, 3), solver_residual=torch.zeros(1),
                    lam=torch.zeros(1, 0), a=torch.zeros(1, 2), tau=torch.zeros(1, 2))


def _jsim(q, v):
    return JSimState(t=jnp.float32(0.0), q=jnp.asarray(q, jnp.float32),
                     v=jnp.asarray(v, jnp.float32), contact_forces=jnp.zeros((0, 3)),
                     solver_residual=jnp.float32(0.0), lam=jnp.zeros(0), a=jnp.zeros(2),
                     tau=jnp.zeros(2))


@pytest.mark.parametrize("case", ["healthy", "nan_q", "nan_v", "huge_v"])
@pytest.mark.parametrize("wrap", ["bare", "tuple", "dict"])
def test_checkify_messages_match_reference(case, wrap):
    q, v = np.array([0.1, 0.2]), np.array([0.3, -0.4])
    if case == "nan_q":
        q[1] = np.nan
    elif case == "nan_v":
        v[0] = np.nan
    elif case == "huge_v":
        v[1] = 5e4
    shape = {"bare": lambda s: s, "tuple": lambda s: (1.0, s), "dict": lambda s: {"sim": s}}[wrap]
    err, _ = jhealth.checkify_fn(shape)(_jsim(q, v))
    checked = health.checkify_fn(shape)
    if case == "healthy":
        err.throw()
        assert checked(_sim(q, v)) is not None
        return
    with pytest.raises(Exception) as ref:
        err.throw()
    with pytest.raises(ValueError) as got:
        checked(_sim(q, v))
    assert str(got.value) in str(ref.value), (str(got.value), str(ref.value))


def test_debug_nans_names_the_operation():
    with health.debug_nans():
        x = torch.tensor([1.0, 2.0])
        y = torch.exp(x)  # finite: no error
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(y - 10.0)
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # off again outside the block
    with health.debug_nans(enable=False):
        torch.log(torch.tensor(-1.0))
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError, match="log"):
            jnp.log(jnp.exp(jnp.array([1.0, 2.0])) - 10.0).block_until_ready()


def test_pcg32_stream_bit_for_bit():
    st = pcg32_init(42, 54, device="cpu")
    got = []
    for _ in range(6):
        st, u = pcg32_next(st)
        got.append(int(u))
    assert got == [0xA15C02B7, 0x7B47F409, 0xBA1D3330, 0x83D2F293, 0xBFA4784B, 0xCBED606E]
    seeds = np.array([0, 1, 7, 123456789, 2**32 - 1, 2**31 + 5], np.uint32)

    @jax.jit
    def draws(seed):
        s = pcg_jax.pcg32_init(seed, 3)
        outs, unis = [], []
        for _ in range(20):
            s, u = pcg_jax.pcg32_next(s)
            outs.append(u)
        for _ in range(5):
            s, x = pcg_jax.pcg32_uniform(s, -2.0, 3.0)
            unis.append(x)
        return jnp.stack(outs), jnp.stack(unis)

    want, want_u = jax.vmap(draws)(jnp.asarray(seeds))
    st = pcg32_init(torch.as_tensor(seeds.astype(np.int64)), 3, device="cpu")
    outs, unis = [], []
    for _ in range(20):
        st, u = pcg32_next(st)
        outs.append(u)
    for _ in range(5):
        st, x = pcg32_uniform(st, -2.0, 3.0)
        unis.append(x)
    np.testing.assert_array_equal(torch.stack(outs, 1).numpy(), np.asarray(want, np.int64))
    # the float32 map lo + (hi − lo)·u/2³²: XLA contracts it to one fused
    # multiply-add, so the two agree within one float32 ulp at |x| ≤ 3
    np.testing.assert_allclose(torch.stack(unis, 1).numpy(), np.asarray(want_u),
                               atol=float(np.spacing(np.float32(3.0))), rtol=0)
    host = jrandom.PCG32(7, 3)
    st = pcg32_init(7, 3, device="cpu")
    for _ in range(20):
        st, u = pcg32_next(st)
        assert int(u) == host.uint32()


@pytest.mark.parametrize("kind", ["gaussian", "fourier"])
def test_periodic_processes_match_reference(kind):
    t = np.linspace(-1.0, 3.0, 101)
    if kind == "gaussian":
        a, b = (random.PeriodicGaussianProcess(5, 0.3, 2.0),
                jrandom.PeriodicGaussianProcess(5, 0.3, 2.0))
    else:
        a, b = random.PeriodicFourierProcess(9, 1.5), jrandom.PeriodicFourierProcess(9, 1.5)
    np.testing.assert_allclose(a(t), b(t), atol=1e-12, rtol=0)
    np.testing.assert_allclose(a(t), a(t + a.period), atol=1e-12, rtol=0)


def test_checkpoint_partial_restore_and_close(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    saved = {"params": {"w": torch.arange(4.0), "b": torch.ones(2)}, "old": torch.zeros(3),
             "iter": 7}
    mgr.save(3, saved)
    template = {"params": {"w": torch.zeros(4), "b": torch.zeros(2), "new": torch.full((2,), 5.0)},
                "opt": torch.full((1,), 9.0), "iter": 0}
    got = mgr.restore(template, partial=True)
    assert torch.equal(got["params"]["w"], saved["params"]["w"])
    assert torch.equal(got["params"]["b"], saved["params"]["b"])
    assert torch.equal(got["params"]["new"], template["params"]["new"])
    assert torch.equal(got["opt"], template["opt"]) and got["iter"] == 7 and "old" not in got
    with pytest.raises(ValueError):
        mgr.restore(template)  # whole restore: the structures differ
    with pytest.raises(ValueError):  # a shared entry must still match its shape
        mgr.restore({"params": {"w": torch.zeros(5)}}, partial=True)
    mgr.close()


@pytest.fixture(scope="module")
def anymal():
    urdf, hw = DATA / "anymal.urdf", DATA / "anymal_hardware.toml"
    return (build_robot(urdf, hw, freeflyer=True, device="cpu", dtype=torch.float64),
            jbuild_robot(urdf, hw, freeflyer=True))


def _q(rng, tree, B):
    q = np.tile(np.asarray(tree.neutral_q(), np.float64), (B, 1))
    q[:, :3] = rng.normal(size=(B, 3))
    quat = rng.normal(size=(B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-1.0, 1.0, (B, tree.nq - 7))
    return q


def test_a25_functions_match_reference(anymal):
    robot, jrobot = anymal
    rng = np.random.default_rng(4)
    B = 5
    with jax.enable_x64(True):
        quat = rng.normal(size=(B, 4))
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        vec = rng.normal(size=(B, 3))
        for fn, jfn in ((so3.quat_rotate, jso3.quat_rotate),
                        (so3.quat_rotate_inv, jso3.quat_rotate_inv)):
            want = np.stack([np.asarray(jfn(jnp.asarray(quat[i]), jnp.asarray(vec[i])))
                             for i in range(B)])
            got = fn(torch.as_tensor(quat), torch.as_tensor(vec)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        motors, jmotors = robot.motors, jrobot.motors
        tau = rng.normal(size=(B, motors.nm))
        np.testing.assert_allclose(
            motors.command_from_joint(torch.as_tensor(tau)).numpy(),
            np.stack([np.asarray(jmotors.command_from_joint(jnp.asarray(x))) for x in tau]),
            atol=1e-9, rtol=0)
        for typ in ("imu", "encoder", "effort", "contact", "force"):
            assert robot.sensors.names(typ) == jrobot.sensors.names(typ), typ
        assert robot.sensors.names("encoder")
        # ModelParams.apply_to_motors: each env's gains and friction scales
        gain, fric = rng.uniform(0.8, 1.2, (B, motors.nm)), rng.uniform(0.5, 1.5, (B, motors.nm))
        mp = ModelParams.nominal(robot.tree, motors, B)
        mp = ModelParams(mp.mass_scale, mp.com_offset, mp.inertia_scale, mp.armature_scale,
                         torch.as_tensor(gain), torch.as_tensor(fric))
        pm = mp.apply_to_motors(motors)
        for i in range(B):
            jmp = JModelParams.nominal(jrobot.tree, jmotors).replace(
                motor_gain=jnp.asarray(gain[i]), motor_friction_scale=jnp.asarray(fric[i]))
            jm = jmp.apply_to_motors(jmotors)
            for k in ("reduction", "friction_dry", "friction_viscous", "effort_limit"):
                np.testing.assert_allclose(
                    np.broadcast_to(getattr(pm, k).numpy(), (B, motors.nm))[i],
                    np.asarray(getattr(jm, k)), atol=1e-9, rtol=0, err_msg=k)
        assert mp.apply_to_motors(None) is None
        # PDController.bind
        tree = robot.tree
        q, v = _q(rng, tree, B), rng.normal(size=(B, tree.nv))
        cmd = rng.normal(size=(B, motors.nm))
        kp, kd = rng.uniform(50, 100, motors.nm), 2.0
        got = PDController(torch.as_tensor(kp), kd).bind(motors)(
            torch.as_tensor(cmd), torch.as_tensor(q), torch.as_tensor(v))
        jfn = JPD(kp, kd).bind(jmotors)
        want = np.stack([np.asarray(jfn(jnp.asarray(cmd[i]), jnp.asarray(q[i]),
                                        jnp.asarray(v[i]), 0.0)) for i in range(B)])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
        # algos.frame_kinematics and difference
        jtree = jrobot.tree
        xw, vel = algos.kinematics(tree, torch.as_tensor(q), torch.as_tensor(v))
        poses, lvs = algos.frame_kinematics(tree, xw, vel)
        q2 = _q(rng, tree, B)
        dq = algos.difference(tree, torch.as_tensor(q), torch.as_tensor(q2)).numpy()
        for i in range(B):
            jxw, jvel = jalgos.kinematics(jtree, jnp.asarray(q[i]), jnp.asarray(v[i]))
            jposes, jlvs = jalgos.frame_kinematics(jtree, jxw, jvel)
            assert len(poses) == len(jposes) == tree.nf
            for p, jp, lv, jlv in zip(poses, jposes, lvs, jlvs):
                np.testing.assert_allclose(p.rot[i].numpy(), np.asarray(jp.rot), atol=1e-9, rtol=0)
                np.testing.assert_allclose(p.pos[i].numpy(), np.asarray(jp.pos), atol=1e-9, rtol=0)
                np.testing.assert_allclose(lv[i].numpy(), np.asarray(jlv), atol=1e-9, rtol=0)
            np.testing.assert_allclose(
                dq[i], np.asarray(jalgos.difference(jtree, jnp.asarray(q[i]), jnp.asarray(q2[i]))),
                atol=1e-9, rtol=0)
        # difference inverts integrate on the manifold
        back = algos.integrate(tree, torch.as_tensor(q), torch.as_tensor(dq), 1.0)
        np.testing.assert_allclose(back[:, 7:].numpy(), q2[:, 7:], atol=1e-9, rtol=0)
        sign = np.sign(back[:, 6].numpy() * q2[:, 6])[:, None]
        np.testing.assert_allclose(back[:, 3:7].numpy() * sign, q2[:, 3:7], atol=1e-9, rtol=0)
        assert algos.frame_kinematics(tree, xw)[1] is None
