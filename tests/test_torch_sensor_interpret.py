"""The port's plain multi-substep version with the sensor stage against
the reference's fused Pallas kernel with ``spec.sensors``.

``substep_multi_reference(..., sensors=...)`` (the plain version of the
port's K2 with its sensor stage) and jiminy_tpu's
``substep_batched_pallas_multi`` with a ``SensorKernelSpec`` attached to
its substep spec (as ``Engine._get_sensor_spec`` attaches it) run in
interpret mode on the CPU: ANYmal with the flagship's suite (delay
0.004 s, IMU noise 0.02, encoder noise 0.005), B = 3, 4 substeps with PD
(kp 80, kd 2), one sensor update after each, from the same numpy-made
states, ring buffers and eps. Tolerances are
tests/test_torch_substep_interpret.py's (q 1e-4, v 1e-2, τ 1e-2 with
their rtol) and, for the buffers, tests/test_sensor_kernel.py's scaling
(each group divided by max(1, its largest magnitude)) at 1e-4. The
interpreted kernel takes ~55 s here, so this file holds this one test
alone.
"""

from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu.ops.substep_kernel import SensorKernelSpec as JSensorKernelSpec
from jiminy_tpu.ops.substep_kernel import substep_batched_pallas_multi
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.models.quadruped import make_anymal
from jiminy_tpu_torch.ops.substep_kernel import SensorKernelSpec, substep_multi_reference

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B, N_SUB, DT = 3, 4, 5e-3
SENSORS = dict(sensor_period=DT, sensor_delay=0.004, imu_noise=0.02, encoder_noise=0.005)


def test_sensor_multi_reference_matches_pallas_kernel():
    jrobot = j_make_anymal(**SENSORS)
    jeng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="pallas_substep",
                       dt=DT, pgs_iters=8, compute_solver_residual=False),
        motors=jrobot.motors, controller=JPDController(80.0, 2.0),
    )
    jspec = copy.copy(jeng._substep_spec)
    jspec.sensors = JSensorKernelSpec(jrobot.tree, jrobot.sensors, 1)
    tree, motors, suite = make_anymal(device="cpu", **SENSORS)
    eng = Engine(tree, EngineOptions(contact_model="constraint", dt=DT, pgs_iters=8,
                                     compute_solver_residual=False),
                 motors=motors, controller=PDController(80.0, 2.0), device="cpu")
    sens = SensorKernelSpec(eng.tree, suite, 1)
    assert (sens.n_buf, sens.n_eps) == (jspec.sensors.n_buf, jspec.sensors.n_eps) == (150, 57)

    rng = np.random.default_rng(12)
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (B, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.1, 0.1, (B, 12))
    q[:, 2] += rng.uniform(-0.015, 0.005, B)
    quat = np.concatenate([rng.uniform(-0.03, 0.03, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = 0.2 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    cmd = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate([3.0 * rng.standard_normal((B, 3)), 15.0 * rng.standard_normal((B, 3))], 1)
    bufs = rng.standard_normal((B, sens.n_buf))
    eps = 0.02 * rng.standard_normal((B, N_SUB * sens.n_eps))
    arrays = [a.astype(np.float32) for a in (q, v, cmd, lam, wrench, bufs, eps)]

    ref = substep_batched_pallas_multi(
        jspec, N_SUB, *(jnp.asarray(a) for a in arrays[:4]), wrench=jnp.asarray(arrays[4]),
        bufs=jnp.asarray(arrays[5]), eps=jnp.asarray(arrays[6]), interpret=True,
    )
    t = [torch.as_tensor(a) for a in arrays]
    out = substep_multi_reference(eng.substep_spec, N_SUB, *t[:5], sensors=sens,
                                  bufs=t[5], eps=t[6])
    rq, rv, rlam, _, _, _, rtau, rbufs = (np.asarray(x) for x in ref)
    q2, v2, lam2, _, _, _, tau2, bufs2 = (x.numpy() for x in out)
    assert np.abs(rlam).max() > 0.05  # contacts and bounds engaged
    np.testing.assert_allclose(q2, rq, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(v2, rv, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(tau2, rtau, atol=1e-2, rtol=1e-3)
    o = 0
    for g in suite.groups:
        n = g.ns * g.buf_len * g.dim
        scale = max(1.0, float(np.abs(rbufs[:, o:o + n]).max()))
        np.testing.assert_allclose(bufs2[:, o:o + n] / scale, rbufs[:, o:o + n] / scale,
                                   atol=1e-4, rtol=0, err_msg=g.type)
        o += n
    # every slot moved: 4 pushes into 2- and 3-slot lines
    assert (np.abs(bufs2 - arrays[5]).min(axis=1) > 0).all()
