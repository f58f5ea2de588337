"""The port's plain multi-substep version against the reference's fused
Pallas kernel itself.

``substep_multi_reference`` (the plain version of the port's K2) and
jiminy_tpu's ``substep_batched_pallas_multi`` run in interpret mode, as
tests/test_substep_multi.py runs it on the CPU: ANYmal, B = 4, 4
substeps with PD (kp 60, kd 2) and a nonzero root wrench, from the same
numpy-made states. Tolerances are tests/test_substep_multi.py's own
(q 1e-4, v 1e-2, a 2.0, τ 1e-2 with their rtol; contact impulses 5e-3 of
their largest). The interpreted kernel takes ~45 s here, so this file
holds this one test alone.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from jiminy_tpu.engine.engine import Engine as JEngine
from jiminy_tpu.engine.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.engine import PDController as JPDController
from jiminy_tpu.models.quadruped import make_anymal as j_make_anymal
from jiminy_tpu.models.quadruped import stand_q as j_stand_q
from jiminy_tpu.ops.substep_kernel import substep_batched_pallas_multi
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine import Engine, EngineOptions, PDController
from jiminy_tpu_torch.hardware.motors import motors_from_arrays
from jiminy_tpu_torch.ops.substep_kernel import substep_multi_reference

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

B, N_SUB, DT = 4, 4, 5e-3
MOTOR_FIELDS = (
    "v_idx", "q_idx", "name", "reduction", "effort_limit", "velocity_limit",
    "friction_dry", "friction_viscous", "friction_vel_eps",
)


def test_multi_reference_matches_pallas_kernel():
    jrobot = j_make_anymal()
    jeng = JEngine(
        jrobot.tree,
        JEngineOptions(contact_model="constraint", constraint_solver="pallas_substep",
                       dt=DT, pgs_iters=4, compute_solver_residual=True),
        motors=jrobot.motors,
        controller=JPDController(60.0, 2.0),
    )
    tree = tree_from_arrays(
        {k: np.asarray(getattr(jrobot.tree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS},
        device="cpu",
    )
    motors = motors_from_arrays(
        {k: np.asarray(getattr(jrobot.motors, k)) for k in MOTOR_FIELDS}, device="cpu"
    )
    eng = Engine(
        tree, EngineOptions(contact_model="constraint", dt=DT, pgs_iters=4,
                            compute_solver_residual=True),
        motors=motors, controller=PDController(60.0, 2.0), device="cpu",
    )

    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(j_stand_q(jrobot.tree)), (B, 1)).astype(np.float64)
    q[:, 7:] += rng.uniform(-0.1, 0.1, (B, 12))
    q[:, 2] += rng.uniform(-0.015, 0.005, B)
    quat = np.concatenate([rng.uniform(-0.03, 0.03, (B, 3)), np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = 0.2 * rng.standard_normal((B, 18))
    lam = np.abs(0.05 * rng.standard_normal((B, 24)))
    cmd = q[:, 7:] + rng.uniform(-0.2, 0.2, (B, 12))
    wrench = np.concatenate([3.0 * rng.standard_normal((B, 3)), 15.0 * rng.standard_normal((B, 3))], 1)
    arrays = [a.astype(np.float32) for a in (q, v, cmd, lam, wrench)]

    ref = substep_batched_pallas_multi(
        jeng._substep_spec, N_SUB, *(jnp.asarray(a) for a in arrays[:4]),
        wrench=jnp.asarray(arrays[4]), interpret=True,
    )
    out = substep_multi_reference(eng.substep_spec, N_SUB, *(torch.as_tensor(a) for a in arrays))
    rq, rv, rlam, rres, rfc, ra, rtau = (np.asarray(x) for x in ref)
    q2, v2, lam2, res2, fc2, a2, tau2 = (x.numpy() for x in out)
    assert np.abs(rlam).max() > 0.05  # contacts and bounds engaged
    np.testing.assert_allclose(q2, rq, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(v2, rv, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(a2, ra, atol=2.0, rtol=1e-2)
    np.testing.assert_allclose(tau2, rtau, atol=1e-2, rtol=1e-3)
    scale = max(1.0, float(np.max(np.abs(rfc))))
    np.testing.assert_allclose(fc2 / scale, rfc / scale, atol=5e-3)
