"""The port's viewers and ``play`` against jiminy_tpu's.

- ``extract_skeleton_frames`` on the pendulum with contact-force
  markers, ``extract_replay3d`` on ANYmal built from ``data/anymal.urdf``
  (its URDF visuals, a Fourier ground: the capture-point marker and the
  heightfield queried through each package's ground) and the payload of
  ``render_frame3d`` (the same extraction of one configuration): the same
  structure (keys, segments, names, frame indices, meshes) and the same
  numbers within 1e-6. Both round to 4 decimals (3 for the ground), so a
  number whose unrounded value sits within float rounding of a half
  step may land one step apart: at most 1 % of the numbers, by exactly
  one step of their decimal.
- The rendered frame is (H, W, 3) uint8 and shows the robot; the HTML and
  GIF writers write their files.
- ``play`` on the cartpole env from the reference's reset state under the
  same policy: the configurations and rewards within 1e-5 (float32).

Reference programs: the forward kinematics of each extraction and the
cartpole's reset and step (small programs).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_tpu import viewer as jviewer
from jiminy_tpu import viewer3d as jviewer3d
from jiminy_tpu.engine.ground import FourierGround as JFourier
from jiminy_tpu.envs.cartpole import CartPoleEnv as JCartPoleEnv
from jiminy_tpu.models.toys import make_pendulum as jmake_pendulum
from jiminy_tpu.rl.evaluate import play as jplay
from jiminy_tpu.robot import build_robot as jbuild_robot
from jiminy_tpu_torch import viewer, viewer3d
from jiminy_tpu_torch.core.tree import ARRAY_FIELDS, STATIC_FIELDS, tree_from_arrays
from jiminy_tpu_torch.engine.ground import FourierGround
from jiminy_tpu_torch.envs import CartPoleEnv, env_state_from_arrays
from jiminy_tpu_torch.models.quadruped import stand_q
from jiminy_tpu_torch.rl.evaluate import play
from jiminy_tpu_torch.robot import build_robot

# six xdist workers share the CPU: one torch thread each
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "data"


def _same_payload(got, want, step=1e-4, where="payload"):
    """Structure equal; numbers within 1e-6, or (rounding ties) exactly
    ``step`` apart in at most 1 % of them."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _same_payload(got[k], want[k], 1e-3 if k == "ground" else step, f"{where}.{k}")
        return
    if isinstance(want, str) or want is None:
        assert got == want, where
        return
    if isinstance(want, list) and want and isinstance(want[0], (str, dict)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_payload(g, w, step, f"{where}[{i}]")
        return
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    if a.dtype.kind in "iub" or b.size == 0:
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    d = np.abs(a - b)
    ties = d > 1e-6
    assert np.all(np.abs(d[ties] - step) < 1e-6), (where, d.max())
    assert ties.sum() <= max(1, 0.01 * d.size), (where, int(ties.sum()), d.size)


def _port_tree(jtree):
    return tree_from_arrays({k: np.asarray(getattr(jtree, k)) for k in STATIC_FIELDS + ARRAY_FIELDS},
                            device="cpu")


def test_skeleton_payload_matches_reference(tmp_path):
    jtree = jmake_pendulum()
    rng = np.random.default_rng(0)
    qs = np.sin(np.linspace(0, 6, 40))[:, None]
    forces = rng.normal(size=(40, jtree.ncp, 3)) * 5.0
    tree = _port_tree(jtree)
    got = viewer.extract_skeleton_frames(tree, qs, max_frames=25, forces=forces)
    want = jviewer.extract_skeleton_frames(jtree, qs, max_frames=25, forces=forces)
    assert "force_tips" in want
    _same_payload(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    viewer.replay_html(tree, qs, tmp_path / "r.html", forces=forces)
    html = (tmp_path / "r.html").read_text()
    assert '"segments"' in html and '"force_tips"' in html and "canvas" in html
    pytest.importorskip("PIL")
    viewer.record_gif(tree, qs, tmp_path / "r.gif", max_frames=5)
    assert (tmp_path / "r.gif").stat().st_size > 0


@pytest.fixture(scope="module")
def anymal():
    urdf, hw = DATA / "anymal.urdf", DATA / "anymal_hardware.toml"
    robot, jrobot = (build_robot(urdf, hw, freeflyer=True, device="cpu"),
                     jbuild_robot(urdf, hw, freeflyer=True))
    coef = np.random.default_rng(1).uniform(-1.0, 1.0, 4 * 8).astype(np.float32)
    coef[:8] *= 0.03  # amplitudes
    ground = FourierGround.from_coef(torch.as_tensor(coef))
    jground = JFourier(amp=jnp.asarray(coef[:8]), kx=jnp.asarray(coef[8:16]),
                       ky=jnp.asarray(coef[16:24]), phase=jnp.asarray(coef[24:]))
    return robot, jrobot, ground, jground


def test_replay3d_and_render_payloads_match_reference(anymal, tmp_path):
    robot, jrobot, ground, jground = anymal
    q0 = np.asarray(stand_q(robot.tree), np.float64)
    qs = np.tile(q0, (12, 1))
    qs[:, 0] += np.linspace(0.0, 0.3, 12)
    qs[:, 2] += 0.03 * np.sin(np.linspace(0, 2 * np.pi, 12))
    qs[:, 7:] += 0.1 * np.sin(np.linspace(0, 3, 12))[:, None]
    kw = dict(forces=np.ones((12, robot.tree.ncp, 3)), dt=0.02)
    got = viewer3d.extract_replay3d(robot.tree, qs, visuals=robot.visuals, ground=ground, **kw)
    want = jviewer3d.extract_replay3d(jrobot.tree, qs, visuals=jrobot.visuals, ground=jground, **kw)
    assert "cp" in want and want["geoms"]
    _same_payload(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    # render_frame3d's payload: the extraction of one configuration
    one = viewer3d.extract_replay3d(robot.tree, q0[None], visuals=robot.visuals, max_frames=1)
    jone = jviewer3d.extract_replay3d(jrobot.tree, q0[None], visuals=jrobot.visuals, max_frames=1)
    _same_payload(json.loads(json.dumps(one)), json.loads(json.dumps(jone)))
    frame = viewer3d.render_frame3d(robot, torch.as_tensor(q0), size=160, ground=ground)
    assert frame.shape == (160, 160, 3) and frame.dtype == np.uint8
    assert (frame.reshape(-1, 3).max(0) > 100).any()  # the robot, not only the background
    viewer3d.replay_html3d(robot, qs, tmp_path / "r.html", ground=ground, dt=0.02)
    html = (tmp_path / "r.html").read_text()
    for snippet in ("onmousedown", "onwheel", "camBasis", '"cp"'):
        assert snippet in html, snippet


def test_play_on_the_cartpole_matches_reference(tmp_path):
    jenv, env = JCartPoleEnv(), CartPoleEnv(device="cpu")
    key = jax.random.PRNGKey(3)
    jstate = jax.jit(jenv.reset)(key)
    arrays = {
        "sim": {k: np.asarray(getattr(jstate.sim, k))[None] for k in
                ("t", "q", "v", "contact_forces", "solver_residual", "lam", "a", "tau")},
        **{k: np.asarray(getattr(jstate, k))[None] for k in
           ("obs", "reward", "terminated", "truncated", "steps")},
        "info": {},
    }
    env.reset = lambda generator, batch_size: env_state_from_arrays(arrays, generator,
                                                                    device="cpu")
    jqs, jrewards = jplay(jenv, lambda obs: (obs[2] > 0).astype(jnp.int32), n_steps=30, key=key)
    qs, rewards = play(env, lambda obs: (obs[:, 2] > 0).long(), n_steps=30,
                       replay_path=tmp_path / "play.html")
    assert qs.shape == jqs.shape and rewards.shape == jrewards.shape
    np.testing.assert_allclose(qs, jqs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(rewards, jrewards, atol=1e-5, rtol=0)
    assert (tmp_path / "play.html").stat().st_size > 2000
