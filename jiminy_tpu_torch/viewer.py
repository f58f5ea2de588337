"""Replay viewer: a self-contained HTML skeleton animation from logs.

Counterpart of ``jiminy_tpu/viewer.py`` (numpy and HTML, the port's own
copy): the robot skeleton (joint-to-joint segments, contact points, the
centre of mass, optional contact-force arrows) animated in an
orthographic three-view with a time scrubber, a zero-dependency file for
headless hosts, and an animated GIF (PIL, imported only there). The
forward kinematics run in the port's :mod:`~jiminy_tpu_torch.core.algos`
over the whole trajectory at once.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree


def as_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def trajectory_kinematics(tree: KinematicTree, qs: np.ndarray) -> tuple:
    """(world poses of every body, contact points (F, ncp, 3), centre of
    mass (F, 3)) of the configurations ``qs`` (F, nq), on the tree's
    device in its dtype; the poses a list of batched Transforms."""
    q = torch.as_tensor(qs, dtype=tree.dtype, device=tree.device)
    xw = algos.forward_kinematics(tree, q)
    cps = (torch.stack([xw[tree.contact_body[k]].apply(tree.contact_pos[k])
                        for k in range(tree.ncp)], dim=1)
           if tree.ncp else q.new_zeros(q.shape[0], 0, 3))
    return xw, cps.cpu().numpy(), algos.com_position(tree, xw).cpu().numpy()


def extract_skeleton_frames(
    tree: KinematicTree,
    qs: np.ndarray,
    max_frames: int = 300,
    forces: np.ndarray | None = None,
) -> dict:
    """FK over a trajectory → JSON-able skeleton data.

    Returns {"segments": [(parent_body, body), ...] indices,
    "frames": (F, nb, 3) body origins, "contacts": (F, ncp, 3),
    "com": (F, 3) whole-body center of mass}; with ``forces`` (a
    (T, ncp, 3) world-frame contact-force history, e.g.
    ``SimState.contact_forces`` stacked over time) also "force_tips":
    contact-force marker arrows, the reference Viewer's force/CoM
    markers."""
    qs = as_numpy(qs)
    T = qs.shape[0]
    idx = np.linspace(0, T - 1, min(max_frames, T)).astype(int)
    xw, cps, com = trajectory_kinematics(tree, qs[idx])
    pts = torch.stack([x.pos for x in xw], dim=1).cpu().numpy()
    segments = [
        (tree.parent[i], i) for i in range(tree.nb) if tree.parent[i] >= 0
    ]
    out = {
        "segments": segments,
        "frames": np.asarray(pts).round(4).tolist(),
        "contacts": np.asarray(cps).round(4).tolist(),
        "com": np.asarray(com).round(4).tolist(),
        "body_names": list(tree.body_name),
        "frame_idx": idx.tolist(),
    }
    if forces is not None and tree.ncp:
        f = as_numpy(forces)[idx]  # (F, ncp, 3)
        weight = float(tree.inertia_mass.sum()) * 9.81
        # arrow tip = contact point + f/weight · 0.3 m (≈0.3 m per bodyweight)
        tips = np.asarray(cps) + f / max(weight, 1e-6) * 0.3
        out["force_tips"] = tips.round(4).tolist()
    return out


_HTML = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body{{font-family:sans-serif;background:#111;color:#eee;margin:1em}}
canvas{{background:#1b1b1b;border:1px solid #333;border-radius:6px}}
.row{{display:flex;gap:1em;flex-wrap:wrap}} .lbl{{color:#888;font-size:12px}}
input[type=range]{{width:60%}}
</style></head><body>
<h2>{title}</h2>
<div class="row">
 <div><div class="lbl">side (x–z)</div><canvas id="c0" width="420" height="420"></canvas></div>
 <div><div class="lbl">front (y–z)</div><canvas id="c1" width="420" height="420"></canvas></div>
 <div><div class="lbl">top (x–y)</div><canvas id="c2" width="420" height="420"></canvas></div>
</div>
<p><button id="play">⏯</button> <input type="range" id="t" min="0" value="0">
<span id="info" class="lbl"></span></p>
<script>
const D = {data};
const F = D.frames, C = D.contacts, S = D.segments;
const axes = [[0,2],[1,2],[0,1]];
let all = F.flat(); let xs=[[],[],[]];
for (const p of F.flat()) {{}}
function bounds() {{
  let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
  for (const fr of F) for (const p of fr)
    for (let k=0;k<3;k++) {{ lo[k]=Math.min(lo[k],p[k]); hi[k]=Math.max(hi[k],p[k]); }}
  return [lo,hi];
}}
const [lo,hi] = bounds();
const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 0.5)*1.2;
function proj(p, ax, w, h) {{
  const cx=(lo[ax[0]]+hi[ax[0]])/2, cy=(lo[ax[1]]+hi[ax[1]])/2;
  return [w/2 + (p[ax[0]]-cx)/span*w, h/2 - (p[ax[1]]-cy)/span*h];
}}
const slider = document.getElementById('t');
slider.max = F.length-1;
function draw(f) {{
  for (let ci=0; ci<3; ci++) {{
    const cv = document.getElementById('c'+ci), g = cv.getContext('2d');
    g.clearRect(0,0,cv.width,cv.height);
    // ground line at z=0 for the two elevation views
    if (ci<2) {{
      g.strokeStyle='#444'; g.beginPath();
      const [gx0,gy0]=proj([lo[0],lo[1],0],axes[ci],cv.width,cv.height);
      g.moveTo(0,gy0); g.lineTo(cv.width,gy0); g.stroke();
    }}
    g.strokeStyle='#6cf'; g.lineWidth=2; g.beginPath();
    for (const [a,b] of S) {{
      const p=proj(F[f][a],axes[ci],cv.width,cv.height);
      const q=proj(F[f][b],axes[ci],cv.width,cv.height);
      g.moveTo(p[0],p[1]); g.lineTo(q[0],q[1]);
    }}
    g.stroke();
    g.fillStyle='#fc6';
    for (const c of (C[f]||[])) {{
      const p=proj(c,axes[ci],cv.width,cv.height);
      g.beginPath(); g.arc(p[0],p[1],3,0,7); g.fill();
    }}
    // contact-force arrows (marker parity with the reference Viewer)
    if (D.force_tips) {{
      g.strokeStyle='#f80'; g.lineWidth=1.5; g.beginPath();
      const tips=D.force_tips[f]||[];
      for (let k=0;k<tips.length;k++) {{
        const p=proj(C[f][k],axes[ci],cv.width,cv.height);
        const q=proj(tips[k],axes[ci],cv.width,cv.height);
        g.moveTo(p[0],p[1]); g.lineTo(q[0],q[1]);
      }}
      g.stroke();
    }}
    // CoM marker + trail
    if (D.com) {{
      g.strokeStyle='#5d5'; g.lineWidth=1; g.beginPath();
      for (let k=Math.max(0,f-40); k<=f; k++) {{
        const p=proj(D.com[k],axes[ci],cv.width,cv.height);
        (k===Math.max(0,f-40)) ? g.moveTo(p[0],p[1]) : g.lineTo(p[0],p[1]);
      }}
      g.stroke();
      g.fillStyle='#5d5';
      const m=proj(D.com[f],axes[ci],cv.width,cv.height);
      g.beginPath(); g.arc(m[0],m[1],4,0,7); g.fill();
    }}
    g.fillStyle='#e55';
    const r=proj(F[f][0],axes[ci],cv.width,cv.height);
    g.beginPath(); g.arc(r[0],r[1],4,0,7); g.fill();
  }}
  document.getElementById('info').textContent = 'frame '+f+'/'+(F.length-1);
}}
slider.oninput = () => draw(+slider.value);
let playing=null;
document.getElementById('play').onclick = () => {{
  if (playing) {{ clearInterval(playing); playing=null; return; }}
  playing = setInterval(()=>{{
    slider.value = (+slider.value+1) % F.length; draw(+slider.value);
  }}, 40);
}};
draw(0);
</script></body></html>
"""


def replay_html(
    tree: KinematicTree,
    qs,
    path: str | Path,
    title: str = "jiminy_tpu replay",
    max_frames: int = 300,
    forces=None,
) -> None:
    """Write a standalone animated replay of a (T, nq) trajectory.
    ``forces``: optional (T, ncp, 3) contact-force history → arrow
    markers, as the reference Viewer's force markers."""
    data = extract_skeleton_frames(
        tree, qs, max_frames=max_frames, forces=forces
    )
    Path(path).write_text(
        _HTML.format(title=title, data=json.dumps(data))
    )


def record_gif(
    tree: KinematicTree,
    qs,
    path: str | Path,
    fps: int = 25,
    size: int = 420,
    forces=None,
    max_frames: int = 150,
) -> None:
    """Render a trajectory to an animated GIF (side x–z view with ground
    line, skeleton, contact points, CoM marker and optional force
    arrows), the reference Viewer's video recording for headless hosts."""
    from PIL import Image, ImageDraw

    data = extract_skeleton_frames(
        tree, qs, max_frames=max_frames, forces=forces
    )
    frames = np.asarray(data["frames"])  # (F, nb, 3)
    com = np.asarray(data["com"])
    cps = np.asarray(data["contacts"])
    tips = np.asarray(data.get("force_tips", []))
    lo = frames.reshape(-1, 3).min(0)
    hi = frames.reshape(-1, 3).max(0)
    span = max(hi[0] - lo[0], hi[2] - lo[2], 0.5) * 1.25
    cx, cz = (lo[0] + hi[0]) / 2, (lo[2] + hi[2]) / 2

    def prj(p):
        return (
            size / 2 + (p[0] - cx) / span * size,
            size / 2 - (p[2] - cz) / span * size,
        )

    imgs = []
    for f in range(len(frames)):
        im = Image.new("RGB", (size, size), (27, 27, 27))
        d = ImageDraw.Draw(im)
        gy = prj([0, 0, 0])[1]
        d.line([(0, gy), (size, gy)], fill=(70, 70, 70), width=1)
        for a, b in data["segments"]:
            d.line(
                [prj(frames[f][a]), prj(frames[f][b])],
                fill=(102, 170, 238), width=2,
            )
        if len(tips):
            for k in range(cps.shape[1]):
                d.line(
                    [prj(cps[f][k]), prj(tips[f][k])],
                    fill=(255, 136, 0), width=2,
                )
        for k in range(cps.shape[1] if cps.ndim == 3 else 0):
            x, y = prj(cps[f][k])
            d.ellipse([x - 2, y - 2, x + 2, y + 2], fill=(255, 204, 102))
        x, y = prj(com[f])
        d.ellipse([x - 4, y - 4, x + 4, y + 4], fill=(85, 221, 85))
        imgs.append(im)
    imgs[0].save(
        str(path),
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )


def replay_from_log(tree: KinematicTree, log, path: str | Path, **kw) -> None:
    """Replay straight from a TelemetryLog containing q.* columns."""
    cols = [c for c in log.columns if c.startswith("q.")]
    cols.sort(key=lambda c: int(c.split(".")[1]))
    qs = np.stack([np.asarray(log.columns[c]) for c in cols], axis=1)
    replay_html(tree, qs, path, **kw)
