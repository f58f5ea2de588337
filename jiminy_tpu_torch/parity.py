"""Golden-trajectory parity harness: the port's run mode for fixtures.

Counterpart of ``jiminy_tpu/parity.py``: the same fixture layout, the
same recorder, comparator and CLI, on the port's engine.

    python -m jiminy_tpu_torch.parity run "parity/fixtures/*" [--device cpu]

prints one JSON line per fixture (the largest drift in q and v and the
verdict against the fixture's tolerances) and a summary line.

A fixture is a directory:

    meta.json   — name, source, freeflyer, quat_convention ("xyzw" or
                  "wxyz"), engine_options (EngineOptions overrides, with a
                  "contacts" sub-dict), constraints (wheel or distance
                  constraints, frames by name), tolerance_q, tolerance_v,
                  duration, notes
    traj.npz    — t (T,), q (T, nq), v (T, nv), optional u (T, nu), an
                  open-loop command table held zero-order
    robot.urdf  — the model; hardware.toml optional

Parity runs in float64, as the reference integrates in double. The
whole-substep and chain kernels are float32, so the port runs its plain
physics here (``constraint_solver="inline"``) on the device asked for
(``"cuda"`` by default, as every entry point), and each report names
that device.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import sys
from pathlib import Path

import numpy as np
import torch

_PARITY_DEFAULTS = {
    "source": "jiminy_tpu-self",
    "freeflyer": False,
    "quat_convention": "xyzw",
    "engine_options": {},
    "tolerance_q": 1e-6,
    "tolerance_v": 1e-5,
    "notes": "",
}


def _quat_to_xyzw(q: np.ndarray, convention: str, freeflyer: bool) -> np.ndarray:
    """The free-flyer quaternion columns (3:7) of a (T, nq) table in the
    native xyzw layout."""
    if not freeflyer or convention == "xyzw":
        return q
    if convention != "wxyz":
        raise ValueError(f"unknown quat_convention {convention!r}")
    out = q.copy()
    out[..., 6] = q[..., 3]  # w last
    out[..., 3:6] = q[..., 4:7]  # xyz
    return out


@dataclasses.dataclass
class ParityReport:
    name: str
    source: str
    n_samples: int
    max_drift_q: float
    max_drift_v: float
    tolerance_q: float
    tolerance_v: float
    ok: bool
    device: str = "cpu"

    def json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _parse_constraints(specs, tree) -> tuple:
    """The meta's declarative constraints, frames by name: ``{"type":
    "wheel", "frame", "radius", "axis", "baumgarte_freq"}`` or ``{"type":
    "distance", "frame1", "frame2", "distance", "baumgarte_freq"}``."""
    from jiminy_tpu_torch.engine.constraints import constraint_from_arrays

    out = []
    for c in specs:
        kind = c["type"]
        if kind not in ("wheel", "distance"):
            raise ValueError(f"unknown constraint type {kind!r}")
        fields = {k: x for k, x in c.items() if k != "type"}
        for k in ("frame", "frame1", "frame2"):
            if k in c:
                fields[k] = tree.frame_name.index(c[k])
        out.append(constraint_from_arrays(kind, fields))
    return tuple(out)


def _build_sim(fix: Path, meta: dict, device):
    from jiminy_tpu_torch.engine.contact import ContactParams
    from jiminy_tpu_torch.engine.engine import EngineOptions
    from jiminy_tpu_torch.robot import build_robot
    from jiminy_tpu_torch.simulator import Simulator

    hardware = fix / "hardware.toml"
    opts_dict = dict(meta.get("engine_options", {}))
    contacts = opts_dict.pop("contacts", None)
    opts = EngineOptions(**opts_dict, constraint_solver="inline")
    if contacts:
        opts = dataclasses.replace(opts, contacts=ContactParams(
            **{**dataclasses.asdict(opts.contacts), **contacts}))
    robot = build_robot(fix / "robot.urdf", hardware=str(hardware) if hardware.exists() else None,
                        freeflyer=bool(meta.get("freeflyer", False)), device=device,
                        dtype=torch.float64)
    return Simulator(robot, options=opts, device=device,
                     constraints=_parse_constraints(meta.get("constraints", []), robot.tree))


def _run_f64(sim, q0, v0, n_steps: int, u_tab: np.ndarray | None):
    """The float64 trajectory (n_steps + 1, ·) at t = 0, dt, …, n_steps·dt
    by a loop of engine steps of one substep (the Simulator's telemetry is
    float32, too coarse for the tolerances). The command at step k is
    row min(k, n_u − 1) of ``u_tab``, zero without it."""
    eng = sim.engine
    kw = dict(dtype=torch.float64, device=eng.device)
    n_cmd = sim.robot.nmotors or sim.tree.nv
    u = torch.as_tensor(u_tab, **kw) if u_tab is not None else torch.zeros(1, n_cmd, **kw)
    st = eng.reset(torch.as_tensor(np.asarray(q0), **kw)[None],
                   torch.as_tensor(np.asarray(v0), **kw)[None])
    qs = torch.empty(n_steps + 1, sim.tree.nq, **kw)
    vs = torch.empty(n_steps + 1, sim.tree.nv, **kw)
    qs[0], vs[0] = st.q[0], st.v[0]
    for k in range(n_steps):
        st = eng.step(st, u[min(k, u.shape[0] - 1)][None], n_substeps=1)
        qs[k + 1], vs[k + 1] = st.q[0], st.v[0]
    return qs.cpu().numpy(), vs.cpu().numpy()


def compare(fixture: str | Path, device="cuda") -> ParityReport:
    """Replay one fixture in float64 on ``device`` and report the
    largest drift from its recorded trajectory."""
    from jiminy_tpu_torch import resolve_device

    dev = resolve_device(device)
    fix = Path(fixture)
    meta = {**_PARITY_DEFAULTS, **json.loads((fix / "meta.json").read_text())}
    data = np.load(fix / "traj.npz")
    t_ref = np.asarray(data["t"], np.float64)
    sim = _build_sim(fix, meta, dev)
    tree = sim.tree
    q_ref = _quat_to_xyzw(np.asarray(data["q"], np.float64), meta["quat_convention"],
                          meta["freeflyer"])
    v_ref = np.asarray(data["v"], np.float64)
    if q_ref.shape[1] != tree.nq or v_ref.shape[1] != tree.nv:
        raise ValueError(f"fixture dims (nq={q_ref.shape[1]}, nv={v_ref.shape[1]}) vs "
                         f"model (nq={tree.nq}, nv={tree.nv})")
    dt = float(sim.engine.options.dt)
    # the fixture's samples must sit on the engine's step grid
    idx = np.rint(t_ref / dt).astype(int)
    if not np.allclose(idx * dt, t_ref, atol=1e-9):
        raise ValueError("fixture times are not multiples of engine dt")
    u_tab = np.asarray(data["u"], np.float64) if "u" in data else None
    q_run, v_run = _run_f64(sim, q_ref[0], v_ref[0], int(idx.max()), u_tab)
    dq = np.max(np.abs(q_run[idx] - q_ref))
    dv = np.max(np.abs(v_run[idx] - v_ref))
    return ParityReport(
        name=meta.get("name", fix.name),
        source=meta["source"],
        n_samples=len(t_ref),
        max_drift_q=float(dq),
        max_drift_v=float(dv),
        tolerance_q=float(meta["tolerance_q"]),
        tolerance_v=float(meta["tolerance_v"]),
        ok=bool(dq <= meta["tolerance_q"] and dv <= meta["tolerance_v"]),
        device=str(dev),
    )


def record(fixture: str | Path, urdf: str | Path, duration: float, q0=None, v0=None,
           engine_options: dict | None = None, hardware: str | Path | None = None,
           freeflyer: bool = False, u_table: np.ndarray | None = None, name: str | None = None,
           tolerance_q: float = 1e-6, tolerance_v: float = 1e-5,
           source: str = "jiminy_tpu-self", device="cuda") -> Path:
    """Record a fixture from the port's own engine (for testing the
    harness; real parity fixtures are recorded from the reference engine
    into the same layout)."""
    import shutil

    fix = Path(fixture)
    fix.mkdir(parents=True, exist_ok=True)
    shutil.copy(urdf, fix / "robot.urdf")
    if hardware is not None:
        shutil.copy(hardware, fix / "hardware.toml")
    meta = {
        **_PARITY_DEFAULTS,
        "name": name or fix.name,
        "source": source,
        "freeflyer": freeflyer,
        "engine_options": engine_options or {},
        "tolerance_q": tolerance_q,
        "tolerance_v": tolerance_v,
        "duration": float(duration),
    }
    (fix / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    sim = _build_sim(fix, meta, device)
    tree = sim.tree
    dt = float(sim.engine.options.dt)
    q0 = np.asarray(tree.neutral_q(), np.float64) if q0 is None else np.asarray(q0, np.float64)
    v0 = np.zeros(tree.nv) if v0 is None else np.asarray(v0, np.float64)
    n_steps = int(round(duration / dt))
    q, v = _run_f64(sim, q0, v0, n_steps, u_table)
    arrays = {"t": dt * np.arange(n_steps + 1, dtype=np.float64), "q": q, "v": v}
    if u_table is not None:
        arrays["u"] = np.asarray(u_table, np.float64)
    np.savez(fix / "traj.npz", **arrays)
    return fix


def run_fixtures(pattern: str, device="cuda") -> dict:
    """Compare every fixture directory matching ``pattern``; print each
    report and the summary as JSON lines and return the summary."""
    paths = sorted(p for p in glob.glob(pattern) if Path(p).is_dir())
    if not paths:
        raise SystemExit(f"no fixtures match {pattern!r}")
    reports = []
    for p in paths:
        r = compare(p, device)
        print(r.json(), flush=True)
        reports.append(r)
    summary = {
        "metric": "cross_engine_parity",
        "fixtures": len(reports),
        "passed": sum(r.ok for r in reports),
        "max_drift_q": max(r.max_drift_q for r in reports),
        "max_drift_v": max(r.max_drift_v for r in reports),
        "ok": all(r.ok for r in reports),
    }
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jiminy_tpu_torch.parity", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="compare fixtures (glob of dirs)")
    p_run.add_argument("pattern")
    p_run.add_argument("--device", default="cuda")
    p_rec = sub.add_parser("record", help="record a self-fixture")
    p_rec.add_argument("fixture")
    p_rec.add_argument("urdf")
    p_rec.add_argument("--duration", type=float, default=2.0)
    p_rec.add_argument("--dt", type=float, default=1e-3)
    p_rec.add_argument("--solver", default="runge_kutta_4")
    p_rec.add_argument("--freeflyer", action="store_true")
    p_rec.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return 0 if run_fixtures(args.pattern, args.device)["ok"] else 1
    record(args.fixture, args.urdf, args.duration,
           engine_options={"dt": args.dt, "solver": args.solver},
           freeflyer=args.freeflyer, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
