"""Simulator: the single-robot workflow around one Engine.

Counterpart of ``jiminy_tpu/simulator.py``: build a robot from a URDF
and its hardware TOML, ``simulate(t_end, q0, v0, controller)`` it with
telemetry, rebuild it from a log, render, replay and plot it, and move
its options through TOML. ``simulate_batch`` runs a (B, nq) batch of the
same robot.

The reference compiles a whole run into one scan. Here a run is a Python
loop of :meth:`Engine.step` calls, one per control step: on the card one
K2 launch each when the model rides the whole-substep kernels. Every
per-step record (t, q, v, contact forces, solver residual, sensor
channels) goes into tensors allocated on the device before the loop;
nothing in the loop reads the device, and the host gets the records once,
at the end, where the energies are computed from the recorded states in
one batched call.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.engine.engine import Engine, EngineOptions, SimState
from jiminy_tpu_torch.robot import Robot, build_robot
from jiminy_tpu_torch.telemetry import TelemetryLog, stack_log


class Simulator:
    """A Robot and its Engine, on ``device``. ``controller`` is the
    engine's inner-loop controller (see :class:`Engine`); the controller
    of :meth:`simulate` is the outer one, ``fn(q, v, t) → command`` on
    (B, ·) tensors."""

    def __init__(self, robot: Robot, options: EngineOptions | None = None, ground=None,
                 constraints: tuple = (), controller: Optional[Callable] = None,
                 device="cuda"):
        self.robot = robot
        self.engine = Engine(robot.tree, options, ground=ground, constraints=constraints,
                             motors=robot.motors, controller=controller, device=device)
        self._seed = 0

    @staticmethod
    def build(urdf: str | Path, hardware: str | Path | dict | None = None,
              freeflyer: bool = False, options: EngineOptions | None = None, ground=None,
              device="cuda", **kwargs) -> "Simulator":
        """From a URDF and its hardware description (:func:`build_robot`)."""
        robot = build_robot(urdf, hardware=hardware, freeflyer=freeflyer, device=device)
        return Simulator(robot, options=options, ground=ground, device=device, **kwargs)

    @property
    def tree(self):
        return self.engine.tree

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def seed(self, seed: int) -> None:
        self._seed = int(seed)

    def _state(self, x, default) -> torch.Tensor:
        x = default if x is None else x
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=self.tree.dtype, device=self.device)

    def _schedule(self, t_end: float, control_dt: float | None) -> tuple[int, int, int]:
        """(substeps per control step, control steps, command size)."""
        dt = self.engine.options.dt
        n_sub = max(1, round((control_dt or dt) / dt))
        n_ctrl = max(1, round(t_end / (n_sub * dt)))
        return n_sub, n_ctrl, self.robot.nmotors or self.tree.nv

    def simulate(self, t_end: float, q0=None, v0=None, controller: Optional[Callable] = None,
                 control_dt: float | None = None, log_constants: dict | None = None,
                 record_sensors: bool = False, seed: int | None = None
                 ) -> tuple[SimState, TelemetryLog]:
        """Run one robot (a batch of 1) over [0, t_end] under
        ``controller(q, v, t) → command`` ((1, ·) tensors; None: zero),
        updated every ``control_dt`` (default: every engine step). Returns
        the final state and the telemetry log: time, q, v, the kinetic and
        potential energy, the solver residual, the contact forces (with
        contact sites) and, with ``record_sensors``, every sensor channel
        (``sensor_<type>``), with the reference's columns and constants.
        The sensor noise is drawn from a generator seeded ``seed`` (default:
        :meth:`seed`'s)."""
        tree, eng = self.tree, self.engine
        n_sub, n_ctrl, n_cmd = self._schedule(t_end, control_dt)
        suite = self.robot.sensors.to(device=self.device, dtype=tree.dtype) \
            if record_sensors and self.robot.sensors is not None else None
        if record_sensors and suite is None:
            raise ValueError("record_sensors=True but the robot has none")
        q0 = self._state(q0, tree.neutral_q()).reshape(1, tree.nq)
        v0 = self._state(v0, np.zeros(tree.nv)).reshape(1, tree.nv)
        st = eng.reset(q0, v0)
        gen = torch.Generator(device=self.device).manual_seed(
            self._seed if seed is None else int(seed))
        if suite is not None:
            bufs = suite.reset(suite.sample_eps(gen, 1), q0, v0)
        rec = {"t": st.t.new_empty(n_ctrl, 1), "q": q0.new_empty(n_ctrl, 1, tree.nq),
               "v": v0.new_empty(n_ctrl, 1, tree.nv),
               "solver_residual": st.solver_residual.new_empty(n_ctrl, 1),
               "contact_force": st.contact_forces.new_empty(n_ctrl, *st.contact_forces.shape)}
        if suite is not None:
            for g in suite.groups:
                rec[f"sensor_{g.type}"] = q0.new_empty(n_ctrl, 1, g.ns, g.dim)
        zero = q0.new_zeros(1, n_cmd)
        for i in range(n_ctrl):
            u = controller(st.q, st.v, st.t) if controller is not None else zero
            st = eng.step(st, u, n_substeps=n_sub)
            rec["t"][i], rec["q"][i], rec["v"][i] = st.t, st.q, st.v
            rec["solver_residual"][i], rec["contact_force"][i] = st.solver_residual, st.contact_forces
            if suite is not None:
                # the engine's accepted acceleration and actuation torque:
                # the IMU reads the proper acceleration, effort sensors τ
                bufs = suite.update(bufs, suite.sample_eps(gen, 1), st.q, st.v, st.a,
                                    st.contact_forces, st.tau)
                for typ, m in suite.read(bufs).items():
                    rec[f"sensor_{typ}"][i] = m
        ke, pe = algos.energy(tree, rec["q"][:, 0], rec["v"][:, 0])
        host = {k: x[:, 0].cpu().numpy() for k, x in rec.items()}
        named = {"q": host["q"], "v": host["v"], "energy_kinetic": ke.cpu().numpy(),
                 "energy_potential": pe.cpu().numpy(),
                 "solver_residual": host["solver_residual"]}
        if tree.ncp:
            named["contact_force"] = host["contact_force"]
        # the sensor channels in the order of their names, as the
        # reference's scan returns its records
        named.update({k: host[k] for k in sorted(host) if k.startswith("sensor_")})
        from jiminy_tpu_torch.io.serialization import robot_to_json

        constants = {
            "robot_name": self.robot.name,
            "nq": tree.nq,
            "nv": tree.nv,
            "joint_names": ",".join(tree.joint_name),
            "engine_options": str(dataclasses.asdict(eng.options)),
            "seed": self._seed,
            # the whole robot: a log alone rebuilds the setup
            "robot": robot_to_json(self.robot),
            **(log_constants or {}),
        }
        return st, stack_log(host["t"], named, constants)

    def simulate_batch(self, t_end: float, q0, v0, controller: Optional[Callable] = None,
                       control_dt: float | None = None) -> SimState:
        """A (B, nq), (B, nv) batch over [0, t_end] under
        ``controller(q, v, t) → command`` on (B, ·) tensors; no telemetry.
        Returns the final state."""
        n_sub, n_ctrl, n_cmd = self._schedule(t_end, control_dt)
        q0 = self._state(q0, None)
        st = self.engine.reset(q0, self._state(v0, None))
        zero = q0.new_zeros(q0.shape[0], n_cmd)
        for _ in range(n_ctrl):
            u = controller(st.q, st.v, st.t) if controller is not None else zero
            st = self.engine.step(st, u, n_substeps=n_sub)
        return st

    # ---- render / replay / plot -------------------------------------------
    def render(self, q=None, **kw):
        """A shaded 3-D frame of a configuration (default: neutral), an
        (H, W, 3) uint8 array."""
        from jiminy_tpu_torch.viewer3d import render_frame3d

        q = self.tree.neutral_q() if q is None else q
        return render_frame3d(self.robot, q, ground=self.engine.ground, **kw)

    def replay(self, log, path: str | Path, **kw) -> None:
        """The 3-D HTML replay of a telemetry log."""
        from jiminy_tpu_torch.viewer3d import replay3d_from_log

        kw.setdefault("ground", self.engine.ground)
        kw.setdefault("dt", float(self.engine.options.dt))
        replay3d_from_log(self.robot, log, path, **kw)

    def plot(self, log, path: str | Path | None = None, **kw):
        """Grouped telemetry plots (matplotlib); with ``path`` the
        standalone HTML report instead."""
        from jiminy_tpu_torch.plot import export_html, plot_log

        if path is not None:
            return export_html(log, path, **kw)
        return plot_log(log, **kw)

    # ---- options io ------------------------------------------------------
    def export_options(self, path: str | Path) -> None:
        """The engine options as TOML (``[engine]``, ``[engine.contacts]``)."""
        _write_toml(path, {"engine": dataclasses.asdict(self.engine.options)})

    def import_options(self, path: str | Path) -> None:
        """Options from a TOML file written by :meth:`export_options` (or
        the reference's), applied through :meth:`Engine.set_options`."""
        import tomllib

        self.engine.set_options(tomllib.loads(Path(path).read_text()).get("engine", {}))


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return f'"{v}"'


def _write_toml(path: str | Path, data: dict) -> None:
    """A minimal TOML writer (the standard library reads TOML only): one
    table per section, a nested dict as its sub-table."""
    lines = []
    for section, values in data.items():
        lines.append(f"[{section}]")
        sub = {k: v for k, v in values.items() if isinstance(v, dict)}
        lines += [f"{k} = {_toml_value(v)}" for k, v in values.items() if k not in sub]
        for k, v in sub.items():
            lines.append(f"\n[{section}.{k}]")
            lines += [f"{kk} = {_toml_value(float(vv))}" for kk, vv in v.items()]
    Path(path).write_text("\n".join(lines) + "\n")
