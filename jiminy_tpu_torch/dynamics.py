"""Trajectories: time-indexed robot states with Lie-group interpolation.

Counterpart of ``jiminy_tpu/dynamics.py``: a :class:`Trajectory` holds
the times, configurations and velocities of one robot as numpy arrays,
interpolates a configuration on the manifold (q₀ ⊕ frac·(q₁ ⊖ q₀)) and a
velocity linearly, and is read from a telemetry log's ``q.*``/``v.*``
columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree


@dataclass
class Trajectory:
    """A trajectory of one robot: ``times`` (T,), ``qs`` (T, nq) and
    optionally ``vs`` (T, nv), numpy arrays."""

    tree: KinematicTree
    times: np.ndarray
    qs: np.ndarray
    vs: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.times)

    @property
    def duration(self) -> float:
        return float(self.times[-1] - self.times[0])

    def at(self, t: float):
        """(q (nq,), v (nv,) or None) at time ``t`` (clamped to the
        trajectory), tensors in the tree's dtype on its device."""
        t = float(np.clip(t, self.times[0], self.times[-1]))
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        i = min(max(i, 0), len(self.times) - 2)
        t0, t1 = self.times[i], self.times[i + 1]
        frac = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        kw = dict(dtype=self.tree.dtype, device=self.tree.device)
        q0 = torch.as_tensor(self.qs[i], **kw)[None]
        q1 = torch.as_tensor(self.qs[i + 1], **kw)[None]
        q = algos.integrate(self.tree, q0, algos.difference(self.tree, q0, q1), frac)[0]
        v = None
        if self.vs is not None:
            v = torch.as_tensor((1 - frac) * self.vs[i] + frac * self.vs[i + 1], **kw)
        return q, v

    @staticmethod
    def from_log(tree: KinematicTree, log) -> "Trajectory":
        """The trajectory in a telemetry log's ``q.*`` (and ``v.*``)
        columns; KeyError without the q columns."""

        def cols(prefix, n):
            names = [f"{prefix}.{i}" for i in range(n)]
            if not all(name in log.columns for name in names):
                return None
            return np.stack([np.asarray(log.columns[c]) for c in names], 1)

        qs = cols("q", tree.nq)
        if qs is None:
            raise KeyError("log has no q.* columns")
        return Trajectory(tree=tree, times=np.asarray(log.time), qs=qs, vs=cols("v", tree.nv))
