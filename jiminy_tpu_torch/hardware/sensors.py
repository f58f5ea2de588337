"""Sensor suite: measurement, corruption and delay lines, batched.

Counterpart of ``jiminy_tpu/hardware/sensors.py``. The types:

- ``imu``     — quaternion (4, xyzw), gyro (3), accelerometer (3) at a frame
- ``encoder`` — joint position and velocity (2)
- ``effort``  — actuated joint torque (1)
- ``contact`` — 3-D contact force at a contact point, in its body's frame
- ``force``   — 6-D wrench [torque; force] of a body's contacts at a frame

Each type is one group; each group keeps a ring buffer (B, ns, buf_len,
dim), newest sample at slot 0, and :meth:`SensorSuite.read` interpolates
it linearly at each sensor's delay.

The reference draws its noise from a JAX key inside ``reset`` and
``update``. Here every function that corrupts takes the corruption
``eps`` (bias + noise_std·N(0, 1)) as a tensor (B, n_eps) in
:meth:`SensorSuite.sample_eps`'s [group][sensor][dim] layout, so a caller
can hand it the reference's own draws; :meth:`SensorSuite.sample_eps`
draws it from a ``torch.Generator``. The whole-substep kernel's sensor
stage (``ops/substep_kernel.py``) takes the same eps and the buffers
flattened by :meth:`SensorSuite.flatten_buffers`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from jiminy_tpu_torch.core import algos
from jiminy_tpu_torch.core.tree import KinematicTree
from jiminy_tpu_torch.math import so3
from jiminy_tpu_torch.math.spatial import mtv

SENSOR_DIMS = {"imu": 10, "encoder": 2, "effort": 1, "contact": 3, "force": 6}
# corruption dimensions (imu: rotation vector 3, gyro 3, accelerometer 3)
NOISE_DIMS = {"imu": 9, "encoder": 2, "effort": 1, "contact": 3, "force": 6}


def imu_spec(frame: str, delay=0.0, bias=0.0, noise_std=0.0, name=None):
    return dict(type="imu", target=frame, delay=delay, bias=bias,
                noise_std=noise_std, name=name or f"imu_{frame}")


def encoder_spec(joint: str, delay=0.0, bias=0.0, noise_std=0.0, name=None):
    return dict(type="encoder", target=joint, delay=delay, bias=bias,
                noise_std=noise_std, name=name or f"encoder_{joint}")


def effort_spec(joint: str, delay=0.0, bias=0.0, noise_std=0.0, name=None):
    return dict(type="effort", target=joint, delay=delay, bias=bias,
                noise_std=noise_std, name=name or f"effort_{joint}")


def contact_spec(contact: str, delay=0.0, bias=0.0, noise_std=0.0, name=None):
    return dict(type="contact", target=contact, delay=delay, bias=bias,
                noise_std=noise_std, name=name or f"contact_{contact}")


def force_spec(frame: str, delay=0.0, bias=0.0, noise_std=0.0, name=None):
    return dict(type="force", target=frame, delay=delay, bias=bias,
                noise_std=noise_std, name=name or f"force_{frame}")


@dataclasses.dataclass(frozen=True)
class SensorGroup:
    """All sensors of one type, stacked."""

    type: str
    target: tuple  # per sensor: frame, joint or contact index
    name: tuple
    buf_len: int
    delay: np.ndarray  # (ns,) float32 seconds
    bias: torch.Tensor  # (ns, ndim)
    noise_std: torch.Tensor  # (ns, ndim)

    @property
    def ns(self) -> int:
        return len(self.target)

    @property
    def dim(self) -> int:
        return SENSOR_DIMS[self.type]

    @property
    def ndim(self) -> int:
        return NOISE_DIMS[self.type]

    def to(self, device=None, dtype=None) -> "SensorGroup":
        return dataclasses.replace(
            self,
            bias=self.bias.to(device=device, dtype=dtype),
            noise_std=self.noise_std.to(device=device, dtype=dtype),
        )


class SensorSuite:
    """The sensors of one robot: static description plus the batched
    measure / corrupt / push / read functions. The ring buffers are the
    caller's state: a tuple of (B, ns, buf_len, dim) tensors, one per
    group, or flattened to (B, n_buf)."""

    def __init__(self, tree: KinematicTree, groups: Sequence[SensorGroup], period: float):
        self.tree = tree
        self.groups = list(groups)
        self.period = float(period)

    @staticmethod
    def build(tree: KinematicTree, specs: Sequence[dict], period: float) -> "SensorSuite":
        """From a list of ``*_spec`` dicts, names resolved to indices; one
        group per type in the order the types first appear;
        buf_len = ⌈max delay / period⌉ + 2."""
        by_type: dict[str, list[dict]] = {}
        for s in specs:
            by_type.setdefault(s["type"], []).append(s)
        groups = []
        for typ, ss in by_type.items():
            targets, names, delays, biases, noises = [], [], [], [], []
            ndim = NOISE_DIMS[typ]
            for s in ss:
                t = s["target"]
                if not isinstance(t, str):
                    idx = int(t)
                elif typ in ("imu", "force"):
                    idx = tree.frame_index(t)
                elif typ in ("encoder", "effort"):
                    idx = tree.joint_index(t)
                else:
                    idx = tree.contact_frame_name.index(t)
                targets.append(idx)
                names.append(s["name"])
                delays.append(float(s.get("delay", 0.0)))
                for out, key in ((biases, "bias"), (noises, "noise_std")):
                    out.append(np.broadcast_to(np.asarray(s.get(key, 0.0), np.float32), (ndim,)))
            kw = dict(dtype=tree.dtype, device=tree.device)
            groups.append(SensorGroup(
                type=typ,
                target=tuple(targets),
                name=tuple(names),
                buf_len=int(math.ceil(max(delays) / period)) + 2,
                delay=np.asarray(delays, np.float32),
                bias=torch.as_tensor(np.stack(biases), **kw),
                noise_std=torch.as_tensor(np.stack(noises), **kw),
            ))
        return SensorSuite(tree, groups, period)

    def to(self, device=None, dtype=None) -> "SensorSuite":
        return SensorSuite(
            self.tree.to(device=device, dtype=dtype),
            [g.to(device=device, dtype=dtype) for g in self.groups],
            self.period,
        )

    @property
    def n_buf(self) -> int:
        """Floats of one env's flattened ring buffers."""
        return sum(g.ns * g.buf_len * g.dim for g in self.groups)

    @property
    def n_eps(self) -> int:
        """Corruption values of one update of one env."""
        return sum(g.ns * g.ndim for g in self.groups)

    # -- measurement -------------------------------------------------------
    def _measure_group(self, g: SensorGroup, q, v, a, f_contact, tau, kin) -> torch.Tensor:
        """Noise-free measurement (B, ns, dim)."""
        tree = self.tree
        xw, vel, acc = kin
        rows = []
        if g.type == "imu":
            for f in g.target:
                b = tree.frame_body[f]
                quat = so3.matrix_to_quat(xw[b].compose(tree.frame_placement(f)).rot)
                Rfp, p = tree.fp_rot[f], tree.fp_pos[f]
                w_b, v_b = vel[b][:, :3], vel[b][:, 3:]
                al_b, aa_b = acc[b][:, :3], acc[b][:, 3:]
                # proper acceleration of the frame origin in body
                # coordinates: a_lin + ω×v_lin + α×p + ω×(ω×p)
                a_pt = (
                    aa_b + so3.cross(w_b, v_b) + so3.cross(al_b, p)
                    + so3.cross(w_b, so3.cross(w_b, p))
                )
                rows.append(torch.cat([quat, mtv(Rfp, w_b), mtv(Rfp, a_pt)], dim=-1))
        elif g.type == "encoder":
            for j in g.target:
                rows.append(torch.stack([q[:, tree.q_off[j]], v[:, tree.v_off[j]]], dim=-1))
        elif g.type == "effort":
            for j in g.target:
                rows.append(tau[:, tree.v_off[j]][:, None])
        elif g.type == "contact":
            for k in g.target:
                rows.append(mtv(xw[tree.contact_body[k]].rot, f_contact[:, k]))
        elif g.type == "force":
            for f in g.target:
                b = tree.frame_body[f]
                pose = xw[b].compose(tree.frame_placement(f))
                force = torque = q.new_zeros(q.shape[0], 3)
                for k in range(tree.ncp):
                    if tree.contact_body[k] != b:
                        continue
                    p_w = xw[b].apply(tree.contact_pos[k])
                    force = force + f_contact[:, k]
                    torque = torque + so3.cross(p_w - pose.pos, f_contact[:, k])
                rows.append(torch.cat([mtv(pose.rot, torque), mtv(pose.rot, force)], dim=-1))
        else:
            raise ValueError(g.type)
        return torch.stack(rows, dim=1)

    def measure_all(self, q, v, a, f_contact, tau) -> list[torch.Tensor]:
        """Noise-free measurements of every group at (q, v, a, contact
        forces (B, ncp, 3) world frame, τ)."""
        kin = algos.body_accelerations(self.tree, q, v, a)
        return [self._measure_group(g, q, v, a, f_contact, tau, kin) for g in self.groups]

    # -- corruption --------------------------------------------------------
    def _split_eps(self, eps: torch.Tensor) -> list[torch.Tensor]:
        """One update's eps (B, n_eps) → per group (B, ns, ndim)."""
        out, o = [], 0
        for g in self.groups:
            n = g.ns * g.ndim
            out.append(eps[:, o:o + n].reshape(-1, g.ns, g.ndim))
            o += n
        return out

    @staticmethod
    def corrupt(g: SensorGroup, raw: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Measurement + eps (B, ns, ndim); the IMU quaternion is turned by
        the rotation vector eps[..., :3] on the right."""
        if g.type == "imu":
            quat = so3.quat_mul(raw[..., :4], so3.quat_exp(eps[..., :3]))
            return torch.cat([quat, raw[..., 4:] + eps[..., 3:]], dim=-1)
        return raw + eps

    def sample_eps(self, generator: torch.Generator, batch_size: int, bias_extra=None) -> torch.Tensor:
        """One update's corruption (B, n_eps): per group bias [+ the
        per-env ``bias_extra[group]`` (B, ns, ndim)] + noise_std·N(0, 1)."""
        parts = []
        for gi, g in enumerate(self.groups):
            n = torch.randn(batch_size, g.ns, g.ndim, generator=generator, device=generator.device)
            e = g.bias if bias_extra is None else g.bias + bias_extra[gi]
            parts.append((e + g.noise_std * n.to(g.bias)).reshape(batch_size, -1))
        return torch.cat(parts, dim=1)

    # -- ring buffers --------------------------------------------------------
    def init_buffers(self, batch_size: int) -> tuple:
        """Zero-filled ring buffers."""
        kw = dict(dtype=self.tree.dtype, device=self.tree.device)
        return tuple(torch.zeros(batch_size, g.ns, g.buf_len, g.dim, **kw) for g in self.groups)

    def reset(self, eps, q, v, a=None, f_contact=None, tau=None) -> tuple:
        """Ring buffers filled with one corrupted measurement (a, τ and
        the contact forces zero unless given)."""
        a = torch.zeros_like(v) if a is None else a
        tau = torch.zeros_like(v) if tau is None else tau
        if f_contact is None:
            f_contact = v.new_zeros(v.shape[0], self.tree.ncp, 3)
        raws = self.measure_all(q, v, a, f_contact, tau)
        return tuple(
            self.corrupt(g, raw, e)[:, :, None].expand(-1, -1, g.buf_len, -1).clone()
            for g, raw, e in zip(self.groups, raws, self._split_eps(eps))
        )

    def update(self, bufs: tuple, eps, q, v, a, f_contact, tau) -> tuple:
        """Push one corrupted measurement per sensor at slot 0; the older
        samples move one slot back and the oldest drops out."""
        raws = self.measure_all(q, v, a, f_contact, tau)
        return tuple(
            torch.cat([self.corrupt(g, raw, e)[:, :, None], buf[:, :, :-1]], dim=2)
            for g, buf, raw, e in zip(self.groups, bufs, raws, self._split_eps(eps))
        )

    def read(self, bufs: tuple) -> dict[str, torch.Tensor]:
        """Delayed measurements {type: (B, ns, dim)}: linear
        interpolation between slots i0 and i0 + 1 at delay/period
        (float32, as the reference computes it), the IMU quaternion
        renormalized."""
        out = {}
        for g, buf in zip(self.groups, bufs):
            steps = g.delay / np.float32(self.period)
            i0 = np.clip(np.floor(steps).astype(np.int64), 0, g.buf_len - 2)
            frac = (steps - i0).astype(np.float32)[:, None]
            w0 = torch.as_tensor(np.float32(1.0) - frac).to(buf)
            w1 = torch.as_tensor(frac).to(buf)
            s = torch.arange(g.ns, device=buf.device)
            i0 = torch.as_tensor(i0, device=buf.device)
            m = w0 * buf[:, s, i0] + w1 * buf[:, s, i0 + 1]
            if g.type == "imu":
                quat = m[..., :4]
                m = torch.cat([quat / torch.linalg.norm(quat, dim=-1, keepdim=True), m[..., 4:]], -1)
            out[g.type] = m
        return out

    def names(self, typ: str) -> tuple:
        """The names of the sensors of type ``typ``, in their group's
        order (empty without such a group)."""
        for g in self.groups:
            if g.type == typ:
                return g.name
        return ()

    def flatten_buffers(self, bufs: tuple) -> torch.Tensor:
        """Ring buffers → (B, n_buf) in [group][sensor][slot][dim] order,
        the kernel's layout."""
        return torch.cat([b.reshape(b.shape[0], -1) for b in bufs], dim=1)

    def unflatten_buffers(self, flat: torch.Tensor) -> tuple:
        out, o = [], 0
        for g in self.groups:
            n = g.ns * g.buf_len * g.dim
            out.append(flat[:, o:o + n].reshape(-1, g.ns, g.buf_len, g.dim))
            o += n
        return tuple(out)
