"""Per-env model randomization: body masses, centres of mass, inertias,
armature, motor gains and friction, and sensor calibration offsets.

Counterpart of ``jiminy_tpu/engine/randomization.py``. A
:class:`ModelParams` holds the perturbations of a batch of envs, every
field with a leading (B,) axis. :meth:`ModelParams.apply_to_tree` turns
them into each env's inertial constants (:class:`Inertials`: mass, first
moment h = m·c and rotational inertia about the body origin, armature),
which ``core.algos.rnea`` and ``crba`` take in place of the tree's own;
geometry (kinematics, Jacobians, integration) stays on the nominal tree.
:class:`ModelRandomization` draws the parameters from a
``torch.Generator``, uniform per field.

The engine takes the perturbed constants and the motor gain and friction
scales as one packed row per env (``Engine._pack_model_params``;
``ops.substep_kernel`` ``SubstepSpec.n_mp``), which every backend reads.
"""

from __future__ import annotations

import dataclasses

import torch

from jiminy_tpu_torch.math.spatial import SpatialInertia


def _outer_shift(m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., nb) masses and (..., nb, 3) offsets → (..., nb, 3, 3) the
    parallel-axis term m·(cᵀc·E − c cᵀ) between origin and central
    inertia."""
    E = torch.eye(3, dtype=c.dtype, device=c.device)
    cc = torch.sum(c * c, dim=-1)[..., None, None]
    return m[..., None, None] * (cc * E - c[..., :, None] * c[..., None, :])


@dataclasses.dataclass(frozen=True)
class Inertials:
    """Each env's inertial constants: ``mass`` (B, nb), ``h`` (B, nb, 3),
    ``inertia`` (B, nb, 3, 3) about the body origin and ``armature``
    (B, nv). ``core.algos.rnea`` / ``crba`` read them as they read a
    tree's (``body_inertia``, ``armature``)."""

    mass: torch.Tensor
    h: torch.Tensor
    inertia: torch.Tensor
    armature: torch.Tensor

    def body_inertia(self, i: int) -> SpatialInertia:
        return SpatialInertia(mass=self.mass[:, i], h=self.h[:, i], inertia=self.inertia[:, i])


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Perturbations of a batch of envs' dynamic model:

    - ``mass_scale`` (B, nb): multiplies each body's mass;
    - ``com_offset`` (B, nb, 3): shifts each body's centre of mass [m]
      (the origin inertia follows by the parallel-axis theorem);
    - ``inertia_scale`` (B, nb): multiplies the central inertia, on top of
      the mass scale;
    - ``armature_scale`` (B, nv): multiplies the rotor inertia;
    - ``motor_gain`` (B, nm): multiplies each motor's reduction;
    - ``motor_friction_scale`` (B, nm): multiplies dry and viscous
      friction."""

    mass_scale: torch.Tensor
    com_offset: torch.Tensor
    inertia_scale: torch.Tensor
    armature_scale: torch.Tensor
    motor_gain: torch.Tensor
    motor_friction_scale: torch.Tensor

    FIELDS = ("mass_scale", "com_offset", "inertia_scale", "armature_scale", "motor_gain",
              "motor_friction_scale")

    @staticmethod
    def nominal(tree, motors=None, batch_size: int = 1) -> "ModelParams":
        """The identity perturbation of ``batch_size`` envs."""
        nm = motors.nm if motors is not None else 0
        kw = dict(dtype=tree.dtype, device=tree.device)
        B = batch_size
        return ModelParams(
            mass_scale=torch.ones(B, tree.nb, **kw),
            com_offset=torch.zeros(B, tree.nb, 3, **kw),
            inertia_scale=torch.ones(B, tree.nb, **kw),
            armature_scale=torch.ones(B, tree.nv, **kw),
            motor_gain=torch.ones(B, nm, **kw),
            motor_friction_scale=torch.ones(B, nm, **kw),
        )

    @property
    def batch_size(self) -> int:
        return self.mass_scale.shape[0]

    def to(self, device=None, dtype=None) -> "ModelParams":
        return ModelParams(*(getattr(self, k).to(device=device, dtype=dtype) for k in self.FIELDS))

    def apply_to_tree(self, tree) -> Inertials:
        """Each env's inertial constants, in the reference's order of
        operations: central inertia I_c = I_o − m·(cᵀc·E − c cᵀ), then
        m' = s·m, c' = c + Δc, I_c' = (s_I·s)·I_c, I_o' = I_c' + m'·(c'ᵀc'·E −
        c' c'ᵀ), h' = m'·c'. Massless bodies keep the tree's values exactly."""
        m = tree.inertia_mass
        dtype = m.dtype
        safe_m = torch.where(m > 0, m, torch.ones_like(m))
        c = tree.inertia_h / safe_m[:, None]
        I_c = tree.inertia_mat - _outer_shift(m, c)
        s = self.mass_scale.to(dtype)
        m2 = s * m
        c2 = c + self.com_offset.to(dtype)
        I_c2 = (self.inertia_scale.to(dtype) * s)[..., None, None] * I_c
        I_o2 = I_c2 + _outer_shift(m2, c2)
        h2 = m2[..., None] * c2
        keep = m > 0
        return Inertials(
            mass=torch.where(keep, m2, m),
            h=torch.where(keep[:, None], h2, tree.inertia_h),
            inertia=torch.where(keep[:, None, None], I_o2, tree.inertia_mat),
            armature=tree.armature * self.armature_scale.to(dtype),
        )


@dataclasses.dataclass(frozen=True)
class ModelRandomization:
    """Sampling ranges of :class:`ModelParams`, uniform per episode (the
    reference's fields and defaults). ``(lo, hi)`` multiplicative ranges;
    ``com_offset`` an absolute ± bound per axis [m]; ``sensor_bias`` a ±
    bound on a per-episode constant offset of every sensor channel
    (calibration error), drawn by :meth:`sample_sensor_bias`."""

    mass_scale: tuple = (0.9, 1.1)
    com_offset: float = 0.01
    inertia_scale: tuple = (0.9, 1.1)
    armature_scale: tuple = (1.0, 1.0)
    motor_gain: tuple = (0.95, 1.05)
    motor_friction_scale: tuple = (1.0, 1.0)
    sensor_bias: float = 0.0

    def sample(self, generator: torch.Generator, tree, motors=None,
               batch_size: int = 1) -> ModelParams:
        """``batch_size`` envs' parameters, each field U(lo, hi), drawn
        field after field on the generator's device, returned on the
        tree's device and in its dtype."""
        nm = motors.nm if motors is not None else 0
        B = batch_size

        def u(shape, rng):
            lo, hi = rng
            x = torch.rand(shape, generator=generator, device=generator.device)
            return (lo + (hi - lo) * x).to(device=tree.device, dtype=tree.dtype)

        return ModelParams(
            mass_scale=u((B, tree.nb), self.mass_scale),
            com_offset=u((B, tree.nb, 3), (-self.com_offset, self.com_offset)),
            inertia_scale=u((B, tree.nb), self.inertia_scale),
            armature_scale=u((B, tree.nv), self.armature_scale),
            motor_gain=u((B, nm), self.motor_gain),
            motor_friction_scale=u((B, nm), self.motor_friction_scale),
        )

    def sample_sensor_bias(self, generator: torch.Generator, suite, batch_size: int) -> tuple:
        """Per-episode additive offsets, one (B, ns, ndim) tensor per
        sensor group (the layout of ``group.bias``), U(−b, b)."""
        out = []
        for g in suite.groups:
            x = torch.rand(batch_size, g.ns, g.ndim, generator=generator, device=generator.device)
            out.append((self.sensor_bias * (2.0 * x - 1.0)).to(g.bias))
        return tuple(out)
