"""jiminy_tpu_torch — the PyTorch/CUDA port of ``jiminy_tpu``.

The package mirrors ``jiminy_tpu``'s layout (``math/``, ``core/``,
``models/``, ``engine/``, ``hardware/``, ``ops/``, ``envs/``) so every
module has an obvious counterpart in the reference. Inside, it is plain
PyTorch: functions on ``(B, ...)`` tensors with the batch written out,
small dataclasses for the model and the engine, an explicit ``device=``
on every entry point and an explicit ``torch.Generator`` for resets.

Entry points default to ``device="cuda"`` and raise when no GPU is
present; tests and CPU users pass ``device="cpu"``. On a CUDA device the
constraint-solve chain runs as a hand-written CUDA kernel
(``csrc/constraint_solve.cu``); on the CPU its plain PyTorch version runs.

The package imports neither JAX nor ``jiminy_tpu``: what it needs from
the reference is ported, and models cross as numpy arrays
(:func:`jiminy_tpu_torch.core.tree.tree_from_arrays`).
"""

from __future__ import annotations

import torch

# f32 everywhere at full precision: the TF32 counterpart of the
# reference's `f32_matmul` rule (bf16/TF32 matmuls corrupt vmapped FK and
# flip contact activation — the 3×3 products here must stay exact f32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    GPU is present (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
