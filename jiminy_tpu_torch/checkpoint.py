"""Checkpoint and resume: whole training carries in a torch file.

Counterpart of ``jiminy_tpu/checkpoint.py`` (Orbax there). The carry of a
PPO run (params, optimizer state, the env batch as an ``EnvState`` with
its ``info``, the generators and the iteration) is saved whole, so that a
restored run continues exactly as it would have.

``torch.load`` runs with ``weights_only=True`` (its default since torch
2.6), which unpickles only tensors and plain containers. So the file
holds only tensors, dicts, lists, tuples, strings and numbers: an
``EnvState`` (and its ``SimState``) and a pipeline's ``WrapperState``
(nested to any depth) are stored as tagged dicts of their fields, a
``torch.Generator`` as its device and ``get_state()``, and all are
rebuilt on restore.

- :func:`save_checkpoint` / :func:`restore_checkpoint` (with a template,
  e.g. from the train fn's ``init``, whose devices the restored tensors
  take and whose structure and shapes they must match);
- :func:`restore_raw`: without a template, on one device (what
  ``tools/evaluate.py`` reads the params with);
- :class:`CheckpointManager`: step-indexed files ``<dir>/<step>.pt``,
  keeping the newest ``max_to_keep``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.envs.base import EnvState
from jiminy_tpu_torch.envs.pipeline import WrapperState

_ENV = "__env_state__"
_WRAP = "__wrapper_state__"
_GEN = "__generator__"
_ENV_FIELDS = ("obs", "reward", "terminated", "truncated", "steps")
_WRAP_FIELDS = ("inner", "layer", "obs", "info")


def _encode(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, torch.Generator):
        return {_GEN: str(x.device), "state": x.get_state()}
    if isinstance(x, EnvState):
        return {_ENV: {
            "sim": {k: _encode(getattr(x.sim, k)) for k in SimState.FIELDS},
            **{k: _encode(getattr(x, k)) for k in _ENV_FIELDS},
            "generator": _encode(x.generator),
            "info": _encode(x.info),
        }}
    if isinstance(x, WrapperState):
        return {_WRAP: {k: _encode(getattr(x, k)) for k in _WRAP_FIELDS}}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _generator(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def _decode(x, device: torch.device):
    """Stored form → objects, every tensor and generator on ``device``; a
    generator saved from another kind of device keeps its stored form."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict) and _GEN in x:
        if torch.device(x[_GEN]).type != device.type:
            return x
        return _generator(x["state"], device)
    if isinstance(x, dict) and _ENV in x:
        d = x[_ENV]
        return EnvState(
            sim=SimState(**{k: _decode(v, device) for k, v in d["sim"].items()}),
            **{k: _decode(d[k], device) for k in _ENV_FIELDS},
            generator=_decode(d["generator"], device),
            info=_decode(d["info"], device),
        )
    if isinstance(x, dict) and _WRAP in x:
        return WrapperState(**{k: _decode(v, device) for k, v in x[_WRAP].items()})
    if isinstance(x, dict):
        return {k: _decode(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v, device) for v in x)
    return x


def _restore_like(template, x, where: str = "state"):
    """Stored form → ``template``'s objects, each tensor and generator on
    its template counterpart's device; raises where the structure or a
    shape differs."""
    if isinstance(template, torch.Tensor):
        if not isinstance(x, torch.Tensor) or x.shape != template.shape:
            raise ValueError(f"checkpoint {where}: {getattr(x, 'shape', type(x))} where the "
                             f"template has {tuple(template.shape)}")
        return x.to(device=template.device)
    if isinstance(template, torch.Generator):
        return _generator(x["state"], template.device)
    if isinstance(template, EnvState):
        d = x[_ENV]
        return EnvState(
            sim=SimState(**{k: _restore_like(getattr(template.sim, k), d["sim"][k],
                                             f"{where}.sim.{k}") for k in SimState.FIELDS}),
            **{k: _restore_like(getattr(template, k), d[k], f"{where}.{k}")
               for k in _ENV_FIELDS},
            generator=_restore_like(template.generator, d["generator"]),
            info=_restore_like(template.info, d["info"], f"{where}.info"),
        )
    if isinstance(template, WrapperState):
        d = x[_WRAP]
        return WrapperState(**{k: _restore_like(getattr(template, k), d[k], f"{where}.{k}")
                               for k in _WRAP_FIELDS})
    if isinstance(template, dict):
        if set(template) != set(x):
            raise ValueError(f"checkpoint {where}: keys {sorted(x)}, template {sorted(template)}")
        return {k: _restore_like(v, x[k], f"{where}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(x):
            raise ValueError(f"checkpoint {where}: {len(x)} items, template {len(template)}")
        return type(template)(_restore_like(t, v, f"{where}[{i}]")
                              for i, (t, v) in enumerate(zip(template, x)))
    return x


def save_checkpoint(path: str | Path, state) -> None:
    """Save ``state`` (e.g. a PPO carry) to the file ``path``, written
    whole or not at all (a temporary file renamed into place)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_encode(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str | Path, template):
    """The state saved at ``path``, in ``template``'s structure and on its
    devices."""
    return _restore_like(template, torch.load(Path(path), map_location="cpu",
                                              weights_only=True))


def restore_raw(path: str | Path, device="cpu"):
    """The state saved at ``path`` (a file, or a :class:`CheckpointManager`
    directory: its newest step) without a template, its tensors and
    generators on ``device``. A generator saved from another kind of
    device (a CUDA generator's state does not fit a CPU one) stays in its
    stored form, ``{"__generator__": device, "state": ByteTensor}``."""
    path = Path(path)
    if path.is_dir():
        steps = CheckpointManager.steps_in(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = path / f"{steps[-1]}.pt"
    return _decode(torch.load(path, map_location="cpu", weights_only=True), torch.device(device))


class CheckpointManager:
    """Rolling checkpoints of a training loop: ``<directory>/<step>.pt``,
    the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    @staticmethod
    def steps_in(directory: Path) -> list:
        return sorted(int(p.stem) for p in Path(directory).glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state) -> None:
        save_checkpoint(self.directory / f"{int(step)}.pt", state)
        for old in self.steps_in(self.directory)[:-self.max_to_keep]:
            (self.directory / f"{old}.pt").unlink()

    def restore(self, template, step: int | None = None):
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return restore_checkpoint(self.directory / f"{int(step)}.pt", template)

    @property
    def latest_step(self) -> int | None:
        steps = self.steps_in(self.directory)
        return steps[-1] if steps else None
