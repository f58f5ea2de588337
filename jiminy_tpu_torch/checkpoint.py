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
  keeping the newest ``max_to_keep``; ``restore(..., partial=True)``
  restores the entries that the template and the file share.

Across ranks (``torch.distributed`` initialised, world size W > 1) every
function and method here is collective: every rank calls it, and rank 0
alone touches the file system. A save gathers the ranks' carries to rank
0, which writes one checkpoint of the global carry, as the reference's
Orbax checkpoint holds its sharded arrays: the replicated leaves once
(they must be bit-identical on every rank: params, Adam's state, the
iteration), the env-state rows of every rank in rank order (every tensor
of one dim or more inside an ``EnvState`` or ``WrapperState``, its
``info`` included: the rows that ``rl/distributed.py`` gives each rank;
every rank holds as many), every rank's generators in rank order, and W.

A restore at any world size W′ re-shards that carry, as Orbax restores
the reference's ``P(axis)`` arrays onto any mesh: the replicated leaves
come back as saved on every rank; rank r′ of W′ takes the global env
rows [r′·B/W′, (r′+1)·B/W′), as ``rl/distributed.py``'s ``shard_rows``
lays them out (``ValueError`` naming B, W and W′ where B does not divide
by W′); and the generators follow the rule of ``rl/distributed.py``'s
``rank_generators``: at W′ = W each rank gets its own back, bit for bit;
at W′ ≠ W rank 0 takes rank 0's saved generators (so W′ = 1 continues as
the single-device run from rank 0's draws) and each rank r′ > 0 derives
its env generator (the one inside its env state) and its run generator
(the one outside it) from rank 0's saved run generator and r′, on the
template's device. A checkpoint of one process (W = 1) re-shards the
same way.
:func:`restore_raw` of a multi-rank checkpoint returns the global carry,
each generator a list of the ranks' generators. A failure on any rank
raises on every rank, and a save is listed and restored only once it is
whole. Without a group, or at world size 1, a checkpoint is the carry
alone, as before.

Every env-state tensor of one dim or more is taken as per-env rows; the
env states of every env that PPO trains hold no other
(``tests/test_torch_checkpoint_restart.py`` walks them).
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import torch
import torch.distributed as dist

from jiminy_tpu_torch.engine.engine import SimState
from jiminy_tpu_torch.envs.base import EnvState
from jiminy_tpu_torch.envs.pipeline import WrapperState
from jiminy_tpu_torch.rl.distributed import rank_generators

_ENV = "__env_state__"
_WRAP = "__wrapper_state__"
_GEN = "__generator__"
_RANKS = "__ranks__"  # a checkpoint of W > 1 ranks: {_RANKS: W, "state": the global carry}
_PER_RANK = "__per_rank__"  # every rank's generator, in rank order
_DERIVED = "__derived__"  # a generator that rank_generators derives at the restore
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
    if isinstance(x, dict) and _PER_RANK in x:
        return [_decode(g, device) for g in x[_PER_RANK]]
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
        if _DERIVED in x:
            d = x[_DERIVED]
            source = _generator(d["source"]["state"], d["source"][_GEN])
            env_gen, run_gen = rank_generators(source, d["rank"], template.device)
            return env_gen if d["env"] else run_gen
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


def _restore_partial(template, x, where: str = "state"):
    """:func:`_restore_like` over the dict entries present in both
    ``template`` and ``x``; the template's own value where ``x`` lacks
    one."""
    if isinstance(template, dict) and isinstance(x, dict) and not (_ENV in x or _WRAP in x):
        return {k: _restore_partial(v, x[k], f"{where}.{k}") if k in x else v
                for k, v in template.items()}
    return _restore_like(template, x, where)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _portable(e: Exception) -> Exception:
    """``e``, or a RuntimeError naming it where ``e`` cannot be pickled to
    the other ranks."""
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _on_rank0(fn, scatter: bool = False):
    """``fn()`` on rank 0 of W > 1 ranks (on the one process otherwise);
    its result on every rank, or, with ``scatter``, item r of its result
    on rank r. The exception it raises, raised on every rank."""
    if _world() == 1:
        return fn()[0] if scatter else fn()
    ok, value = True, None
    if dist.get_rank() == 0:
        try:
            value = fn()
        except Exception as e:  # raised below on every rank, rank 0 included
            ok, value = False, _portable(e)
    box = [(ok, value if not (ok and scatter) else None)]
    dist.broadcast_object_list(box, src=0)
    ok, shared = box[0]
    if not ok:
        raise shared
    if not scatter:
        return shared
    mine = [None]
    dist.scatter_object_list(mine, value if dist.get_rank() == 0 else None, src=0)
    return mine[0]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-identical (NaNs included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _merge(parts: list, rows: bool = False, where: str = "state"):
    """The ranks' stored forms → the global carry's (see the module
    docstring); raises ValueError where a replicated leaf differs between
    ranks or the ranks' rows differ in shape."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        if rows and x.dim():
            if any(p.shape != x.shape for p in parts):
                raise ValueError(f"checkpoint {where}: the ranks hold rows of shapes "
                                 f"{[tuple(p.shape) for p in parts]}, not one shape")
            return torch.cat(parts)
        if not all(_same(p, x) for p in parts):
            raise ValueError(f"checkpoint {where}: differs between ranks, where only env-state "
                             f"rows and generators may")
        return x
    if isinstance(x, dict) and _GEN in x:
        return {_PER_RANK: parts}
    if isinstance(x, dict):
        if any(set(p) != set(x) for p in parts):
            raise ValueError(f"checkpoint {where}: the ranks' keys differ")
        return {k: _merge([p[k] for p in parts], rows or k in (_ENV, _WRAP), f"{where}.{k}")
                for k in x}
    if isinstance(x, (list, tuple)):
        if any(len(p) != len(x) for p in parts):
            raise ValueError(f"checkpoint {where}: the ranks' lengths differ")
        return type(x)(_merge([p[i] for p in parts], rows, f"{where}[{i}]")
                       for i in range(len(x)))
    if any(p != x for p in parts):
        raise ValueError(f"checkpoint {where}: {parts} differs between ranks")
    return x


def _is_gen(x) -> bool:
    return isinstance(x, dict) and (_GEN in x or _PER_RANK in x)


def _gens(x, rows: bool = False) -> list:
    """(inside an env state, rank 0's stored form) of every generator of
    the global carry's stored form ``x``, in order."""
    if _is_gen(x):
        return [(rows, x[_PER_RANK][0] if _PER_RANK in x else x)]
    if isinstance(x, dict):
        return [g for k, v in x.items() for g in _gens(v, rows or k in (_ENV, _WRAP))]
    if isinstance(x, (list, tuple)):
        return [g for v in x for g in _gens(v, rows)]
    return []


def _split(x, rank: int, world: int, saved: int, source=None, rows: bool = False,
           where: str = "state"):
    """Rank ``rank`` of ``world``'s part of the stored form ``x`` of a
    global carry that ``saved`` ranks wrote (the module docstring);
    ``source``: rank 0's saved run generator, which the other ranks
    derive theirs from where ``world`` differs from ``saved``."""
    if isinstance(x, torch.Tensor):
        if rows and x.dim():
            if x.shape[0] % world:
                raise ValueError(f"checkpoint {where}: {x.shape[0]} env rows, saved by {saved} "
                                 f"ranks, do not divide among {world} ranks")
            n = x.shape[0] // world
            return x[rank * n:(rank + 1) * n].clone()  # pickled alone, not with every row
        return x
    if _is_gen(x):
        if world == saved or rank == 0:
            return x[_PER_RANK][rank] if _PER_RANK in x else x
        return {_DERIVED: {"rank": rank, "env": rows, "source": source}}
    if isinstance(x, dict):
        return {k: _split(v, rank, world, saved, source, rows or k in (_ENV, _WRAP),
                          f"{where}.{k}") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_split(v, rank, world, saved, source, rows, f"{where}[{i}]")
                       for i, v in enumerate(x))
    return x


def _load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _parts(path: Path, world: int) -> list:
    """Each of ``world`` ranks' stored form of the checkpoint at ``path``,
    saved at any world size (the module docstring)."""
    x = _load(path)
    saved = x[_RANKS] if isinstance(x, dict) and _RANKS in x else 1
    if saved == world == 1:
        return [x]
    state = x["state"] if saved > 1 else x
    # rank 0's run generator: the first outside the env states (the
    # PPO carry's only one), else the env state's
    gens = sorted(_gens(state), key=lambda g: g[0]) if world != saved else []
    source = gens[0][1] if gens else None
    return [_split(state, r, world, saved, source) for r in range(world)]


def _write(path: Path, obj) -> None:
    """``obj`` to ``path``, whole or not at all: a temporary file of this
    process renamed into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_checkpoint(path: str | Path, state) -> None:
    """Save ``state`` (e.g. a PPO carry) to the file ``path``, written
    whole or not at all. Across ranks every rank calls it with its own
    carry, and the file holds the global one (the module docstring)."""
    path, world = Path(path), _world()
    if world == 1:
        _write(path, _encode(state))
        return
    try:
        mine = _encode(state)
    except Exception as e:  # the other ranks must not wait for this rank's part
        mine = _portable(e)
    parts = [None] * world if dist.get_rank() == 0 else None
    dist.gather_object(mine, parts, dst=0)

    def write():
        for r, p in enumerate(parts):
            if isinstance(p, Exception):
                raise RuntimeError(f"checkpoint {path}: rank {r} failed: {type(p).__name__}: {p}")
        _write(path, {_RANKS: world, "state": _merge(parts)})

    _on_rank0(write)


def restore_checkpoint(path: str | Path, template):
    """The state saved at ``path``, in ``template``'s structure and on its
    devices; across ranks, this rank's part of it, re-sharded where it
    was saved at another world size (the module docstring)."""
    return _restore_like(template, _on_rank0(lambda: _parts(Path(path), _world()), scatter=True))


def _newest(path: Path) -> Path:
    """``path``, or the newest step's file if it is a directory."""
    if not path.is_dir():
        return path
    steps = _steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {path}")
    return path / f"{steps[-1]}.pt"


def restore_raw(path: str | Path, device="cpu"):
    """The state saved at ``path`` (a file, or a :class:`CheckpointManager`
    directory: its newest step) without a template, its tensors and
    generators on ``device``; of a checkpoint saved across ranks the
    global carry, each generator a list of the ranks' in rank order. A
    generator saved from another kind of device (a CUDA generator's state
    does not fit a CPU one) stays in its stored form, ``{"__generator__":
    device, "state": ByteTensor}``."""
    x = _on_rank0(lambda: _load(_newest(Path(path))))
    if isinstance(x, dict) and _RANKS in x:
        x = x["state"]
    return _decode(x, torch.device(device))


def _steps(directory: Path) -> list:
    return sorted(int(p.stem) for p in Path(directory).glob("*.pt") if p.stem.isdigit())


class CheckpointManager:
    """Rolling checkpoints of a training loop: ``<directory>/<step>.pt``,
    the newest ``max_to_keep`` kept. Across ranks every method is
    collective (the module docstring)."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory)
        _on_rank0(lambda: self.directory.mkdir(parents=True, exist_ok=True))
        self.max_to_keep = max_to_keep

    @staticmethod
    def steps_in(directory: Path) -> list:
        return _on_rank0(lambda: _steps(directory))

    def save(self, step: int, state) -> None:
        save_checkpoint(self.directory / f"{int(step)}.pt", state)

        def prune():
            for old in _steps(self.directory)[:-self.max_to_keep]:
                (self.directory / f"{old}.pt").unlink()

        _on_rank0(prune)

    def restore(self, template, step: int | None = None, partial: bool = False):
        """The checkpoint of ``step`` (default: the newest) in
        ``template``'s structure. ``partial=True`` restores only the
        entries present in both, at any depth, and keeps the template's
        own elsewhere: a checkpoint written before fields were added or
        removed still restores."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self.directory / f"{int(step)}.pt"
        if not partial:
            return restore_checkpoint(path, template)
        return _restore_partial(template, _on_rank0(lambda: _parts(path, _world()), scatter=True))

    def close(self) -> None:
        """Nothing to release: every save is written whole when it
        returns (kept for the reference's interface)."""

    @property
    def latest_step(self) -> int | None:
        steps = self.steps_in(self.directory)
        return steps[-1] if steps else None
