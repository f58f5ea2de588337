"""Training metrics logging: a JSONL sink and optional experiment trackers.

A copy of ``jiminy_tpu/rl/logging.py`` (which imports no JAX; the port
keeps its own copy). The canonical sink is ``metrics.jsonl`` in the run
directory, one JSON object per logged step; Weights & Biases and
TensorBoard attach as optional forwarders when their packages import.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only metrics sink with optional tracker forwarding.

    >>> logger = MetricsLogger(out_dir, run_name="anymal")
    >>> logger.log(step=it, metrics={"reward_mean": r, ...})
    """

    def __init__(
        self,
        out_dir: str | Path,
        run_name: str = "run",
        use_wandb: bool = False,
        use_tensorboard: bool = False,
        wandb_kwargs: dict | None = None,
    ):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._t0 = time.perf_counter()
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise ImportError(
                    "use_wandb=True but the wandb package is not "
                    "installed; install it or log offline (JSONL is "
                    "always written)"
                ) from e
            kw = dict(wandb_kwargs or {})
            self._wandb = wandb.init(
                project=kw.pop("project", "jiminy_tpu"),
                name=run_name,
                dir=str(self.dir),
                **kw,
            )
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "use_tensorboard=True but tensorboard is not available"
                ) from e
            self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))

    def log(self, step: int, metrics: dict) -> None:
        """Record one step's scalar metrics (values coerced to float)."""
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = int(step)
        row["wall_s"] = time.perf_counter() - self._t0
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str | Path) -> list[dict]:
    """Load a metrics.jsonl back as a list of dicts."""
    p = Path(path)
    if p.is_dir():
        p = p / "metrics.jsonl"
    return [json.loads(line) for line in p.read_text().splitlines() if line]
