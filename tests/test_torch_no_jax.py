"""The port reaches neither JAX nor the reference package.

The machine with the GPU has no jax, flax, optax or orbax, so every
module of ``jiminy_tpu_torch`` and ``chip_smoke.py`` must import without
them. In a fresh interpreter a ``sys.meta_path`` finder refuses the
top-level names below (exact names: ``jiminy_tpu_torch`` still loads);
then every module of the port is imported, ``chip_smoke`` is imported
without running, and one CPU env step is taken at B = 2.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "jiminy_tpu"}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ImportError(f"import of {name!r} refused")
        return None


sys.meta_path.insert(0, Refuse())
try:
    import jiminy_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the finder did not refuse jiminy_tpu")

import jiminy_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(jiminy_tpu_torch.__path__, "jiminy_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (module only: main() is not run)

import torch
from jiminy_tpu_torch.envs import ANYmalEnv

env = ANYmalEnv(device="cpu")
st = env.reset(torch.Generator().manual_seed(0), 2)
st = env.step(st, torch.zeros(2, 12))
assert bool(torch.isfinite(st.sim.q).all()) and st.obs.shape == (2, 33)
leaked = sorted(k for k in sys.modules if k.partition(".")[0] in BLOCKED)
assert not leaked, leaked
print("NO_JAX_OK", len(mods))
"""


def test_port_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
    assert int(r.stdout.split("NO_JAX_OK")[1]) >= 20  # every port module walked
