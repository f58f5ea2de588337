"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with
ctypes.

Every ``*.cu`` under ``jiminy_tpu_torch/csrc/`` becomes its own shared
library with a plain C interface, compiled for Hopper (``sm_90a``) into
``jiminy_tpu_torch/_build/`` at first use, all sources at once (one nvcc
process each). Libraries are cached by a hash of the sources, the
headers, the nvcc binary and its flags, so an unchanged checkout builds
once. No PyTorch headers and no ninja are involved: nvcc alone, seconds
per source.

A missing nvcc or a failed build raises with nvcc's own output; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME, or the toolkit's default
    install prefix. Raises RuntimeError when there is none."""
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels of jiminy_tpu_torch need "
        "the CUDA toolkit to build"
    )


def _digest(src: Path, nvcc: str) -> str:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str, nvcc: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(CSRC / f'{name}.cu', nvcc)}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is not cached, all at once.
    Returns {source name: build seconds} (0.0 for a cached library)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    seconds: dict[str, float] = {}
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = library_path(src.stem, nvcc)
        if out.exists():
            seconds[src.stem] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src.stem, proc, tmp, out, time.perf_counter()))
    failures = []
    for name, proc, tmp, out, t0 in jobs:  # wait for every process
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all()
    return ctypes.CDLL(str(library_path(name, find_nvcc())))
