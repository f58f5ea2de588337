"""Batched constraint-solve chain: the CUDA kernel and its plain version.

Counterpart of ``jiminy_tpu/ops/constraint_solve.py``. For every env:

    L = chol(M);  a_free = M⁻¹p;  v_free = v + dt·a_free
    MinvJT = M⁻¹Jᵀ;  A = J·MinvJT + reg·I;  rhs = target − J·v_free
    λ = PGS(A, rhs);  v⁺ = v_free + MinvJT·λ

:func:`solve_reference` is the plain PyTorch version (the reference's
``solve_reference``, batched). :func:`solve_batched` is the entry point:
on CUDA tensors it launches the hand-written kernel in
``csrc/constraint_solve.cu`` (one warp per env, the env's working set in
shared memory laid out by :func:`warp_workspace`; built with nvcc, loaded
with ctypes); on CPU tensors it runs the plain version. It never falls
back from one to the other. ``solve_batched.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from jiminy_tpu_torch import resolve_device
from jiminy_tpu_torch.engine.solver import pgs_solve_grouped
from jiminy_tpu_torch.math import linalg
from jiminy_tpu_torch.ops import _warp

# the chain kernel's caps (csrc/constraint_solve.cu JT_MAX_N, JT_MAX_NC;
# csrc/solve_chain.cuh JT_MAX_EQ, JT_MAX_COLORS), and the widest PGS group
# (a bounds span, a color's contacts): one row per lane of a warp
MAX_N, MAX_NC, MAX_EQ, MAX_COLORS, MAX_GROUP = 32, 48, 32, 16, 32
# the warp kernel's layout (csrc/constraint_solve.cu JT_CL_*): a header,
# then the offsets of its regions, all apart
_CHAIN_HEAD = ("W", "stride", "ldm", "ldj", "ldx", "lda")
_CHAIN_REGIONS = ("L", "dL", "p", "v", "J", "target", "mu", "active", "lam", "X", "A", "rhs",
                  "diag", "vfree")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Static shape/solver description (the reference's, field for
    field)."""

    n: int  # velocity dimension nv
    nc: int  # stacked constraint rows
    dt: float
    eq_blocks: tuple  # tuple of BlockSpec("equality", start, size)
    bounds_span: tuple | None  # (start, size) of contiguous λ ≥ 0 rows
    contact_colors: tuple  # ((start, n_contacts), ...), rows k×[t1,t2,n]
    iters: int = 8
    relax: float = 1.0
    reg: float = 1e-6
    compute_residual: bool = False


def kernel_takes(cfg: SolveConfig) -> bool:
    """Whether the chain kernel takes systems of this configuration: its
    sizes within the caps, and each PGS group (the bounds span, each
    color) one row per lane of a warp, as the C entry point asks."""
    span = cfg.bounds_span[1] if cfg.bounds_span is not None else 0
    return (cfg.n <= MAX_N and cfg.nc <= MAX_NC and len(cfg.eq_blocks) <= MAX_EQ
            and len(cfg.contact_colors) <= MAX_COLORS and span <= MAX_GROUP
            and all(k <= MAX_GROUP for _, k in cfg.contact_colors))


@functools.cache
def warp_workspace(cfg: SolveConfig) -> _warp.WarpWorkspace:
    """The chain kernel's shared-memory layout of one env for ``cfg``'s
    sizes (n, nc), not the caps: L (M copied, factored in place), its
    diagonal dL, p, v, J, target, mu, active, λ, X = M⁻¹[p | Jᵀ], the
    Delassus A, rhs, its diagonal and v_free, each region apart (L and A
    keep their own bytes); W, the envs per block, as many as fit one block
    up to ``WARP_MAX_W``. Raises ValueError for a configuration the kernel
    does not take (:func:`kernel_takes`)."""
    if not kernel_takes(cfg):
        raise ValueError(f"the chain kernel does not take n={cfg.n}, nc={cfg.nc} with its "
                         f"blocks (n ≤ {MAX_N}, nc ≤ {MAX_NC}, ≤ {MAX_EQ} equality blocks, ≤ "
                         f"{MAX_COLORS} colors, a bounds span or a color ≤ {MAX_GROUP} rows)")
    n, nc = cfg.n, cfg.nc
    lds = dict(ldm=n | 1, ldj=n | 1, ldx=(nc + 1) | 1, lda=nc | 1)
    sizes = dict(L=n * lds["ldm"], dL=n, p=n, v=n, J=nc * lds["ldj"], target=nc, mu=nc,
                 active=nc, lam=nc, X=n * lds["ldx"], A=nc * lds["lda"], rhs=nc, diag=nc,
                 vfree=n)
    regions, stride = _warp.pack(sizes, _CHAIN_REGIONS)
    nbytes = 4 * stride
    W = _warp.envs_per_block(nbytes, "the chain kernel's warp workspace")
    head = dict(W=W, stride=stride, **lds)
    ints = tuple(head[k] for k in _CHAIN_HEAD) + tuple(regions[k][0] for k in _CHAIN_REGIONS)
    return _warp.WarpWorkspace(regions=regions, lds=lds, bytes_per_env=nbytes, W=W, ints=ints)


def solve_reference(cfg: SolveConfig, M, p, v, J, target, mu, active, lam0):
    """Plain PyTorch chain: M (B,n,n), p/v (B,n), J (B,nc,n),
    target/mu/active/lam0 (B,nc) → (v⁺ (B,n), λ (B,nc), residual (B,)).
    ``active`` may be bool or 0/1 floats."""
    L = linalg.cholesky(M)
    a_free = linalg.cho_solve(L, p)
    v_free = v + cfg.dt * a_free
    MinvJT = linalg.cho_solve(L, J.transpose(-1, -2))  # (B, n, nc)
    eye = torch.eye(cfg.nc, dtype=M.dtype, device=M.device)
    A = J @ MinvJT + cfg.reg * eye
    rhs = target - (J @ v_free[:, :, None])[..., 0]
    lam, residual = pgs_solve_grouped(
        A, rhs, mu, active != 0,
        eq_blocks=list(cfg.eq_blocks),
        bounds_span=cfg.bounds_span,
        contact_colors=list(cfg.contact_colors),
        iters=cfg.iters,
        relax=cfg.relax,
        lam0=lam0,
        compute_residual=cfg.compute_residual,
    )
    v_next = v_free + (MinvJT @ lam[:, :, None])[..., 0]
    return v_next, lam, residual


def _layout(cfg: SolveConfig) -> list[int]:
    """The block structure as the kernel's flat int array."""
    out = [len(cfg.eq_blocks)]
    for blk in cfg.eq_blocks:
        out += [blk.start, blk.size]
    out += list(cfg.bounds_span) if cfg.bounds_span is not None else [0, 0]
    out.append(len(cfg.contact_colors))
    for s, k in cfg.contact_colors:
        out += [s, k]
    return out


@functools.cache
def _kernel():
    from jiminy_tpu_torch.ops import _build

    return bind(_build.load("constraint_solve"))


def bind(lib):
    """``lib``, the library built from ``csrc/constraint_solve.cu``, with
    its entry points' ctypes signatures set."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # arrays; B, n, nc; the PGS blocks and the workspace layout with their
    # lengths; iters, dt, relax, reg, residual; the stream
    lib.jt_solve_batched.argtypes = [vp] * 11 + [ci] * 3 + [vp, ci] * 2 + [ci, cf, cf, cf, ci, vp]
    lib.jt_solve_batched.restype = ci
    lib.jt_solve_occupancy.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.jt_solve_occupancy.restype = ci
    lib.jt_error_string.argtypes = [ci]
    lib.jt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.jt_error_string(err).decode()} (cudaError {err})")


def warp_blocks_per_sm(ws: _warp.WarpWorkspace) -> int:
    """Blocks of the chain kernel (W warps of ``ws``) one SM of the card
    holds at once, its registers and shared memory both counted
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _kernel()
    blocks = ctypes.c_int(0)
    _raise_on(lib, lib.jt_solve_occupancy(ws.W, ws.bytes_per_env, ctypes.byref(blocks)),
              "chain kernel occupancy")
    return blocks.value


def _launch(cfg: SolveConfig, M, p, v, J, target, mu, active, lam0):
    B, n, nc = M.shape[0], cfg.n, cfg.nc
    shapes = {
        "M": (M, (B, n, n)), "p": (p, (B, n)), "v": (v, (B, n)),
        "J": (J, (B, nc, n)), "target": (target, (B, nc)),
        "mu": (mu, (B, nc)), "active": (active, (B, nc)),
        "lam0": (lam0, (B, nc)),
    }
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"solve_batched: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"solve_batched: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"solve_batched: {name} must be contiguous")
    ws = warp_workspace(cfg)  # raises for a configuration the kernel does not take
    lib = _kernel()
    v_next = torch.empty((B, n), dtype=torch.float32, device=M.device)
    lam = torch.empty((B, nc), dtype=torch.float32, device=M.device)
    res = torch.empty((B,), dtype=torch.float32, device=M.device)
    layout = _layout(cfg)
    c_layout = (ctypes.c_int * len(layout))(*layout)
    c_ws = (ctypes.c_int * len(ws.ints))(*ws.ints)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    err = lib.jt_solve_batched(
        M.data_ptr(), p.data_ptr(), v.data_ptr(), J.data_ptr(),
        target.data_ptr(), mu.data_ptr(), active.data_ptr(),
        lam0.data_ptr(), v_next.data_ptr(), lam.data_ptr(), res.data_ptr(),
        B, n, nc, ctypes.cast(c_layout, ctypes.c_void_p), len(layout),
        ctypes.cast(c_ws, ctypes.c_void_p), len(ws.ints),
        cfg.iters, cfg.dt, cfg.relax, cfg.reg, int(cfg.compute_residual),
        stream,
    )
    _raise_on(lib, err, "constraint_solve kernel launch")
    solve_batched.launches += 1
    solve_batched.warp_launches += 1
    return v_next, lam, res


def solve_batched(
    cfg: SolveConfig, M, p, v, J, target, mu, active, lam0, device="cuda"
):
    """Batched chain on ``device``: M (B,n,n), p/v (B,n), J (B,nc,n),
    target/mu/active/lam0 (B,nc), all on ``device`` → (v⁺ (B,n),
    λ (B,nc), residual (B,)).

    On a CUDA device this launches the CUDA kernel (float32, contiguous
    inputs, ``active`` as 0/1 floats; one warp per env in the layout of
    :func:`warp_workspace`) and raises on anything else, a configuration
    it does not take (:func:`kernel_takes`) included; on the CPU it runs
    :func:`solve_reference`. A CUDA device without a GPU raises.
    ``.launches`` counts the launches, ``.warp_launches`` those that ran
    the warp body, which every launch does."""
    dev = resolve_device(device)
    for t in (M, p, v, J, target, mu, active, lam0):
        if t.device != dev and not (dev.index is None and t.device.type == dev.type):
            raise ValueError(
                f"solve_batched: tensor on {t.device}, expected {dev}"
            )
    if dev.type == "cpu":
        return solve_reference(cfg, M, p, v, J, target, mu, active, lam0)
    if dev.type != "cuda":
        raise ValueError(f"solve_batched: unsupported device {dev}")
    return _launch(cfg, M, p, v, J, target, mu, active, lam0)


solve_batched.launches = 0
solve_batched.warp_launches = 0  # of the above, those of the warp body: all
