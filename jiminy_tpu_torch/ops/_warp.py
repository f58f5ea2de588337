"""What the warp kernels' layouts share on the host.

K1 (``csrc/constraint_solve.cu``), K3 and K2 (``csrc/substep_warp.cuh``)
run one warp per env with the env's working set in a slice of the block's
dynamic shared memory. The host lays each slice out from the model's own
sizes (:func:`pack`), picks the envs per block (:func:`envs_per_block`)
and hands the C entry point the layout as ints, which it checks before a
launch (``csrc/solve_chain.cuh``: ``jt_block_fits``, ``jt_regions_ok``).
"""

from __future__ import annotations

import dataclasses

# envs (warps) per block at most (csrc/solve_chain.cuh JT_WARP_MAX_W) and
# the shared memory one block may take on an H100 (JT_SMEM_PER_BLOCK)
WARP_MAX_W, SMEM_PER_BLOCK = 4, 232_448


@dataclasses.dataclass(frozen=True)
class WarpWorkspace:
    """Shared-memory layout of one env of a warp kernel: ``regions`` maps
    each region to its (offset, size) in floats from the env's slice (for
    K3 and K2 the regions outside ``"union"`` live throughout and each view
    of the union lies inside it and lives at its own time; K1's regions are
    all apart), ``lds`` the row strides (odd: no two lanes of a column on
    one bank), ``bytes_per_env`` the slice, ``W`` the envs per block and
    ``ints`` the layout as the C entry point reads and checks it."""

    regions: dict
    lds: dict
    bytes_per_env: int
    W: int
    ints: tuple


def _align(n: int) -> int:
    """``n`` floats rounded up to 16 bytes."""
    return -(-n // 4) * 4


def pack(sizes: dict, names, at: int = 0) -> tuple[dict, int]:
    """The regions ``names`` (sizes in floats, from ``sizes``) one after
    another from offset ``at``, each on 16 bytes: ({name: (offset, size)},
    the offset past the last)."""
    regions = {}
    for name in names:
        regions[name] = (at, sizes[name])
        at += _align(sizes[name])
    return regions, at


def envs_per_block(nbytes: int, who: str) -> int:
    """W, as many envs of ``nbytes`` as fit one block, up to WARP_MAX_W;
    raises ValueError when not one does."""
    W = min(WARP_MAX_W, SMEM_PER_BLOCK // nbytes)
    if W < 1:
        raise ValueError(f"{who}: a workspace of {nbytes} B per env exceeds one block's "
                         f"{SMEM_PER_BLOCK} B")
    return W
