"""STL meshes, binary or ASCII, as numpy arrays.

The port's own copy of the reference's numpy-only reader
(``jiminy_tpu/viewer3d.py`` ``read_stl``), which the URDF parser uses to
reduce a ``<collision>`` mesh to contact points (``io/urdf.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_stl(path: str | Path, scale=1.0) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (3m, 3) float64, faces (m, 3) int32) of the STL file at
    ``path``, each vertex scaled by ``scale`` (a scalar or per axis). Every
    triangle keeps its own three vertices (no deduplication)."""
    raw = Path(path).read_bytes()
    scale = np.broadcast_to(np.asarray(scale, np.float64), (3,))
    if raw[:5] == b"solid" and b"facet" in raw[:1000]:  # ASCII
        nums = [[float(x) for x in line.split()[1:4]]
                for line in (ln.strip() for ln in raw.decode("ascii", "ignore").splitlines())
                if line.startswith("vertex")]
        tri = np.asarray(nums, np.float64).reshape(-1, 3, 3)
    else:  # binary: an 80-byte header, the count, then 50 bytes per triangle
        n = int(np.frombuffer(raw[80:84], "<u4")[0])
        body = np.frombuffer(raw[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
        tri = body[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    verts = (tri * scale).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces
