"""Robot descriptions from files: the URDF parser (:mod:`.urdf`) and the
STL reader it reduces ``<collision>`` meshes with (:mod:`.stl`)."""

from jiminy_tpu_torch.io.stl import read_stl  # noqa: F401
from jiminy_tpu_torch.io.urdf import load_urdf, parse_urdf  # noqa: F401
