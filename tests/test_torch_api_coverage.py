"""Every public name of jiminy_tpu has a counterpart in jiminy_tpu_torch.

An ``ast`` walk over both packages (neither is imported): each public
top-level function and class of a reference module, and each public
method of such a class, must be defined in the port's module of the same
path (a method there may be a method, a property, a field or an
attribute set on ``self``), or stand in :data:`ELSEWHERE`, which names
the port's counterpart (``path::name``, checked to exist) or says why
there is none. An entry whose name the port's module now has is stale
and fails the test too.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = "jiminy_tpu", "jiminy_tpu_torch"

_LANE = ("one of the Pallas kernel's lane-vector helpers (lists of (B,) lanes); "
         "K2 and K3 do the same arithmetic in the CUDA device functions")
_MM = ("a small-matmul form for the TPU's vector unit; the port multiplies with matmul "
       "in float32 with TF32 off")
_PCG = "the module is named for its framework"

# reference module → {name: (the port's counterpart "path::name" or None, why)}
ELSEWHERE = {
    "core/algos.py": {
        "f32_matmul": (None, "forces true float32 matmuls on the TPU's MXU; the port sets "
                             "float32 with TF32 off once, for every matmul"),
    },
    "engine/constraints.py": {
        "ConstraintRows": (f"{PORT}/engine/constraints.py::DistanceConstraint.rows",
                           "every constraint's rows() returns the tuple (J, target, active)"),
    },
    "envs/blocks.py": {
        "MahonyFilterState": (f"{PORT}/envs/blocks.py::MahonyFilter.init",
                              "block states are dicts of per-env tensors"),
        "PDControllerState": (f"{PORT}/envs/blocks.py::PDControllerBlock.init",
                              "block states are dicts of per-env tensors"),
    },
    "envs/pipeline.py": {
        "WrapperState.rng": (f"{PORT}/envs/pipeline.py::WrapperState.generator",
                             "a torch.Generator takes the PRNG key's place"),
    },
    "math/spatial.py": {name: (None, _MM) for name in ("mm3", "mm3_bt", "mm_at_b", "mm_outer")},
    "native/__init__.py": {
        "load_codec": (f"{PORT}/telemetry.py::append_rows",
                       "the Python encoder writes the C++ codec's bytes"),
    },
    "ops/constraint_solve.py": {
        "solve_batched_pallas": (f"{PORT}/ops/constraint_solve.py::solve_batched",
                                 "K1's wrapper, which launches csrc/constraint_solve.cu"),
        "make_constraint_solver": (f"{PORT}/ops/constraint_solve.py::solve_batched",
                                   "a custom_vmap choosing the Pallas kernel under vmap; the "
                                   "port's calls are batched already"),
    },
    "ops/substep_kernel.py": {
        "substep_batched_pallas": (f"{PORT}/ops/substep_kernel.py::substep_batched",
                                   "K3's wrapper"),
        "substep_batched_pallas_multi": (f"{PORT}/ops/substep_kernel.py::substep_batched_multi",
                                         "K2's wrapper"),
        **{name: (f"{PORT}/csrc/substep.cuh::{cuda}", _LANE) for name, cuda in (
            ("v_cross", "cross3"), ("v_dot", "dot3"), ("m_mul", "mat3_mul"),
            ("m_vec", "mat3_vec"), ("m_tvec", "mat3t_vec"), ("quat_to_m", "quat_to_m"),
            ("motion_p2c", "motion_p2c"), ("force_c2p", "force_c2p"),
            ("inertia_mul_motion", "inertia_mul"), ("motion_cross6", "motion_cross"),
            ("force_cross6", "motion_cross_force"), ("x_compose", "jt_fk_body"),
            ("inertia_transform", "jt_composite_terms"))},
        **{name: (None, _LANE + ", written inline") for name in (
            "v3", "v_add", "v_sub", "v_scale", "m_add", "m_hat", "m_id", "m_t")},
    },
    "rl/launch.py": {
        "global_mesh": (f"{PORT}/rl/launch.py::global_group",
                        "a process group in place of a device mesh"),
    },
    "utils/pcg_jax.py": {name: (f"{PORT}/utils/pcg_torch.py::{name}", _PCG) for name in (
        "PCG32State", "pcg32_init", "pcg32_next", "pcg32_uniform")},
    "viewer3d.py": {
        "read_stl": (f"{PORT}/io/stl.py::read_stl", "beside the URDF parser that reads meshes"),
    },
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _class_names(node: ast.ClassDef, with_attributes: bool) -> set:
    """``Class.name`` for its public methods, and with ``with_attributes``
    its fields and the attributes its methods set on ``self``."""
    out = set()
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(item.name)
        elif with_attributes and isinstance(item, ast.AnnAssign):
            out.add(getattr(item.target, "id", ""))
        elif with_attributes and isinstance(item, ast.Assign):
            out.update(getattr(t, "id", "") for t in item.targets)
    if with_attributes:
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store)
                    and getattr(sub.value, "id", None) == "self"):
                out.add(sub.attr)
    return {f"{node.name}.{n}" for n in out if n and _public(n)}


def _names(package: str, with_attributes: bool) -> dict:
    """{module path in the package: its public names}."""
    out = {}
    for f in sorted((ROOT / package).rglob("*.py")):
        names = set()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and _public(node.name):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= _class_names(node, with_attributes)
        out[f.relative_to(ROOT / package).as_posix()] = names
    return out


@pytest.fixture(scope="module")
def walks():
    return _names(REF, False), _names(PORT, True)


def test_every_reference_name_has_a_counterpart(walks):
    ref, port = walks
    missing = [f"{mod}: {name}" for mod, names in ref.items() for name in sorted(names)
               if name not in port.get(mod, set()) and name not in ELSEWHERE.get(mod, {})]
    assert not missing, "public names of the reference with no counterpart in the port:\n" + \
        "\n".join(missing)
    assert sum(len(v) for v in ref.values()) > 400  # the walk saw the whole package


def test_exclusions_are_current(walks):
    ref, port = walks
    for mod, entries in ELSEWHERE.items():
        for name, (counterpart, why) in entries.items():
            assert name in ref.get(mod, set()), f"{mod}: {name} is not a reference name"
            assert name not in port.get(mod, set()), f"{mod}: {name} is ported there now"
            assert why, f"{mod}: {name} gives no reason"
            if counterpart is None:
                continue
            path, symbol = counterpart.split("::")
            assert (ROOT / path).is_file(), counterpart
            if path.endswith(".py"):
                assert symbol in port[Path(path).relative_to(PORT).as_posix()], counterpart
            else:
                assert re.search(rf"\b{symbol}\(", (ROOT / path).read_text()), counterpart
