"""The warp layouts of K1 and K3 on the CPU, no JAX.

- K1's shared-memory workspace (``ops/constraint_solve.py``
  ``warp_workspace``, checked by ``csrc/constraint_solve.cu``
  ``jt_check_chain_layout``) for the three systems of ``chip_smoke.py``'s
  phase 1 and for the caps: every region on 16 bytes, inside the env's
  slice and apart from every other; the row strides odd, X's at least
  nc + 1; the bytes per env and the envs per block.
- ``kernel_takes`` refuses a PGS group wider than a warp (the C entry
  does too), and ``Engine.auto_backend`` resolves as before: the chain
  kernel for the heightmap env, the whole-substep kernels for every other
  model ``chip_smoke.py`` drives, each of them a system K1 takes.
- The wrappers hand the C entry points what they bind: K3 the same
  workspace as K2 (``SubstepSpec.warp_workspace`` without the sensor
  stage), K1 its own; each argument list as long as its ctypes signature;
  every launch counted as one of the warp body. The libraries are stood in
  for by recorders, so nothing is built or launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types

import pytest
import torch

from jiminy_tpu_torch.engine.solver import BlockSpec
from jiminy_tpu_torch.ops import constraint_solve as cs
from jiminy_tpu_torch.ops import substep_kernel as sk
from jiminy_tpu_torch.ops._warp import SMEM_PER_BLOCK, WARP_MAX_W

# chip_smoke.py phase 1's systems (`phase_kernel_vs_plain`) and the caps
CONFIGS = {
    "anymal": cs.SolveConfig(n=18, nc=24, dt=5e-3, eq_blocks=(), bounds_span=(0, 12),
                             contact_colors=((12, 2), (18, 2)), iters=8),
    "cassie": cs.SolveConfig(n=22, nc=26, dt=2e-3, eq_blocks=(BlockSpec("equality", 0, 4),),
                             bounds_span=(4, 10), contact_colors=((14, 2), (20, 2)), iters=4,
                             relax=0.9),
    "atlas": cs.SolveConfig(n=29, nc=47, dt=2e-3, eq_blocks=(), bounds_span=(0, 23),
                            contact_colors=((23, 4), (35, 4)), iters=4),
    "caps": cs.SolveConfig(n=32, nc=48, dt=2e-3, eq_blocks=(), bounds_span=(0, 12),
                           contact_colors=((12, 12),), iters=8),
}
# bytes per env, as csrc/constraint_solve.cu's note and PERF.md give them
CHAIN_BYTES = {"anymal": 8304, "cassie": 10688, "atlas": 25040, "caps": 27904}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_workspace_layout(name):
    cfg = CONFIGS[name]
    ws = cs.warp_workspace(cfg)
    assert cs.warp_workspace(cfg) is ws  # built once
    n, nc, lds, regions = cfg.n, cfg.nc, ws.lds, ws.regions
    stride = ws.bytes_per_env // 4
    assert (ws.bytes_per_env, ws.W) == (CHAIN_BYTES[name], 4) and stride % 4 == 0
    assert ws.W == min(WARP_MAX_W, SMEM_PER_BLOCK // ws.bytes_per_env)
    assert lds["ldm"] >= n and lds["ldj"] >= n and lds["lda"] >= nc and lds["ldx"] >= nc + 1
    assert all(ld % 2 == 1 for ld in lds.values())
    sizes = dict(L=n * lds["ldm"], dL=n, p=n, v=n, J=nc * lds["ldj"], target=nc, mu=nc,
                 active=nc, lam=nc, X=n * lds["ldx"], A=nc * lds["lda"], rhs=nc, diag=nc,
                 vfree=n)
    assert {k: size for k, (_, size) in regions.items()} == sizes
    live = sorted((off, off + size, k) for k, (off, size) in regions.items())
    for off, end, k in live:
        assert off % 4 == 0 and 0 <= off and end <= stride, k
    for (_, end, a), (start, _, b) in zip(live, live[1:]):
        assert end <= start, f"{a} and {b} overlap"
    # the ints, as the C entry point reads them: the header, then the offsets
    assert ws.ints == (ws.W, stride, lds["ldm"], lds["ldj"], lds["ldx"], lds["lda"]) + tuple(
        regions[k][0] for k in ("L", "dL", "p", "v", "J", "target", "mu", "active", "lam", "X",
                                "A", "rhs", "diag", "vfree"))


@pytest.mark.parametrize("group", ["bounds_span", "color"])
def test_chain_refuses_a_group_wider_than_a_warp(group):
    """One row per lane: a bounds span of 33 rows, or a color of 33
    contacts, is not the chain kernel's (a color past 16 contacts is past
    nc ≤ 48 as well); neither ``kernel_takes`` nor ``warp_workspace``
    takes it, so the engine never routes it to a refusal."""
    if group == "bounds_span":
        cfg = cs.SolveConfig(n=32, nc=48, dt=1e-3, eq_blocks=(), bounds_span=(0, 33),
                             contact_colors=((33, 5),))
        widest = dataclasses.replace(cfg, bounds_span=(0, 32), contact_colors=((32, 5),))
    else:
        cfg = cs.SolveConfig(n=32, nc=99, dt=1e-3, eq_blocks=(), bounds_span=None,
                             contact_colors=((0, 33),))
        widest = dataclasses.replace(cfg, nc=48, contact_colors=((0, 16),))
    assert cs.kernel_takes(widest)
    assert not cs.kernel_takes(cfg)
    with pytest.raises(ValueError, match="does not take"):
        cs.warp_workspace(cfg)


def _engine(name):
    from jiminy_tpu_torch.envs import AntEnv, ANYmalEnv, CassieEnv, SpotmicroEnv

    make = {
        "anymal_perlin_grid": lambda: ANYmalEnv(terrain="perlin_grid", device="cpu"),
        "anymal": lambda: ANYmalEnv(observe="state", device="cpu"),
        "anymal_fourier": lambda: ANYmalEnv(terrain="fourier", device="cpu"),
        "cassie": lambda: CassieEnv(observe="state", device="cpu"),
        "cassie_selfcol": lambda: CassieEnv(observe="state", self_collision=True, device="cpu"),
        "cassie_flex": lambda: CassieEnv(observe="state", flexibility=True, device="cpu"),
        "ant": lambda: AntEnv(observe="state", device="cpu"),
        "spotmicro": lambda: SpotmicroEnv(observe="state", device="cpu"),
    }
    return make[name]().engine


@pytest.mark.parametrize("name, backend", [
    ("anymal_perlin_grid", "kernel"), ("anymal", "substep"), ("anymal_fourier", "substep"),
    ("cassie", "substep"), ("cassie_selfcol", "substep"), ("cassie_flex", "substep"),
    ("ant", "substep"), ("spotmicro", "substep"),
])
def test_auto_backend_resolves_as_before(name, backend):
    """``"auto"`` on the models the card run drives: the heightmap env on
    the chain kernel, every other on the whole-substep kernels; each one a
    system the chain kernel takes (its ``"kernel"`` path), with a layout."""
    from jiminy_tpu_torch.engine import Engine

    eng = _engine(name)
    assert eng.backend == backend == Engine.auto_backend(eng.substep_spec, eng.device)
    cfg = eng.substep_spec.cfg
    assert cs.kernel_takes(cfg) and cs.warp_workspace(cfg).W == 4


class _Recorder:
    """A C entry point that records the ints its layout pointer names."""

    def __init__(self, n_layout_arg):
        self.at = n_layout_arg  # the index of the layout's pointer; its length follows
        self.calls = []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        ptr, length = args[self.at], args[self.at + 1]
        self.calls.append(tuple(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[:length]))
        return 0


def _recording_lib(**entries):
    lib = types.SimpleNamespace(**entries)
    for fn in ("jt_warp_occupancy", "jt_solve_occupancy", "jt_substep_multi_sensors"):
        setattr(lib, fn, lambda *a: 0)
    lib.jt_error_string = lib.jt_substep_error_string = lambda err: b"recorded"
    return lib


@pytest.fixture
def no_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("name", ["anymal", "cassie_selfcol", "slab"])
def test_k3_takes_k2s_workspace(monkeypatch, no_stream, name):
    """K3's wrapper passes the C entry the layout K2's passes without the
    sensor stage, ``SubstepSpec.warp_workspace()``, and counts the launch
    as one of the warp body."""
    from test_torch_warp_workspace import _model

    spec = _model({"anymal": "anymal_state"}.get(name, name))[0]
    lib = _recording_lib(jt_substep=_Recorder(12 + 6 + 4), jt_substep_multi=_Recorder(14 + 8 + 4))
    sk.bind(lib)
    monkeypatch.setattr(sk, "_kernel", lambda randomized: lib)
    monkeypatch.setattr(sk, "_device_of", lambda *a: torch.device("cuda"))
    outputs = sk._outputs
    monkeypatch.setattr(sk, "_outputs", lambda s, B, device, extra=0: outputs(s, B, "cpu", extra))
    packed = spec.packed
    monkeypatch.setattr(spec, "packed", lambda device: packed("cpu"))
    t, B = spec.tree, 3
    q, v, tau, lam, w = (torch.zeros(B, k) for k in (t.nq, t.nv, t.nv, spec.nc, 6))
    before = sk.substep_batched.warp_launches, sk.substep_batched.launches
    sk.substep_batched(spec, q, v, tau, lam, w)
    assert (sk.substep_batched.warp_launches, sk.substep_batched.launches) == (
        before[0] + 1, before[1] + 1)
    if spec.torque is not None:
        sk.substep_batched_multi(spec, 1, q, v, torch.zeros(B, spec.torque.nm), lam, w)
        assert lib.jt_substep_multi.calls == lib.jt_substep.calls
    assert lib.jt_substep.calls == [spec.warp_workspace().ints]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_k1_takes_its_workspace(monkeypatch, no_stream, name):
    """K1's wrapper passes the C entry ``warp_workspace(cfg)``'s ints and
    counts the launch as one of the warp body."""
    cfg = CONFIGS[name]
    lib = _recording_lib(jt_solve_batched=_Recorder(11 + 3 + 2))
    cs.bind(lib)
    monkeypatch.setattr(cs, "_kernel", lambda: lib)
    B, n, nc = 2, cfg.n, cfg.nc
    args = [torch.zeros(B, *s) for s in ((n, n), (n,), (n,), (nc, n), (nc,), (nc,), (nc,), (nc,))]
    before = cs.solve_batched.warp_launches, cs.solve_batched.launches
    cs._launch(cfg, *args)
    assert (cs.solve_batched.warp_launches, cs.solve_batched.launches) == (
        before[0] + 1, before[1] + 1)
    assert lib.jt_solve_batched.calls == [cs.warp_workspace(cfg).ints]
