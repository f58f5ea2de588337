"""PCG32 on batched device tensors, bit for bit the reference's stream.

Counterpart of ``jiminy_tpu/utils/pcg_jax.py`` (PCG-XSH-RR with a 64-bit
state, the stream of ``utils.random.PCG32`` and of the C++ reference).
PyTorch has no uint64 arithmetic on every device, so the state is two
int64 tensors holding its 32-bit halves, and every product is formed from
16-bit limbs, whose partial sums stay inside int64. Any batch shape works:
each element is its own generator.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK32 = 0xFFFFFFFF
_MULT_HI = 0x5851F42D  # 6364136223846793005 >> 32
_MULT_LO = 0x4C957F2D


@dataclasses.dataclass(frozen=True)
class PCG32State:
    """The 64-bit state and increment, as 32-bit halves in int64 tensors."""

    state_hi: torch.Tensor
    state_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _MASK32, lo & _MASK32


def _mul32(x, y):
    """(hi, lo) of the 64-bit product of two uint32 values."""
    x0, x1 = x & 0xFFFF, x >> 16
    y0, y1 = y & 0xFFFF, y >> 16
    p00, p01, p10, p11 = x0 * y0, x0 * y1, x1 * y0, x1 * y1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _MASK32
    return hi, lo


def _mul64(ah, al, bh, bl):
    """The low 64 bits of a·b."""
    hi, lo = _mul32(al, bl)
    cross = (_mul32(al, bh)[1] + _mul32(ah, bl)[1]) & _MASK32
    return (hi + cross) & _MASK32, lo


def _step(st: PCG32State) -> PCG32State:
    hi, lo = _mul64(st.state_hi, st.state_lo, _MULT_HI, _MULT_LO)
    hi, lo = _add64(hi, lo, st.inc_hi, st.inc_lo)
    return dataclasses.replace(st, state_hi=hi, state_lo=lo)


def pcg32_init(seed, stream: int = 0x14057B7EF767814F >> 1, device="cuda") -> PCG32State:
    """Generators seeded ``seed`` (an int or an integer tensor of any
    shape, taken modulo 2³²) on ``stream``, on ``device``."""
    from jiminy_tpu_torch import resolve_device

    dev = resolve_device(device)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev) & _MASK32
    inc = (int(stream) << 1) | 1
    full = lambda x: torch.full_like(seed, x)  # noqa: E731
    st = PCG32State(state_hi=full(0), state_lo=full(0),
                    inc_hi=full((inc >> 32) & _MASK32), inc_lo=full(inc & _MASK32))
    st = _step(st)
    hi, lo = _add64(st.state_hi, st.state_lo, 0, seed)
    return _step(dataclasses.replace(st, state_hi=hi, state_lo=lo))


def pcg32_next(st: PCG32State) -> tuple[PCG32State, torch.Tensor]:
    """(next state, the uint32 output as int64), PCG-XSH-RR."""
    old_hi, old_lo = st.state_hi, st.state_lo
    st = _step(st)
    # xorshifted = ((state >> 18) ^ state) >> 27, on the 64-bit value
    x_hi = (old_hi >> 18) ^ old_hi
    x_lo = (((old_lo >> 18) | (old_hi << 14)) & _MASK32) ^ old_lo
    xorshifted = ((x_lo >> 27) | (x_hi << 5)) & _MASK32
    rot = old_hi >> 27
    out = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
    return st, out


def pcg32_uniform(st: PCG32State, lo=0.0, hi=1.0) -> tuple[PCG32State, torch.Tensor]:
    """(next state, a float32 uniform in [lo, hi)) as the reference
    computes it: lo + (hi − lo)·(u / 2³²) in float32."""
    st, u = pcg32_next(st)
    return st, lo + (hi - lo) * (u.to(torch.float32) / 4294967296.0)
