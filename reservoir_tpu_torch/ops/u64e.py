"""Emulated unsigned 64-bit integers on pairs of uint32 words.

The port of the JAX package's ``ops/u64e.py``: a logical uint64 is a
trailing axis of 2, ``[..., 0]`` the low word and ``[..., 1]`` the high
word.  WIDE stream counters (``count_dtype="wide"``) carry a row's
``count`` and ``nxt`` so, which lets a row's stream pass 2^31 (where int32
counters saturate) and 2^32 without 64-bit integers on the device.

A state stores the words as a ``torch.uint32`` ``[R, 2]`` tensor (the JAX
package's layout, which checkpoints carry as it is).  torch on the CPU has
no uint32 add, shift or compare, so the functions here take any tensor of
32-bit words (uint32, or int32 bit patterns) or of uint32 values carried in
int64, and return the words as int64 values in ``[0, 2^32)``, as
:mod:`.threefry` carries them; every add and subtract is masked back, so a
result wraps modulo 2^64 as the reference's does and never relies on int64
overflow.  :func:`to_u32` turns a result into the stored layout.

Row-major ``[R, 2]`` (lo, hi) uint32 words have the bytes of a
little-endian ``[R]`` uint64, which is how the CUDA kernels read them.
"""

from __future__ import annotations

import torch

from .threefry import MASK32

__all__ = [
    "make",
    "from_int",
    "lo",
    "hi",
    "add_u32",
    "add_f32",
    "add64",
    "sub_u32",
    "sub64",
    "le",
    "lt",
    "is_zero",
    "mod64",
    "diff_small",
    "to_f32",
    "to_int",
    "words",
    "to_u32",
]

_TWO32 = float(2.0**32)


def words(x) -> torch.Tensor:
    """32-bit words (uint32, int32 bit patterns, or values in int64), a
    logical uint64's ``[..., 2]`` among them, as uint32 values in int64."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


def to_u32(a: torch.Tensor) -> torch.Tensor:
    """int64 word values ``[..., 2]`` as the stored ``torch.uint32`` layout."""
    a = words(a)
    return torch.where(a >= 2**31, a - 2**32, a).to(torch.int32).view(torch.uint32)


def make(lo_w, hi_w) -> torch.Tensor:
    """Pack ``(lo, hi)`` words into the trailing-axis-2 layout."""
    return torch.stack([words(lo_w), words(hi_w)], dim=-1)


def from_int(value: int, shape=(), device=None) -> torch.Tensor:
    """A constant logical uint64 broadcast to ``shape + (2,)``."""
    value = int(value)
    lo_w = torch.full(tuple(shape), value & MASK32, dtype=torch.int64, device=device)
    hi_w = torch.full(tuple(shape), (value >> 32) & MASK32, dtype=torch.int64, device=device)
    return make(lo_w, hi_w)


def lo(a) -> torch.Tensor:
    return words(a)[..., 0]


def hi(a) -> torch.Tensor:
    return words(a)[..., 1]


def add_u32(a, d) -> torch.Tensor:
    """``a + d`` for ``d`` a uint32 (carry-propagating)."""
    a, d = words(a), words(d)
    lo_n = (a[..., 0] + d) & MASK32
    carry = (lo_n < a[..., 0]).to(torch.int64)  # wrapped iff smaller
    return make(lo_n, (a[..., 1] + carry) & MASK32)


def _f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 (in int64) as XLA converts: NaN to 0, saturating."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.to(torch.float64).clamp(0.0, float(MASK32)).to(torch.int64)


def add_f32(a, f: torch.Tensor) -> torch.Tensor:
    """``a + floor(f)`` for non-negative float32 ``f`` (< 2^63).  The hi/lo
    split of ``f`` is exact in float32: ``f * 2^-32`` only moves the
    exponent, and the remainder lies on ``f``'s own grid."""
    a = words(a)
    f = torch.maximum(f, torch.zeros_like(f))
    hi_f = torch.floor(f * (1.0 / _TWO32))
    rem = f - hi_f * _TWO32
    lo_n = (a[..., 0] + _f32_to_u32(rem)) & MASK32
    carry = (lo_n < a[..., 0]).to(torch.int64)
    return make(lo_n, (a[..., 1] + _f32_to_u32(hi_f) + carry) & MASK32)


def add64(a, b) -> torch.Tensor:
    """``a + b`` for two logical uint64s (wrapping mod 2^64)."""
    a, b = words(a), words(b)
    lo_n = (a[..., 0] + b[..., 0]) & MASK32
    carry = (lo_n < a[..., 0]).to(torch.int64)
    return make(lo_n, (a[..., 1] + b[..., 1] + carry) & MASK32)


def sub_u32(a, d) -> torch.Tensor:
    """``a - d`` for ``d`` a uint32 (borrow-propagating, wrapping)."""
    a, d = words(a), words(d)
    borrow = (a[..., 0] < d).to(torch.int64)
    return make((a[..., 0] - d) & MASK32, (a[..., 1] - borrow) & MASK32)


def sub64(a, b) -> torch.Tensor:
    """``a - b`` for two logical uint64s (wrapping mod 2^64)."""
    a, b = words(a), words(b)
    borrow = (a[..., 0] < b[..., 0]).to(torch.int64)
    return make((a[..., 0] - b[..., 0]) & MASK32, (a[..., 1] - b[..., 1] - borrow) & MASK32)


def le(a, b) -> torch.Tensor:
    """``a <= b`` as a 64-bit unsigned compare."""
    a, b = words(a), words(b)
    return (a[..., 1] < b[..., 1]) | ((a[..., 1] == b[..., 1]) & (a[..., 0] <= b[..., 0]))


def lt(a, b) -> torch.Tensor:
    """``a < b`` as a 64-bit unsigned compare."""
    return ~le(b, a)


def is_zero(a) -> torch.Tensor:
    a = words(a)
    return (a[..., 0] == 0) & (a[..., 1] == 0)


def mod64(a, d) -> torch.Tensor:
    """``a mod d`` for logical uint64s, ``d >= 1``: the remainder the
    reference's restoring long division gives, computed without its 64
    steps.  Where ``d < 2^62`` it is int64 ``%`` (``a`` split at 2^63 where
    it is larger, every operand and sum then below 2^63); where ``d >=
    2^62`` the quotient is at most 3, so three conditional subtractions
    leave the remainder.  (``d = 0`` gives ``a``, as the division does.)"""
    a, d = words(a), words(d)
    a, d = torch.broadcast_tensors(a, d)
    small = d[..., 1] < 2**30
    dv = torch.where(small, (d[..., 1] << 32) | d[..., 0], torch.ones_like(d[..., 0])).clamp(min=1)
    a_low63 = ((a[..., 1] & 0x7FFFFFFF) << 32) | a[..., 0]  # a - 2^63 where a >= 2^63
    two63 = ((2**62 % dv) * 2) % dv
    r = torch.where(a[..., 1] >= 2**31, (a_low63 % dv + two63) % dv, a_low63 % dv)
    big = a
    for _ in range(3):
        big = torch.where(le(d, big)[..., None], sub64(big, d), big)
    out = torch.where(small[..., None], torch.stack([r & MASK32, r >> 32], dim=-1), big)
    return torch.where(is_zero(d)[..., None], a, out)


def diff_small(a, b) -> torch.Tensor:
    """``a - b`` as int32 for differences known to fit int32 (a tile-local
    position): the wrapping low-word difference, two's complement."""
    x = (lo(a) - lo(b)) & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def to_f32(a) -> torch.Tensor:
    """The approximate float32 value (telemetry, not sampling state)."""
    a = words(a)
    return a[..., 0].to(torch.float32) + _TWO32 * a[..., 1].to(torch.float32)


def to_int(a) -> int:
    """A scalar logical value as a Python int."""
    a = words(a)
    return int(a[..., 1]) * (1 << 32) + int(a[..., 0])
