"""Salted 64-bit scrambling for distinct-value (bottom-k) sampling.

The port's own copy of the JAX package's ``ops/hashing.py``: a 6-round
Feistel permutation over a ``(hi, lo)`` pair of uint32 words, with the
murmur3 32-bit finalizer :func:`fmix32` as the round function and two 64-bit
salts ``r0``, ``r1`` xored in before the first and the fourth round.  Per
reservoir salts make the order of the scrambled hashes an independent
uniform order of the distinct values, so the k smallest hashes are a
uniform sample of them.  Being a permutation, the scramble never maps two
distinct 64-bit values to one hash.

The functions take either backend:

- torch tensors carrying uint32 words in int64 (``[0, 2^32)``), because
  torch on the CPU has no uint32 add or shift (see :mod:`.threefry`);
  multiplications are split into 16-bit halves so no product leaves int64;
- numpy ``uint32`` arrays, whose arithmetic wraps by itself.

The host oracle (:class:`~reservoir_tpu_torch.oracle.BottomKOracle`) takes
the 64-bit forms: :func:`scramble64_int` on Python ints for one element,
:func:`scramble64_array` on an int64/uint64 array, and
:func:`draw_salts` for its salts; :func:`as_scalar_hash` turns a tile hash
into the oracle's scalar one.  Every operation is modular, so all of them
give the JAX package's words bit for bit, and so does ``csrc/hashing.cuh``.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .threefry import MASK32

#: the low 32 bits of an int (the reference's name for ``MASK32``)
U32_MASK = MASK32

__all__ = [
    "U32_MASK",
    "as_scalar_hash",
    "default_hash64",
    "draw_salts",
    "fmix32",
    "scramble64",
    "scramble64_array",
    "scramble64_int",
    "salt_for_target",
    "words",
    "to_i32",
]

# the per-round constants of the JAX package's scramble
_ROUND_CONSTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B1)
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35


def words(x: torch.Tensor) -> torch.Tensor:
    """A tensor of 32-bit words (int32 or uint32) as uint32 values in int64."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`words`: uint32 values carried in int64 as int32
    bit patterns (exact, with no out-of-range cast)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul(x, c: int):
    """``x * c mod 2^32``; ``c * (x mod 2^16)`` and ``(c >> 16) * x`` both
    stay below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def fmix32(x):
    """murmur3's 32-bit finalizer, a full-avalanche permutation of uint32."""
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 13)
    x = _mul(x, _M2)
    return x ^ (x >> 16)


def _round(hi, lo, c: int):
    return lo, hi ^ fmix32((lo + c) & MASK32)


def scramble64(hi, lo, r0_hi, r0_lo, r1_hi, r1_lo):
    """The keyed 64-bit permutation of ``(hi, lo)`` under the salts ``r0``
    and ``r1``; every argument is a uint32 word array (or a broadcastable
    one) of one backend."""
    hi, lo = hi ^ r0_hi, lo ^ r0_lo
    for c in _ROUND_CONSTS[:3]:
        hi, lo = _round(hi, lo, c)
    hi, lo = hi ^ r1_hi, lo ^ r1_lo
    for c in _ROUND_CONSTS[3:]:
        hi, lo = _round(hi, lo, c)
    return hi, lo


def default_hash64(value):
    """The default element hash: the 4-byte value's bits as ``lo`` and their
    sign extension as ``hi`` (int32 and uint32 alike: a uint32 value is
    taken as its int32 bit pattern, as the JAX package does).  Takes a torch
    int32/uint32 tensor or a numpy array of a 4-byte integer type."""
    if isinstance(value, torch.Tensor):
        lo = words(value)
        return (lo >> 31) * MASK32, lo
    i32 = np.asarray(value).astype(np.int32)
    return (i32 >> 31).view(np.uint32), i32.view(np.uint32)


def salt_for_target(
    value: Tuple[int, int], target: Tuple[int, int], r0: Tuple[int, int]
) -> Tuple[int, int]:
    """The salt ``r1`` that, with ``r0``, scrambles ``value`` to ``target``
    (each a ``(hi, lo)`` pair of ints): the first three rounds run forward
    from the value, the last three backward from the target, and ``r1`` is
    the xor of the two midpoints.  It builds states where a value's hash is
    exactly ``(MAX, MAX)``, the hash a full tile's update never takes."""
    hi, lo = np.uint32(value[0] ^ r0[0]), np.uint32(value[1] ^ r0[1])
    with np.errstate(over="ignore"):
        for c in _ROUND_CONSTS[:3]:
            hi, lo = _round(hi, lo, c)
        t_hi, t_lo = np.uint32(target[0]), np.uint32(target[1])
        for c in reversed(_ROUND_CONSTS[3:]):
            # the inverse of (hi, lo) -> (lo, hi ^ f(lo + c))
            t_hi, t_lo = t_lo ^ fmix32((t_hi + c) & MASK32), t_hi
    return int(hi ^ t_hi), int(lo ^ t_lo)


def _split_u64(x: int) -> Tuple[int, int]:
    x &= (1 << 64) - 1
    return (x >> 32) & MASK32, x & MASK32


def _fmix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 13
    x = (x * _M2) & MASK32
    x ^= x >> 16
    return x


def scramble64_int(value: int, salts: Tuple[int, int]) -> int:
    """:func:`scramble64` of one 64-bit pattern ``value`` (a Python int,
    taken modulo 2^64) under the salts ``(r0, r1)``, in Python ints; returns
    the hash in ``[0, 2^64)``.  Far cheaper a call than numpy scalars, which
    the oracle's per-element path would otherwise pay."""
    hi, lo = _split_u64(int(value))
    r0_hi, r0_lo = _split_u64(salts[0])
    r1_hi, r1_lo = _split_u64(salts[1])
    hi ^= r0_hi
    lo ^= r0_lo
    for c in _ROUND_CONSTS[:3]:
        hi, lo = lo, hi ^ _fmix32_int((lo + c) & MASK32)
    hi ^= r1_hi
    lo ^= r1_lo
    for c in _ROUND_CONSTS[3:]:
        hi, lo = lo, hi ^ _fmix32_int((lo + c) & MASK32)
    return (hi << 32) | lo


def scramble64_array(values: np.ndarray, salts: Tuple[int, int]) -> np.ndarray:
    """:func:`scramble64_int` over an integer array: each value's 64-bit
    pattern (sign-extended from a signed dtype) to its uint64 hash."""
    v = np.asarray(values)
    if v.dtype.kind not in "iu":
        raise ValueError(f"expected an integer array, got {v.dtype}")
    u = v.astype(np.int64, copy=False).view(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(MASK32)).astype(np.uint32)
    r0_hi, r0_lo = _split_u64(salts[0])
    r1_hi, r1_lo = _split_u64(salts[1])
    with np.errstate(over="ignore"):
        shi, slo = scramble64(
            hi, lo, np.uint32(r0_hi), np.uint32(r0_lo), np.uint32(r1_hi), np.uint32(r1_lo)
        )
    return (shi.astype(np.uint64) << np.uint64(32)) | slo.astype(np.uint64)


def draw_salts(rng: np.random.Generator) -> Tuple[int, int]:
    """A host sampler's two 64-bit salts, drawn once at construction."""
    return int(rng.integers(0, 1 << 64, dtype=np.uint64)), int(
        rng.integers(0, 1 << 64, dtype=np.uint64)
    )


def as_scalar_hash(tile_hash_fn: Any):
    """The oracle's scalar hash (``value -> 64-bit int``) of a tile hash
    ``tile_hash_fn(values) -> (hi, lo)`` uint32 arrays, by feeding it a
    one-element numpy array: one definition for the host sampler and a
    tile engine."""

    def scalar_hash(value) -> int:
        arr = np.asarray([value])
        hi, lo = tile_hash_fn(arr)
        return (int(np.uint32(hi[0])) << 32) | int(np.uint32(lo[0]))

    return scalar_hash
