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
- numpy ``uint32`` arrays, whose arithmetic wraps by itself (the form a
  host oracle uses).

Every operation is modular, so both give the JAX package's words bit for
bit, and so does ``csrc/hashing.cuh``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .threefry import MASK32

__all__ = [
    "fmix32",
    "scramble64",
    "default_hash64",
    "salt_for_target",
    "words",
]

# the per-round constants of the JAX package's scramble
_ROUND_CONSTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B1)
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35


def words(x: torch.Tensor) -> torch.Tensor:
    """A tensor of 32-bit words (int32 or uint32) as uint32 values in int64."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


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
    exactly ``(MAX, MAX)``, the hash the update never takes."""
    hi, lo = np.uint32(value[0] ^ r0[0]), np.uint32(value[1] ^ r0[1])
    with np.errstate(over="ignore"):
        for c in _ROUND_CONSTS[:3]:
            hi, lo = _round(hi, lo, c)
        t_hi, t_lo = np.uint32(target[0]), np.uint32(target[1])
        for c in reversed(_ROUND_CONSTS[3:]):
            # the inverse of (hi, lo) -> (lo, hi ^ f(lo + c))
            t_hi, t_lo = t_lo ^ fmix32((t_hi + c) & MASK32), t_hi
    return int(hi ^ t_hi), int(lo ^ t_lo)
