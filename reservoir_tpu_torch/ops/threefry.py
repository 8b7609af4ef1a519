"""Threefry-2x32 on torch tensors — the port's counter-based RNG core.

The same cipher as ``jax.random``'s threefry implementation (partitionable
counter layout), written so that its words equal the JAX package's
``ops/threefry.py`` exactly.  Keys are data: a reservoir's key is a pair of
uint32 words, never a ``torch.Generator``, because the draws must be the
reference's.

torch on the CPU has no uint32 add, shift or compare, so every uint32 word
rides in an int64 tensor holding a value in ``[0, 2^32)``; each add is
masked back with ``& 0xFFFFFFFF``.  The CUDA kernel carries the same words
as native ``uint32_t`` (``csrc/threefry.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "MASK32",
    "threefry2x32",
    "fold_in_words",
    "fold_in_words_pair",
    "bits_words",
    "counter_bits",
    "counter_bits_pair",
]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
# rotation schedule for Threefry-2x32: 20 rounds in 5 groups of 4
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(
    k1, k2, x0, x1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash the blocks ``(x0, x1)`` under key ``(k1, k2)``, elementwise over
    broadcastable int64 tensors of uint32 values."""
    ks0 = _u32(k1)
    ks1 = _u32(k2)
    ks2 = ks0 ^ ks1 ^ _PARITY
    ks = (ks0, ks1, ks2)
    x0 = (_u32(x0) + ks0) & MASK32
    x1 = (_u32(x1) + ks1) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def fold_in_words(k1, k2, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jr.fold_in(key, idx)`` on raw words: one hash of the block
    ``(idx >> 32, idx & 0xFFFFFFFF)``.  ``idx`` is an int32 or int64 tensor;
    the high word of a 64-bit index is folded in too, so draws past 2^32
    stay fresh (identical to jax for any idx < 2^32)."""
    idx = torch.as_tensor(idx)
    lo = idx.to(torch.int64) & MASK32
    if idx.dtype == torch.int64:
        hi = (idx >> 32) & MASK32
    else:
        hi = torch.zeros_like(lo)
    return threefry2x32(k1, k2, hi, lo)


def fold_in_words_pair(k1, k2, idx_hi, idx_lo) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fold_in_words` for a 64-bit index carried as its ``(hi, lo)``
    uint32 words (WIDE counters, :mod:`.u64e`): both hash the block
    ``(hi, lo)``, so the two agree bit for bit on the same logical index."""
    return threefry2x32(k1, k2, idx_hi, idx_lo)


def bits_words(k1, k2, n: int) -> Tuple[torch.Tensor, ...]:
    """``jr.bits(key, (n,), uint32)`` on raw words: word ``j`` is
    ``out0 ^ out1`` of block ``(0, j)``."""
    zero = torch.zeros_like(_u32(k1))
    words = []
    for j in range(n):
        b0, b1 = threefry2x32(k1, k2, zero, zero + j)
        words.append(b0 ^ b1)
    return tuple(words)


def counter_bits(k1, k2, idx, n: int) -> Tuple[torch.Tensor, ...]:
    """``n`` words for the counter-derived key ``fold_in(key, idx)``."""
    f1, f2 = fold_in_words(k1, k2, idx)
    return bits_words(f1, f2, n)


def counter_bits_pair(k1, k2, idx_hi, idx_lo, n: int) -> Tuple[torch.Tensor, ...]:
    """:func:`counter_bits` for an index carried as ``(hi, lo)`` words."""
    f1, f2 = fold_in_words_pair(k1, k2, idx_hi, idx_lo)
    return bits_words(f1, f2, n)
