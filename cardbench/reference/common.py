"""Threefry-2x32 and the draws built on it, in NumPy uint32 arithmetic.

The counter-based generator that ``jax.random`` defines (partitionable
layout): a reservoir's key is two uint32 words, ``split`` hashes the block
``(0, i)``, ``fold_in(key, idx)`` hashes ``(0, idx)``, and word ``j`` of
``bits(key, n)`` is the xor of the two output words of block ``(0, j)``.
Written from that definition; uint32 arrays wrap by themselves.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "split_rows", "uniforms", "salts_words"]

_U32 = np.uint32
_PARITY = _U32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of blocks ``(x0, x1)`` under keys
    ``(k1, k2)``, elementwise over broadcastable uint32 arrays."""
    k1, k2, x0, x1 = np.broadcast_arrays(_u32(k1), _u32(k2), _u32(x0), _u32(x1))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + _U32(group + 1)
    return x0, x1


def split_rows(key_words, rows) -> np.ndarray:
    """Rows ``rows`` of ``split(key, R)``: ``[len(rows), 2]`` uint32 words."""
    kw = _u32(key_words)
    rows = _u32(rows)
    b0, b1 = threefry2x32(kw[0], kw[1], np.zeros_like(rows), rows)
    return np.stack([b0, b1], axis=-1)


def uniforms(keys: np.ndarray, idx, channels):
    """Channels ``channels`` (word indices) of the ``(0, 1]`` float32
    uniforms of ``bits(fold_in(key, idx), n)``: ``((word >> 8) + 1) *
    2^-24``.  ``keys`` is ``[m, 2]`` uint32, ``idx`` ``[m]`` (a 32-bit index:
    its high word is 0)."""
    idx = np.asarray(idx).astype(np.int64) & 0xFFFFFFFF
    f1, f2 = threefry2x32(keys[:, 0], keys[:, 1], np.zeros_like(idx), idx)
    out = []
    for j in channels:
        b0, b1 = threefry2x32(f1, f2, np.zeros_like(f1), np.full_like(f1, j))
        w = b0 ^ b1
        out.append(((w >> _U32(8)).astype(np.float32) + np.float32(1.0)) * np.float32(2.0**-24))
    return tuple(out)


def salts_words(key_words, num_rows: int) -> np.ndarray:
    """``bits(key, (R, 4))``: the distinct sampler's per-row salts,
    ``[R, 4]`` uint32 words (word ``(r, j)`` from block ``(0, 4 r + j)``)."""
    kw = _u32(key_words)
    idx = np.arange(4 * num_rows, dtype=np.uint32)
    b0, b1 = threefry2x32(kw[0], kw[1], np.zeros_like(idx), idx)
    return (b0 ^ b1).reshape(num_rows, 4)
