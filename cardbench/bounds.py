"""The yardstick for the kernels' roofline shares: the least time one H100
could take over a launch's work, frozen here so that a change to the
program cannot move it.

A bound is the larger of the bytes the work must move at the card's
memory bandwidth and its operations at the busiest pipe's rate.  Each input
byte is read once and each output byte written once; where the work depends
on the data, the count is what these inputs need.  The peaks are NVIDIA's
data sheet for the H100 SXM (HBM3 bytes/s, non-tensor float32 FLOP/s) and
the SM layout (64 INT32 lanes an SM x 132 SMs x 1.98 GHz).  The per-lane
and per-event counts were read from the kernels' sources when this
benchmark was written (``csrc/weighted.cu``, ``csrc/distinct.cu``,
``csrc/hashing.cuh``, ``csrc/merge_ring.cu``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "PEAK_BYTES",
    "PEAK_F32",
    "PEAK_INT32",
    "weighted_bound_ms",
    "distinct_bound_ms",
    "gather_bound_ms",
    "weighted_work",
    "net_inserts",
]

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT32 = 64 * 132 * 1.98e9
#: a Threefry-2x32 block's operations on the INT32 pipe: its 20 rounds'
#: rotations and xors (its adds may run on the IMAD pipe)
THREEFRY_INT32_OPS = 40
SECTOR_BYTES = 32

# weighted: per weight lane the scan's adds and flushes and the ballots; per
# acceptance three Threefry blocks and 83 ops of the search ballots and the
# warp minimum, log twice, exp and two divisions; per filled slot two blocks
# and 17 ops, a log and a division
W_INT_OPS_PER_LANE = 4
W_FLOPS_PER_LANE = 16
W_INT_OPS_PER_ACCEPT = 3 * THREEFRY_INT32_OPS + 83
W_FLOPS_PER_ACCEPT = 90
W_INT_OPS_PER_FILL = 2 * THREEFRY_INT32_OPS + 17
W_FLOPS_PER_FILL = 28
#: per row: count and xw read and written, the key read
W_STATE_BYTES_PER_ROW = 24

# distinct: per lane the scramble (4 salt xors, 6 rounds of an add, fmix32's
# 3 shifts, 3 xors and 2 multiplies, the Feistel xor) and the compare and
# ballot; per insertion a binary search (8 ops a step) and the shift of half
# the block
D_OPS_PER_LANE = 68
D_OPS_PER_SEARCH_STEP = 8
#: per row: the threshold entry (8), size and count read and written (16),
#: the salts (16)
D_STATE_BYTES_PER_ROW = 40


def _bound(nbytes: float, t_ops: float) -> Tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weighted_bound_ms(accepts: float, fills: float, lanes: int, rows: int, k: int) -> Tuple[float, str]:
    """The weighted kernel's bound for a tile of ``lanes`` weights over
    ``rows`` rows of ``k`` slots, with ``accepts`` acceptances and ``fills``
    filled slots: every weight read once (4 bytes), each row's log keys
    read and its state (24 bytes), one 32-byte sector of elements gathered a
    taken item (no more than the tile), one sector of samples and one of
    keys written a taken item (no more than the state)."""
    moved = accepts + fills
    gathered = min(SECTOR_BYTES * moved, 4 * lanes)
    written = min(2 * SECTOR_BYTES * moved, 8 * rows * k)
    nbytes = 4 * lanes + rows * (4 * k + W_STATE_BYTES_PER_ROW) + gathered + written
    int_ops = W_INT_OPS_PER_LANE * lanes + W_INT_OPS_PER_ACCEPT * accepts + W_INT_OPS_PER_FILL * fills
    flops = W_FLOPS_PER_LANE * lanes + W_FLOPS_PER_ACCEPT * accepts + W_FLOPS_PER_FILL * fills
    return _bound(nbytes, max(int_ops / PEAK_INT32, flops / PEAK_F32))


def distinct_bound_ms(lanes: int, inserts: float, rows_inserting: float, rows: int, k: int,
                      wide: bool = False) -> Tuple[float, str]:
    """The distinct kernel's bound for a tile of ``lanes`` keys over
    ``rows`` rows, with ``inserts`` entries new to the state over
    ``rows_inserting`` rows: the keys read once, each row's state, an
    inserting row's block read and written; a lane's hash and compare, an
    insert's binary search and the shift of half the block."""
    planes = 4 if wide else 3
    key_bytes = 8 if wide else 4
    nbytes = key_bytes * lanes + rows * D_STATE_BYTES_PER_ROW + rows_inserting * 2 * k * 4 * planes
    per_insert = D_OPS_PER_SEARCH_STEP * (k.bit_length() - 1) + planes * k // 2
    return _bound(nbytes, (D_OPS_PER_LANE * lanes + per_insert * inserts) / PEAK_INT32)


def gather_bound_ms(ranks: int, words: int) -> Tuple[float, str]:
    """The all-gather of ``words`` 32-bit words a rank over ``ranks`` ranks
    of one card: every input word read once and every output word written
    once, ``(d + d^2) n 4`` bytes."""
    return _bound((ranks + ranks * ranks) * words * 4, 0.0)


def weighted_work(lkeys_before: np.ndarray, lkeys_after: np.ndarray) -> Tuple[int, int]:
    """``(accepts, fills)`` that turned one weighted state into another, as
    few as can: a slot filled after and empty before is a fill, a filled
    slot whose key changed is at least one acceptance (one replaced twice
    counts once)."""
    empty_before = np.isneginf(lkeys_before)
    fills = int((empty_before & ~np.isneginf(lkeys_after)).sum())
    changed = ~empty_before & (lkeys_before.view(np.int32) != lkeys_after.view(np.int32))
    return int(changed.sum()), fills


def _hash_key(hash_hi: np.ndarray, hash_lo: np.ndarray) -> np.ndarray:
    hi = hash_hi.view(np.uint32).astype(np.int64)
    lo = hash_lo.view(np.uint32).astype(np.int64)
    return (hi - 2**31) * 2**32 + lo


def net_inserts(before: Tuple[np.ndarray, np.ndarray, np.ndarray],
                after: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> Tuple[int, int]:
    """``(entries of after not in before, rows with any)`` for two distinct
    states given as ``(hash_hi, hash_lo, size)``: the inserts these tiles
    needed at the least (one inserted and evicted again is not counted);
    hashes identify keys, since the scramble is a permutation."""
    pad = 2**63 - 1
    both = np.sort(np.concatenate([_hash_key(*before[:2]), _hash_key(*after[:2])], 1), 1)
    common = ((both[:, 1:] == both[:, :-1]) & (both[:, 1:] != pad)).sum(1)
    new = after[2].astype(np.int64) - common
    return int(new.sum()), int((new > 0).sum())
