"""The tile kernels' launch geometry: rows a block.

The port's counterpart of the JAX package's ``ops/blocking.py``.  There a
row-block of reservoirs stays in VMEM while the batch streams through in
chunks, and this module sized it from a VMEM model.  Here a CUDA block runs
a fixed number of reservoir rows, one thread a row (``algl_update``, its
WIDE instantiation and ``algl_update_gated``) or one warp a row
(``weighted_update`` and ``distinct_update``), and the C++ launchers are
the one place that decides what a launch keeps in shared memory
(``shape_for`` of ``csrc/distinct.cu``, ``wtd::smem_bytes`` of
``csrc/weighted.cu``).  This module only says which rows a block a launch
asks for:

- :data:`BLOCK_CHOICES`: the rows a block each kernel is built for (a
  template instantiation each on the card), and :data:`DEFAULT_BLOCK`,
  today's constants, which a launch takes with no cache entry;
- :func:`resolve_block_r`: a requested rows-a-block (an autotune cache
  entry's ``block_r``) checked against those choices.  As in the
  reference, an invalid geometry costs speed, never a crash or a different
  result: it falls back to the default, and every choice gives the
  default's bits.

:func:`shrink_block_to` and :func:`resolve_chunk` keep the reference's
rules.  The port streams no batch chunks (each kernel reads a row's tile
in one pass), so a cache entry's ``chunk_b`` and ``gather_chunk`` are read
and written back untouched, and :func:`resolve_chunk` says what the
reference's kernels would run.  The reference's ``pick_block_r`` and
``kernel_block_r`` sized a block from a VMEM budget; the launchers size
theirs, so they have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "BLOCK_CHOICES",
    "DEFAULT_BLOCK",
    "resolve_block_r",
    "resolve_chunk",
    "shrink_block_to",
]

#: The rows a block each kernel is built for: threads for the uniform
#: kernels, warps for the others (for ``distinct`` the most warps a block;
#: the launcher takes as many of them as keep their rows on chip).
BLOCK_CHOICES = {
    "algl": (32, 64, 128, 256),
    "algl_gated": (32, 64, 128, 256),
    "weighted": (1, 2, 4, 8),
    "distinct": (1, 2, 4),
}
#: today's constants: ``kThreads``, ``kWarps``, ``kMaxWarps``
DEFAULT_BLOCK = {"algl": 128, "algl_gated": 128, "weighted": 4, "distinct": 4}


def shrink_block_to(num_reservoirs: int, block_r: int) -> int:
    """Largest power of two <= R when R is smaller than the block."""
    if num_reservoirs >= block_r:
        return block_r
    return 1 << max(0, num_reservoirs.bit_length() - 1)


def resolve_chunk(tile_b: int, chunk_b: "int | None", multiple_of: int = 1) -> int:
    """The batch chunk the reference's grid runs: ``chunk_b`` when it is a
    proper divisor of the tile width (and a multiple of ``multiple_of``),
    else the whole tile in one cell.  An invalid chunk costs speed, never a
    crash or a different result."""
    if not chunk_b or chunk_b <= 0 or chunk_b >= tile_b:
        return tile_b
    if tile_b % chunk_b != 0 or chunk_b % multiple_of != 0:
        return tile_b
    return chunk_b


def resolve_block_r(kernel: str, block_r: Optional[int], num_reservoirs: Optional[int] = None) -> Optional[int]:
    """The rows a block to launch with for a requested ``block_r`` (a cache
    entry's), or ``None`` for the default launch: ``block_r`` 0, ``None``,
    the default itself, or a value the kernel was not built for.  With
    ``num_reservoirs``, a block wider than R is shrunk to the largest power
    of two <= R (:func:`shrink_block_to`), but not below the kernel's
    smallest choice."""
    choices = BLOCK_CHOICES[kernel]
    if block_r not in choices:
        return None
    if num_reservoirs is not None and num_reservoirs > 0:
        shrunk = shrink_block_to(num_reservoirs, block_r)
        block_r = min((b for b in choices if b >= shrunk), default=block_r)
    return None if block_r == DEFAULT_BLOCK[kernel] else int(block_r)
