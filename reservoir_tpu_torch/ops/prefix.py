"""The blocked prefix sum of the weighted update (the port of ``ops/prefix.py``).

For float inputs the order of the additions decides every partial sum's
bits, so the weighted update's weight cumsum follows the JAX package's
association exactly, never ``torch.cumsum``:

- the axis is cut into blocks of ``CUMSUM_BLOCK = 128`` lanes (a ragged
  last block is scanned on its own width);
- each block gets the log-step shifted adds (Hillis-Steele) for
  ``d = 1, 2, 4, ...`` while ``d`` is below the block's width: every lane
  ``p`` adds lane ``p - d`` of the previous step, and lanes ``p < d`` add
  ``+0.0``;
- a running carry, the last lane of the previous block after its own
  carry, is added to every lane of each later block; with ``carry=None``
  block 0 gets no add.

Every add runs as XLA CPU runs it, with denormal inputs read as zero and
denormal results flushed to zero (:func:`.fmath.flush`).  The CUDA kernel
(``csrc/weighted.cu``) scans the same blocks in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .fmath import flush

__all__ = ["CUMSUM_BLOCK", "lane_cumsum", "lane_cumsum_carry"]

#: the association's block: an algorithmic constant, not a tuning knob
CUMSUM_BLOCK = 128


def _add(a: torch.Tensor, b) -> torch.Tensor:
    return flush(a + b)


def _hillis(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by log-step shifted adds."""
    n = x.shape[-1]
    d = 1
    while d < n:
        shifted = torch.cat([torch.zeros_like(x[..., :d]), x[..., : n - d]], dim=-1)
        x = _add(x, shifted)
        d *= 2
    return x


def lane_cumsum_carry(
    x: torch.Tensor, carry: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked inclusive prefix sum of float32 ``x`` along its last axis,
    continuing from ``carry`` (``[..., 1]``, or ``None`` for a fresh scan).
    Returns ``(cw, carry_out)`` with ``carry_out = cw[..., -1:]``."""
    n = x.shape[-1]
    if n > 1 or carry is not None:
        x = flush(x)  # denormal inputs read as zero once any add touches them
    parts = []
    for off in range(0, n, CUMSUM_BLOCK):
        h = _hillis(x[..., off : off + CUMSUM_BLOCK])
        if carry is not None:
            h = _add(h, carry)
        parts.append(h)
        carry = h[..., -1:]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out, carry


def lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Blocked inclusive prefix sum along the last axis."""
    return lane_cumsum_carry(x, None)[0]
