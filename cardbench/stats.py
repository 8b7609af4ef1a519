"""The percentile the tail metrics take, over every sample."""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["percentile"]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of every value, linear between the
    two closest ranks; ``None`` for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
