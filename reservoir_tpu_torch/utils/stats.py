"""The one-sample KS gate (the port's copy of the JAX package's
``utils/stats.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["KS_GATE", "ks_one_sample_uniform"]

#: the "within 1% KS distance" acceptance gate
KS_GATE = 0.01


def ks_one_sample_uniform(values: np.ndarray, n: int) -> float:
    """``sup_x |ECDF(x) - x/n|`` for values drawn from ``{0..n-1}``: the
    one-sample Kolmogorov-Smirnov statistic against the discrete uniform law
    on an ``n``-element stream."""
    s = np.sort(np.asarray(values)) / float(n)
    m = len(s)
    ecdf_hi = np.arange(1, m + 1) / m
    ecdf_lo = np.arange(0, m) / m
    return float(np.maximum(np.abs(ecdf_hi - s), np.abs(s - ecdf_lo)).max())
