"""CPU semantic oracle for weighted reservoir sampling (A-ES / A-ExpJ).

The port's copy of the JAX package's ``oracle/weighted.py``, with the same
draws.  Capability beyond the reference: single-pass sampling of k items
where each item's inclusion is biased by a positive weight, per Efraimidis
& Spirakis — item i gets key ``u_i^(1/w_i)``; the sample is the k largest
keys ("A-ES").  The exponential-jumps variant ("A-ExpJ") skips over items
whose cumulative weight is below a drawn threshold, touching only
O(k log(n/k)) items in expectation — the weighted analog of Algorithm L's
skip structure.

Two oracles:

- :class:`NaiveWeightedOracle` — materializes every key, exact by
  construction; the distributional ground truth.
- :class:`AExpJOracle` — the streaming jump algorithm, whose behavior the
  weighted engine (:mod:`reservoir_tpu_torch.ops.weighted`) reproduces.

Keys are kept in log-space (``lkey = log(u)/w``) so huge streams don't
underflow — the same design as the Algorithm-L ``W``.
"""

from __future__ import annotations

import heapq
import math
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np

from ..config import validate_max_sample_size

__all__ = ["NaiveWeightedOracle", "AExpJOracle"]


class NaiveWeightedOracle:
    """Exact A-ES: assign every item ``lkey = log(u)/w``, keep top k."""

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self._k = validate_max_sample_size(int(k))
        self._rng = rng
        self._heap: List[Tuple[float, int, Any]] = []  # (lkey, tie, value)
        self._tie = 0
        self._count = 0

    def sample(self, element: Any, weight: float) -> None:
        if weight < 0:
            raise ValueError(f"weights must be >= 0, got {weight}")
        self._count += 1
        if weight == 0:
            return  # zero-weight items are never sampled
        u = 1.0 - self._rng.random()
        lkey = math.log(u) / weight
        self._tie += 1
        if len(self._heap) < self._k:
            heapq.heappush(self._heap, (lkey, self._tie, element))
        elif lkey > self._heap[0][0]:
            heapq.heapreplace(self._heap, (lkey, self._tie, element))

    def sample_all(self, pairs: Iterable[Tuple[Any, float]]) -> None:
        for element, weight in pairs:
            self.sample(element, weight)

    def result(self) -> List[Any]:
        return [v for (_lk, _t, v) in sorted(self._heap, reverse=True)]


class AExpJOracle:
    """Streaming A-ExpJ with exponential jumps.

    Distributionally identical to :class:`NaiveWeightedOracle` (same key
    construction), but only draws RNG on accepted items: between acceptances
    it skips items until their cumulative weight exceeds a drawn amount
    ``Xw = log(r)/log(T)`` (T = current threshold key), then gives the
    crossing item a key conditioned to beat the threshold:
    ``key = r2^(1/w)`` with ``r2 ~ U(T^w, 1)``.
    """

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self._k = validate_max_sample_size(int(k))
        self._rng = rng
        self._heap: List[Tuple[float, int, Any]] = []
        self._tie = 0
        self._count = 0
        self._xw: Optional[float] = None  # remaining weight to skip

    def _draw_xw(self) -> float:
        # log(r)/log(T) in log-space: lT = heap min lkey (negative)
        r = 1.0 - self._rng.random()
        lt = self._heap[0][0]
        if lt == 0.0:  # threshold key is 1: nothing can beat it via U(t,1)
            return math.inf
        return math.log(r) / lt

    def _accept(self, element: Any, weight: float) -> None:
        """Accept the jump-crossing item: key conditioned into (T^w, 1),
        then redraw the jump."""
        lt = self._heap[0][0]
        t_w = math.exp(weight * lt)
        r2 = t_w + (1.0 - self._rng.random()) * (1.0 - t_w)
        lkey = math.log(r2) / weight
        self._tie += 1
        heapq.heapreplace(self._heap, (lkey, self._tie, element))
        self._xw = self._draw_xw()

    def _fill(self, element: Any, weight: float) -> None:
        u = 1.0 - self._rng.random()
        self._tie += 1
        heapq.heappush(self._heap, (math.log(u) / weight, self._tie, element))
        if len(self._heap) == self._k:
            self._xw = self._draw_xw()

    def sample(self, element: Any, weight: float) -> None:
        if weight < 0:
            raise ValueError(f"weights must be >= 0, got {weight}")
        self._count += 1
        if weight == 0:
            return
        if len(self._heap) < self._k:
            self._fill(element, weight)
            return
        self._xw -= weight
        if self._xw <= 0:
            self._accept(element, weight)

    def sample_all(self, pairs: Iterable[Tuple[Any, float]]) -> None:
        for element, weight in pairs:
            self.sample(element, weight)

    def sample_all_arrays(self, elements: np.ndarray, weights: np.ndarray) -> None:
        """Bulk path over parallel arrays — identical results to per-element
        calls by construction: ``np.subtract.accumulate`` (float64) replays
        the exact sequential ``xw -= w`` chain, so jump crossings land on
        the same items and RNG draws happen in the same order; the segments
        between accepts are traversed once at C speed (the weighted analog
        of the skip-jump bulk path, ``Sampler.scala:261-287``)."""
        elements = np.asarray(elements)
        weights = np.asarray(weights, np.float64)
        if weights.shape != elements.shape or elements.ndim != 1:
            raise ValueError("elements and weights must be matching 1-D arrays")
        if not np.all(weights >= 0):  # also rejects NaN (min() would not)
            raise ValueError(
                "weights must be >= 0 (and not NaN); got "
                f"min {float(weights.min()) if weights.size else 0}"
            )
        n = elements.shape[0]
        off = 0
        # fill phase: per-element until the heap holds k positive items
        while len(self._heap) < self._k and off < n:
            self._count += 1
            w = float(weights[off])
            if w > 0:
                self._fill(elements[off], w)
            off += 1
        chunk = 8192  # bounds per-accept re-accumulation to O(chunk)
        while off < n:
            end = min(off + chunk, n)
            # replay xw - w[off] - w[off+1] - ... exactly (sequential
            # float64 accumulate); crossing = first partial <= 0
            acc = np.subtract.accumulate(
                np.concatenate(([self._xw], weights[off:end]))
            )[1:]
            crossed = np.nonzero(acc <= 0.0)[0]
            if crossed.size == 0:
                self._count += end - off
                self._xw = float(acc[-1])
                off = end
                continue
            j = off + int(crossed[0])
            self._count += j - off + 1
            self._accept(elements[j], float(weights[j]))
            off = j + 1

    @property
    def count(self) -> int:
        return self._count

    def result(self) -> List[Any]:
        return [v for (_lk, _t, v) in sorted(self._heap, reverse=True)]
