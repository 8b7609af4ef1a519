"""CPU semantic oracle for Algorithm-L reservoir sampling (duplicates mode).

The port's copy of the JAX package's ``oracle/algorithm_l.py``, with the
same draws, so one seed gives the same sample and leaves the generator in
the same state in both packages.  It re-derives the *behavior* of the
reference's ``RandomElements`` engine (``Sampler.scala:196-332``):
per-element Algorithm L with geometric skip counts.  It is the host sampler
of :mod:`reservoir_tpu_torch.api` (BASELINE.md config 1) and the
statistical ground truth of the engines.

Algorithm L ("An optimal algorithm", Li 1994; referenced by the reference at
``Sampler.scala:227``):

- fill the reservoir with the first ``k`` elements in arrival order
  (``Sampler.scala:253-255``);
- afterwards keep a running weight ``W`` and an absolute index ``next`` of the
  next accepted element; each acceptance overwrites a uniformly random slot
  (``Sampler.scala:243-246``) and re-draws ``W``/``next``:
  ``W *= u1**(1/k)``; ``next += floor(log(u2)/log(1-W)) + 1``
  (``Sampler.scala:228-236``).

Elements between acceptances cost one counter bump and one compare — the bulk
paths (:meth:`AlgorithmLOracle.sample_all`) skip them without touching them at
all (no ``map``, no RNG), mirroring ``sampleIndexed``/``sampleIterator``
(``Sampler.scala:261-287``).

Draw-order contract (shared by the per-element and bulk paths, so
``sample`` and ``sample_all`` give the same result under one generator):

1. at construction: ``u1, u2`` for the initial ``W``/``next``;
2. at each acceptance: ``slot = floor(next_double * k)``, then ``u1, u2``.

The slot draw is a scaled ``next_double`` rather than ``Generator.integers``
so the C scan (``_native/algl_scan.cc``, :func:`~reservoir_tpu_torch.native.algl_scan`)
can replay the identical stream through the BitGenerator's ``next_double``
pointer alone.  Int64-array inputs to :meth:`AlgorithmLOracle.sample_all`,
and ranges of up to 2^23 elements materialized as int64, take that C scan
where the JAX package takes its own (identical results); everything else
runs the plain-Python loop, and so does everything with ``native=False``.
The C library is built with g++ at first use, and a build that fails
raises.

``W`` is tracked in log-space so that ``n ~ 1e12``-scale streams do not
underflow.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..config import validate_max_sample_size

__all__ = ["AlgorithmLOracle"]


class AlgorithmLOracle:
    """Single-stream Algorithm-L reservoir sampler (duplicates allowed).

    Semantics match the reference engine ``RandomElements``
    (``Sampler.scala:196-332``); lifecycle (single-use/reusable) is layered on
    top by :mod:`reservoir_tpu_torch.api`.

    Args:
      k: reservoir capacity (``maxSampleSize``).
      rng: explicit RNG (``numpy.random.Generator``).
      map_fn: ``A => B`` applied on *accept* — it may be called more than ``k``
        times because accepted elements can later be evicted (doc contract at
        ``Sampler.scala:116``).
      pre_allocate: allocate the full ``k``-slot buffer up front instead of
        growing geometrically from 16 (``Sampler.scala:200-202, 210-222``).
        Behaviorally invisible; exposed for API parity.
      native: take the C scan where it applies (the default); ``False``
        runs the Python loop, with the same results.
    """

    def __init__(
        self,
        k: int,
        rng: np.random.Generator,
        map_fn: Optional[Callable[[Any], Any]] = None,
        pre_allocate: bool = False,
        native: bool = True,
    ) -> None:
        self._k = validate_max_sample_size(int(k))
        self._rng = rng
        self._native = native
        self._identity_map = map_fn is None
        self._map = map_fn if map_fn is not None else lambda x: x
        # Growable buffer semantics (Sampler.scala:200-222).  A Python list
        # already grows geometrically, so `pre_allocate` is accepted for API
        # parity but is behaviorally invisible (as in the reference — it only
        # trades allocation pattern, never results).  k slots are not
        # allocated eagerly: k = MAX_SIZE is legal at construction
        # (Sampler.scala:71) and must not commit ~17GB before any element
        # arrives.
        self._samples: List[Any] = []
        self._pre_allocate = pre_allocate
        self._aliased = False  # a result_view() holds our live list
        self._count: int = 0
        self._log_w: float = 0.0
        self._next: int = self._k  # absolute 1-based index of next acceptance
        self._advance()

    # -- Algorithm L skip computation (Sampler.scala:228-236) ----------------

    def _advance(self) -> None:
        """Redraw ``W`` and the absolute index of the next acceptance."""
        u1 = 1.0 - self._rng.random()  # (0, 1]
        u2 = 1.0 - self._rng.random()
        self._log_w += math.log(u1) / self._k
        w = math.exp(self._log_w)
        # log1p(-w) is exact for tiny w; w==1 gives -inf -> skip 0.
        denom = math.log1p(-w) if w < 1.0 else -math.inf
        if denom == -math.inf:
            skip = 0
        else:
            skip = math.floor(math.log(u2) / denom)
        self._next += skip + 1

    def _evict(self, element: Any) -> None:
        """Overwrite a uniformly random slot (``Sampler.scala:243-246``).

        Scaled ``random()`` rather than ``integers()`` so the draw is one
        ``next_double`` — replayable by the native scan (module docs)."""
        if self._aliased:
            self._ensure_unaliased()
        slot = int(self._rng.random() * self._k)
        self._samples[slot] = self._map(element)
        self._advance()

    def _append(self, element: Any) -> None:
        if self._aliased:
            self._ensure_unaliased()
        self._samples.append(self._map(element))

    def _ensure_unaliased(self) -> None:
        """Copy-on-write (``ensureUnaliased``, ``Sampler.scala:357-365``):
        an outstanding :meth:`result_view` holds the live list — copy before
        the first mutation so the view stays a stable snapshot."""
        self._samples = list(self._samples)
        self._aliased = False

    # -- public per-element / bulk API ---------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def k(self) -> int:
        return self._k

    def sample(self, element: Any) -> None:
        """Per-element hot path (``Sampler.scala:248-259``)."""
        self._count += 1
        if self._count <= self._k:
            self._append(element)
        elif self._count >= self._next:
            self._evict(element)

    def sample_all(self, elements: Iterable[Any]) -> None:
        """Bulk path: skipped elements are never touched.

        Mirrors ``sampleAllImpl`` dispatch (``Sampler.scala:289-316``):
        random-access sequences use index jumping (``sampleIndexed``,
        ``:261-273``); other iterables use iterator-dropping
        (``sampleIterator``, ``:275-287``).  Produces results identical to a
        per-element loop under the same RNG state.
        """
        if isinstance(elements, range) and self._sample_range(elements):
            return
        if isinstance(elements, (Sequence, np.ndarray)) and not isinstance(
            elements, (str, bytes)
        ):
            self._sample_indexed(elements)
        else:
            self._sample_iterator(iter(elements))

    # Materializing a range only beats the lazy skip-jump while the O(n)
    # arange cost stays under the O(k log n) Python acceptance cost; past
    # ~8M elements the lazy path is faster AND stays O(k) memory (a
    # range(10**10) must never allocate 80 GB).
    _RANGE_MATERIALIZE_CAP = 1 << 23

    def _coerce_samples_int64(self) -> Optional[np.ndarray]:
        """The resident samples as an int64 array, or None when they are
        not exactly int64-typed (floats/bools/strings must never be
        coerced — the shared gate for both native-scan entry points)."""
        try:
            s = np.asarray(self._samples)
        except (TypeError, ValueError, OverflowError):
            return None
        return s if s.dtype == np.int64 else None

    def _sample_range(self, r: range) -> bool:
        """Materialize a modest range as int64 and ride the native scan —
        the BASELINE config-1 "1M-element Iterator" shape.  Results stay
        plain Python ints.  False -> caller runs the ordinary (lazy) path;
        every precondition is checked *before* any state mutation so the
        fallback replays from an untouched sampler."""
        # gate on the POST-FILL remainder: elements the fill phase will
        # consume cannot reach the C scan, and a mostly-fill range would
        # materialize for nothing
        remainder = len(r) - max(0, self._k - self._count)
        if not (512 < remainder and len(r) <= self._RANGE_MATERIALIZE_CAP):
            return False
        if not self._identity_map:
            return False  # map_fn expects the range's plain ints
        if not self._native:
            # no C scan: the lazy range path is strictly better (and keeps
            # storing plain ints, which the ndarray loop would not)
            return False
        # cheap pre-gate so a refusal never pays the arange; the scan
        # itself re-derives the array post-fill (_try_native_scan), which
        # is unavoidable — fill appends between these two points
        if self._samples and self._coerce_samples_int64() is None:
            return False
        try:
            arr = np.arange(r.start, r.stop, r.step, dtype=np.int64)
        except (OverflowError, MemoryError):
            return False  # out-of-int64 bounds or no memory: stay lazy
        if arr.size != len(r):
            return False
        self._sample_indexed(arr, as_python_int=True)
        return True

    def _sample_indexed(
        self, seq: Sequence[Any], as_python_int: bool = False
    ) -> None:
        n = len(seq)
        i = 0
        # fill phase
        while self._count < self._k and i < n:
            self._count += 1
            elem = seq[i]
            self._append(int(elem) if as_python_int else elem)
            i += 1
        # native fast path: the same skip-jump loop in C, drawing from the
        # same numpy bit stream — bit-identical results (module docs)
        if (
            n - i > 512
            and self._native
            and self._identity_map
            # exact-type gate: ndarray *subclasses* (np.ma.MaskedArray,
            # np.matrix) override __getitem__ semantics the raw-buffer C
            # scan would ignore — they keep the Python path
            and type(seq) is np.ndarray
            and seq.ndim == 1
            and seq.dtype == np.int64
            and self._try_native_scan(seq, i, n, as_python_int)
        ):
            return
        # skip-jump phase: land directly on acceptance indices.
        # seq[i] has absolute stream index count+1, so the next acceptance
        # (absolute index `next`) sits at offset i + (next - count) - 1.
        while True:
            target = i + (self._next - self._count) - 1
            if target >= n:
                self._count += n - i
                return
            self._count += target - i + 1
            i = target + 1
            elem = seq[target]
            self._evict(int(elem) if as_python_int else elem)

    def _try_native_scan(
        self, seq: np.ndarray, i: int, n: int, as_python_int: bool = False
    ) -> bool:
        """Run the C scan over ``seq[i:]``; False -> caller uses the Python
        loop (the resident samples are not int64-coercible)."""
        from .. import native as _native

        if self._aliased:
            self._ensure_unaliased()
        # int64-exact resident samples only: coercion would silently
        # truncate float/bool/str samples held from earlier calls
        samples = self._coerce_samples_int64()
        if samples is None or samples.shape != (self._k,):
            return False
        res = _native.algl_scan(
            self._rng,
            np.ascontiguousarray(seq[i:]),
            self._k,
            samples,
            self._count,
            self._next,
            self._log_w,
        )
        self._count, self._next, self._log_w = res
        # range inputs deliver plain ints (what the Python path stores)
        self._samples = (
            [int(v) for v in samples] if as_python_int else list(samples)
        )
        return True

    def _sample_iterator(self, it: Iterator[Any]) -> None:
        while True:
            skip = self._next - self._count - 1
            if self._count < self._k:
                # fill phase consumes elements one by one
                try:
                    elem = next(it)
                except StopIteration:
                    return
                self._count += 1
                self._append(elem)
                continue
            # drop `skip` elements without touching them
            consumed = _drop(it, skip)
            self._count += consumed
            if consumed < skip:
                return
            try:
                elem = next(it)
            except StopIteration:
                return
            self._count += 1
            self._evict(elem)

    def result(self) -> List[Any]:
        """Current sample; fewer than ``k`` seen -> all of them, in arrival
        order (truncation, ``Sampler.scala:318-331``).  Always a fresh list."""
        size = min(self._count, self._k)
        return list(self._samples[:size])

    def result_view(self) -> List[Any]:
        """Zero-copy result with copy-on-write protection — the reusable
        aliasing optimization of ``MultiResultRandomElements``
        (``Sampler.scala:353-381``): when the buffer holds exactly the sample
        (the steady-state common case), return the *live* list and mark it
        aliased; the next mutation copies first, so the view is a stable
        snapshot.  Callers must treat the returned list as immutable (the
        reference returns an immutable wrapper over the live array)."""
        size = min(self._count, self._k)
        if size == len(self._samples):
            self._aliased = True
            return self._samples
        return list(self._samples[:size])


def _drop(it: Iterator[Any], n: int) -> int:
    """Advance ``it`` by up to ``n`` elements; return how many were consumed."""
    count = 0
    for _ in itertools.islice(it, n):
        count += 1
    return count
