"""Host Sampler API — the reference's public trait and factories.

The port's copy of the JAX package's ``api.py``.  Mirrors
``trait Sampler[A,B]`` (``Sampler.scala:26-68``): ``sample``, ``sample_all``
(default per-element loop, ``:50``), ``result``, ``is_open`` — plus the
factory/validation surface of ``object Sampler`` (``Sampler.scala:70-180``)
and its lifecycle matrix:

====================  =========================================  ==========================
factory               single-use (default)                       reusable
====================  =========================================  ==========================
:func:`sampler`       ``SingleUseRandomElements`` (:334-351)     ``MultiResultRandomElements`` (:353-381)
:func:`distinct`      ``SingleUseRandomValues`` (:414-428)       ``MultiResultRandomValues`` (:430-433)
====================  =========================================  ==========================

Single-use semantics: ``result()`` closes the sampler and frees its buffers
(GC-nulling, ``:345-350``); any later ``sample``/``sample_all``/``result``
raises :class:`~reservoir_tpu_torch.errors.SamplerClosedError`
(``SingleUse.checkOpen``, ``:185-186``); ``is_open`` stays callable (``:193``).
Reusable semantics: ``result()`` returns a stable snapshot and sampling may
continue; earlier snapshots are never clobbered.  As in the reference
(zero-copy ``ArraySeq`` over the live array with copy-on-write,
``:353-381``), the snapshot is an immutable zero-copy view
(:class:`SampleView`) of the live buffer; the engine copies before its next
mutation, so the view never changes underneath the caller.

These host samplers run the CPU oracles of :mod:`reservoir_tpu_torch.oracle`
— the semantic baseline (BASELINE.md config 1); ``native=False`` runs the
oracles' Python loops in place of their C scans, with the same results.
The card's counterpart with the same lifecycle is
:class:`reservoir_tpu_torch.stream.DeviceSampler` (one stream) over
:class:`reservoir_tpu_torch.ReservoirEngine`.

Samplers are NOT thread-safe, matching the reference's documented contract
(``Sampler.scala:19, 105, 143``).
"""

from __future__ import annotations

import abc
from collections.abc import Sequence as _SequenceABC
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import validate_non_distinct_params
from .errors import SamplerClosedError
from .oracle.algorithm_l import AlgorithmLOracle
from .oracle.bottom_k import BottomKOracle

__all__ = [
    "Sampler",
    "SampleView",
    "sampler",
    "distinct",
    "weighted",
    "WeightedSampler",
]

_identity = lambda x: x  # noqa: E731


class SampleView(_SequenceABC):
    """Immutable zero-copy view of a reusable sampler's current sample —
    the ``ArraySeq.unsafeWrapArray`` analog (``Sampler.scala:375-379``).

    O(1) to create: wraps the engine's live buffer without copying.  The
    engine's copy-on-write guard copies *its* side before the next mutation,
    so a view is a stable snapshot; immutability here keeps the caller from
    mutating engine state through the alias (the reference returns an
    immutable ``IndexedSeq`` for exactly this reason).
    """

    __slots__ = ("_data",)

    def __init__(self, data: List[Any]) -> None:
        self._data = data

    def __getitem__(self, index):
        if isinstance(index, slice):
            return list(self._data[index])
        return self._data[index]

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, (SampleView, list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __hash__(self):
        return hash(tuple(self._data))

    def __repr__(self) -> str:
        return f"SampleView({self._data!r})"


class Sampler(abc.ABC):
    """Public sampler trait (``Sampler.scala:26-68``).

    Not reusable unless stated otherwise; not thread-safe (doc contract,
    ``Sampler.scala:14-19``).
    """

    @abc.abstractmethod
    def sample(self, element: Any) -> None:
        """Sample a single element (``Sampler.scala:38``)."""

    def sample_all(self, elements: Iterable[Any]) -> None:
        """Sample every element; default per-element loop (``Sampler.scala:50``).
        Implementations override with skip-jump bulk paths that must produce
        identical results under identical RNG state."""
        for element in elements:
            self.sample(element)

    @abc.abstractmethod
    def result(self) -> Sequence[Any]:
        """The sampled elements (``Sampler.scala:60``).  Single-use samplers
        close and return a fresh list; reusable samplers return a stable
        snapshot (possibly an immutable zero-copy :class:`SampleView`)."""

    @property
    @abc.abstractmethod
    def is_open(self) -> bool:
        """Whether this sampler can still sample (``Sampler.scala:67``)."""


class _SingleUseMixin:
    """Lifecycle state machine (``SingleUse``, ``Sampler.scala:182-194``)."""

    _open = True

    def _check_open(self) -> None:
        if not self._open:
            raise SamplerClosedError(
                "this sampler is single-use, and no longer open"
            )

    def _close(self) -> None:
        self._open = False

    @property
    def is_open(self) -> bool:
        return self._open


class _SingleUseSampler(_SingleUseMixin, Sampler):
    """Single-use wrapper over an oracle engine (``Sampler.scala:334-351,
    414-428``)."""

    def __init__(self, engine) -> None:
        self._engine = engine

    def sample(self, element: Any) -> None:
        self._check_open()
        self._engine.sample(element)

    def sample_all(self, elements: Iterable[Any]) -> None:
        self._check_open()
        self._engine.sample_all(elements)

    def result(self) -> List[Any]:
        self._check_open()
        res = self._engine.result()
        self._close()
        self._engine = None  # free for GC (Sampler.scala:345-350)
        return res


class _ReusableSampler(Sampler):
    """Reusable wrapper (``Sampler.scala:353-381, 430-433``): ``result()``
    snapshots without closing; ``is_open`` is always True (``:380``)."""

    def __init__(self, engine) -> None:
        self._engine = engine

    def sample(self, element: Any) -> None:
        self._engine.sample(element)

    def sample_all(self, elements: Iterable[Any]) -> None:
        self._engine.sample_all(elements)

    def result(self) -> Sequence[Any]:
        # zero-copy with copy-on-write when the engine supports it (the
        # reusable aliasing optimization, Sampler.scala:353-381); the
        # immutable view is a stable snapshot
        view = getattr(self._engine, "result_view", None)
        if view is not None:
            return SampleView(view())
        return self._engine.result()

    @property
    def is_open(self) -> bool:
        return True


def _resolve_rng(rng: Union[None, int, np.random.Generator]) -> np.random.Generator:
    """Explicit RNG in, reproducibility out — the constructor-input design the
    reference's reflection-based tests argue for (``SamplerTest.scala:16-54``)."""
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


def sampler(
    max_sample_size: int,
    *,
    pre_allocate: bool = False,
    reusable: bool = False,
    map_fn: Optional[Callable[[Any], Any]] = None,
    rng: Union[None, int, np.random.Generator] = None,
    native: bool = True,
) -> Sampler:
    """Uniform reservoir sampler, duplicates allowed (``Sampler.apply``,
    ``Sampler.scala:130-136``).

    Each element of the stream has ``k/n`` inclusion probability.  ``map_fn``
    is applied on accept and may be called more than ``k`` times
    (``Sampler.scala:116``).  ``rng`` may be a seed or a ``numpy`` Generator.
    ``native=False`` runs the oracle's Python loop in place of its C scan.
    """
    # validate with an explicit identity but hand the oracle the user's
    # map_fn as given: None tells it the map is identity, unlocking the
    # native bulk scan (oracle/algorithm_l.py module docs)
    validate_non_distinct_params(
        max_sample_size, map_fn if map_fn is not None else _identity
    )
    engine = AlgorithmLOracle(
        max_sample_size, _resolve_rng(rng), map_fn=map_fn, pre_allocate=pre_allocate,
        native=native,
    )
    return _ReusableSampler(engine) if reusable else _SingleUseSampler(engine)


def distinct(
    max_sample_size: int,
    *,
    reusable: bool = False,
    map_fn: Optional[Callable[[Any], Any]] = None,
    hash_fn: Optional[Callable[[Any], int]] = None,
    rng: Union[None, int, np.random.Generator] = None,
    salts: Optional[Tuple[int, int]] = None,
    native: bool = True,
) -> Sampler:
    """Distinct-value sampler (``Sampler.distinct``, ``Sampler.scala:173-180``).

    Each *distinct value* of the stream has uniform inclusion probability.
    ``map_fn`` is applied to every element (it feeds the hash,
    ``Sampler.scala:155``); ``hash_fn`` defaults to a stable 64-bit hash
    covering every stable hashable — ints (identity embedding), floats,
    str/bytes, None, tuples, frozensets (canonical-serialization FNV;
    ``Sampler.scala:75`` analog).  Only objects with process-salted or
    id-based hashes need an explicit ``hash_fn``.  ``native=False`` takes
    the oracle's numpy route in place of its C scan.
    """
    # keep the user's map_fn as given (None = identity): the oracle's
    # vectorized bulk path only engages without a per-element map hook
    validate_non_distinct_params(
        max_sample_size, map_fn if map_fn is not None else _identity
    )
    if hash_fn is not None:
        from .config import validate_hash

        validate_hash(hash_fn)  # explicit hash must be callable (:92-95)
    engine = BottomKOracle(
        max_sample_size,
        _resolve_rng(rng),
        map_fn=map_fn,
        hash_fn=hash_fn,  # None -> oracle's stable default (Sampler.scala:75)
        salts=salts,
        native=native,
    )
    return _ReusableSampler(engine) if reusable else _SingleUseSampler(engine)


class WeightedSampler:
    """Host weighted sampler (A-ExpJ) behind the reference lifecycle.

    Capability beyond the reference (it has no weighted mode — SURVEY §6);
    the surface mirrors :class:`Sampler` except ``sample`` takes
    ``(element, weight)``.  Zero-weight contract: ``w == 0`` is counted but
    never sampled; ``w < 0`` raises — identical to the device engine
    (:mod:`reservoir_tpu_torch.ops.weighted` module docs).
    """

    def __init__(self, engine, reusable: bool) -> None:
        self._engine = engine
        self._reusable = reusable
        self._open = True

    def _check_open(self) -> None:
        if not self._reusable and not self._open:
            raise SamplerClosedError(
                "this sampler is single-use, and no longer open"
            )

    @property
    def is_open(self) -> bool:
        return True if self._reusable else self._open

    def sample(self, element: Any, weight: float) -> None:
        self._check_open()
        self._engine.sample(element, weight)

    def sample_all(
        self,
        pairs: Iterable[Tuple[Any, float]],
        weights: Optional[Any] = None,
    ) -> None:
        """Bulk path: ``sample_all(pairs)`` over ``(element, weight)`` pairs,
        or ``sample_all(elements, weights)`` over parallel arrays — the
        array form takes the vectorized exponential-jump route (identical
        results, C-speed skips) when the engine provides it."""
        self._check_open()
        if weights is not None:
            bulk = getattr(self._engine, "sample_all_arrays", None)
            if bulk is not None:
                bulk(pairs, weights)
            else:
                elems_arr = np.asarray(pairs)
                weights_arr = np.asarray(weights)
                if elems_arr.shape != weights_arr.shape or elems_arr.ndim != 1:
                    # zip() would silently truncate the longer side, and
                    # 2-D rows would fail deep in the oracle instead
                    raise ValueError(
                        "elements and weights must be matching 1-D arrays"
                    )
                self._engine.sample_all(zip(elems_arr, weights_arr))
        else:
            self._engine.sample_all(pairs)

    def result(self) -> List[Any]:
        self._check_open()
        res = self._engine.result()
        if not self._reusable:
            self._open = False
            self._engine = None  # free for GC (Sampler.scala:345-350)
        return res


def weighted(
    max_sample_size: int,
    *,
    reusable: bool = False,
    rng: Union[None, int, np.random.Generator] = None,
    naive: bool = False,
) -> WeightedSampler:
    """Weighted reservoir sampler: k items with inclusion biased by weight
    (Efraimidis-Spirakis keys; A-ExpJ jumps by default, ``naive=True`` for
    the exact A-ES construction used as distributional ground truth)."""
    from .oracle.weighted import AExpJOracle, NaiveWeightedOracle

    cls = NaiveWeightedOracle if naive else AExpJOracle
    engine = cls(max_sample_size, _resolve_rng(rng))
    return WeightedSampler(engine, reusable)
