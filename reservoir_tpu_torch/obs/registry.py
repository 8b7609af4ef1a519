"""Thread-safe instrument registry: counters, gauges, latency histograms
(the port's copy of the JAX package's ``obs/registry.py``).

A :class:`Registry` is a named map of three instrument kinds:

- :class:`Counter` — monotonically increasing totals (flushes, rejections);
- :class:`Gauge` — last-write-wins levels;
- :class:`Histogram` — fixed **log-spaced** buckets over a configurable
  range, with exact ``count``/``sum``/``min``/``max`` and bucketed
  p50/p99/p99.9 readout.  Log spacing keeps the relative quantile error
  bounded by one bucket's width (``10**(1/buckets_per_decade)``, ~12% at
  the default 20 buckets per decade) across nine decades of latency.

Activation follows the fault plane's discipline
(:mod:`reservoir_tpu_torch.utils.faults`): a module-global
:func:`enable`/:func:`disable` pair, and every instrumented hot path gates
on ``get() is None`` — one module-global load and one ``is None`` test when
disabled, no locks, no allocation.  Instruments are created lazily on first
use and are individually locked; the registry lock is taken only at
get-or-create.

Metric dataclasses (:class:`~reservoir_tpu_torch.utils.metrics.BridgeMetrics`)
stay plain single-writer counter blocks and are tracked by registration
(:func:`register_block`): every block constructed in the process is weakly
tracked, so a reader can render live blocks' ``snapshot()`` beside the
registry's own instruments.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "enable",
    "disable",
    "active",
    "get",
    "emit",
    "register_block",
    "blocks",
    "scoped",
]

#: Separator of the scoped instrument-label convention:
#: ``bridge.flush_s@shard0`` is shard 0's flush histogram — same metric
#: family as the unscoped name, disjoint instrument.
SCOPE_SEP = "@"


def scoped(name: str, scope: Optional[str] = None) -> str:
    """``name`` labeled with an instrument scope (``None`` = unscoped)."""
    return name if not scope else f"{name}{SCOPE_SEP}{scope}"


class Counter:
    """A monotonically increasing total (single instrument, thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        # reservoir-lint: disable=guarded-by -- lock-free .value readout: a single float attribute read is GIL-atomic (exact-or-stale, never torn)
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A last-write-wins level (thread-safe set/add)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        # reservoir-lint: disable=guarded-by -- lock-free .value readout: last-write-wins, a single float attribute read is GIL-atomic
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed log-spaced buckets with exact count/sum/min/max and bucketed
    quantile readout.

    Buckets are deterministic pure functions of ``(lo, hi,
    buckets_per_decade)``: bucket ``i`` holds values in
    ``(lo * 10**(i/bpd), lo * 10**((i+1)/bpd)]``, values ``<= lo`` land in
    bucket 0, values ``> hi`` in a dedicated overflow bucket whose
    representative is the exact observed max.  A quantile readout returns
    the geometric midpoint of the selected bucket, clamped to the exact
    observed ``[min, max]`` — so a single observation reads back exactly,
    and relative error is bounded by one bucket width.
    """

    __slots__ = (
        "name", "_lo", "_hi", "_bpd", "_n", "_counts",
        "_count", "_sum", "_min", "_max", "_lock",
    )

    def __init__(
        self,
        name: str,
        lo: float = 1e-6,
        hi: float = 1e3,
        buckets_per_decade: int = 20,
    ) -> None:
        if not (lo > 0 and hi > lo and buckets_per_decade > 0):
            raise ValueError(
                "histogram needs 0 < lo < hi and buckets_per_decade > 0"
            )
        self.name = name
        self._lo = float(lo)
        self._hi = float(hi)
        self._bpd = int(buckets_per_decade)
        self._n = int(math.ceil(math.log10(hi / lo) * buckets_per_decade))
        self._counts = [0] * (self._n + 1)  # +1: overflow (> hi)
        # reservoir-lint: disable=guarded-by -- lock-free stats readout: per-field reads are GIL-atomic; cross-field skew vs a concurrent observe() is accepted monitoring semantics (quantile() does lock)
        self._count = 0
        # reservoir-lint: disable=guarded-by -- lock-free stats readout (see _count)
        self._sum = 0.0
        # reservoir-lint: disable=guarded-by -- lock-free stats readout (see _count)
        self._min = math.inf
        # reservoir-lint: disable=guarded-by -- lock-free stats readout (see _count)
        self._max = -math.inf
        self._lock = threading.Lock()

    # ------------------------------------------------------------- geometry

    def bounds(self) -> List[float]:
        """Upper bucket bounds (exclusive of the overflow bucket) — a pure
        function of the constructor args, pinned by the determinism test."""
        return [
            self._lo * 10 ** ((i + 1) / self._bpd) for i in range(self._n)
        ]

    def bucket_counts(self) -> List[int]:
        """Per-bucket counts (last entry is the ``> hi`` overflow bucket)."""
        with self._lock:
            return list(self._counts)

    def _index(self, v: float) -> int:
        if v <= self._lo:
            return 0
        if v > self._hi:
            return self._n
        i = int(math.floor(math.log10(v / self._lo) * self._bpd))
        # float round-off can land an exact boundary one bucket high/low;
        # clamp into the regular range (the overflow bucket is > hi only)
        return min(max(i, 0), self._n - 1)

    # ------------------------------------------------------------ recording

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # -------------------------------------------------------------- readout

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def quantile(self, q: float) -> float:
        """The q-quantile (0..1) from the bucket counts, clamped to the
        exact observed range.  0.0 when nothing was observed."""
        with self._lock:
            if not self._count:
                return 0.0
            rank = max(1, int(math.ceil(q * self._count)))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    break
            if i >= self._n:  # overflow bucket: the max is its witness
                return self._max
            upper = self._lo * 10 ** ((i + 1) / self._bpd)
            lower = self._lo * 10 ** (i / self._bpd) if i else 0.0
            rep = math.sqrt(lower * upper) if lower else upper
            return min(max(rep, self._min), self._max)

    def percentiles(self) -> Tuple[float, float, float]:
        """(p50, p99, p99.9) — the latency readout every consumer wants."""
        return self.quantile(0.5), self.quantile(0.99), self.quantile(0.999)

    def snapshot(self) -> Dict[str, float]:
        p50, p99, p999 = self.percentiles()
        n = self._count
        return {
            "count": n,
            "sum": self._sum,
            "mean": (self._sum / n) if n else 0.0,
            "min": self.min,
            "max": self.max,
            "p50": p50,
            "p99": p99,
            "p999": p999,
        }


class Registry:
    """A named, thread-safe map of instruments (get-or-create semantics:
    ``registry.histogram("bridge.flush_s")`` from any thread returns the
    one shared instrument).  An optional
    :class:`~reservoir_tpu_torch.obs.events.EventLog` rides along — the
    structured half of the plane — reachable through :func:`emit`."""

    def __init__(self, event_log=None) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self.event_log = event_log

    def _get(self, name: str, cls, *args, **kwargs):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, *args, **kwargs)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"instrument {name!r} is a {type(inst).__name__}, not a "
                f"{cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self,
        name: str,
        lo: float = 1e-6,
        hi: float = 1e3,
        buckets_per_decade: int = 20,
    ) -> Histogram:
        return self._get(name, Histogram, lo, hi, buckets_per_decade)

    def peek(self, name: str) -> Optional[object]:
        """The instrument named ``name``, or ``None`` — never creates.
        Readers that must not geometry-default a histogram into existence
        before its owning site does (the SLO plane) use this."""
        return self._instruments.get(name)

    def instruments(self) -> List[object]:
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time view of every instrument, grouped by kind."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.instruments():
            if isinstance(inst, Counter):
                out["counters"][inst.name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][inst.name] = inst.value
            else:
                out["histograms"][inst.name] = inst.snapshot()
        return out


# ---------------------------------------------------------------- activation

_REGISTRY: Optional[Registry] = None


def get() -> Optional[Registry]:
    """The active registry, or ``None`` (telemetry disabled — the default).
    Hot paths gate on this: one global load, one ``is None`` test."""
    return _REGISTRY


def enable(
    registry: Optional[Registry] = None,
    *,
    event_log=None,
    event_log_path: Optional[str] = None,
) -> Registry:
    """Activate telemetry process-wide; returns the active registry.
    ``event_log_path`` opens a fresh
    :class:`~reservoir_tpu_torch.obs.events.EventLog` there (``event_log``
    passes one in); with neither, :func:`emit` stays a no-op."""
    global _REGISTRY
    if registry is None:
        registry = Registry(event_log=event_log)
    elif event_log is not None:
        registry.event_log = event_log
    if event_log_path is not None:
        from .events import EventLog

        registry.event_log = EventLog(event_log_path)
    _REGISTRY = registry
    return registry


def disable() -> None:
    """Deactivate telemetry (closing any active event log): every
    instrumented site reverts to the zero-overhead no-op path."""
    global _REGISTRY
    reg, _REGISTRY = _REGISTRY, None
    if reg is not None and reg.event_log is not None:
        reg.event_log.close()


@contextlib.contextmanager
def active(registry: Optional[Registry] = None, **kwargs) -> Iterator[Registry]:
    """``with obs.active() as reg: ...`` — scoped activation (tests)."""
    global _REGISTRY
    prev = _REGISTRY
    reg = enable(registry, **kwargs)
    try:
        yield reg
    finally:
        if reg.event_log is not None:
            reg.event_log.close()
        _REGISTRY = prev


# The flight recorder's event tap (obs/flight.py): when installed, every
# emit() lands in its bounded ring — even events the rate-limited log
# drops, and even with no registry active.  None (the default) costs one
# global load + ``is None`` test, the same budget as the registry gate.
_EVENT_TAP = None


def _set_event_tap(tap) -> None:
    global _EVENT_TAP
    _EVENT_TAP = tap


def emit(event: str, **fields) -> bool:
    """Write one structured event through the active registry's event log.
    No registry or no log: a no-op (global load + ``is None`` tests) —
    safe on any path, any rate."""
    tap = _EVENT_TAP
    if tap is not None:
        tap(event, fields)
    reg = _REGISTRY
    if reg is None:
        return False
    log = reg.event_log
    if log is None:
        return False
    return log.emit(event, **fields)


# ------------------------------------------------------------- metric blocks

# Released metric dataclasses register here at construction (their
# __post_init__), so exporters can render every live block without the
# owners growing new API.  Weak references: a block dies with its owner.
_BLOCKS_LOCK = threading.Lock()
_BLOCKS: List[Tuple[str, int, "weakref.ref"]] = []
_BLOCK_IDS = itertools.count()


def register_block(kind: str, block: object) -> None:
    """Track a metrics dataclass (``snapshot()``-bearing) for export under
    ``kind`` (``bridge``/``serve``/``ha``).  Construction-time only — never
    on a hot path."""
    ref = weakref.ref(block)
    with _BLOCKS_LOCK:
        _BLOCKS.append((kind, next(_BLOCK_IDS), ref))


def blocks() -> List[Tuple[str, int, object]]:
    """Live registered blocks as ``(kind, instance_id, block)``, pruning
    dead references in place."""
    out: List[Tuple[str, int, object]] = []
    with _BLOCKS_LOCK:
        alive = []
        for kind, idx, ref in _BLOCKS:
            obj = ref()
            if obj is not None:
                alive.append((kind, idx, ref))
                out.append((kind, idx, obj))
        _BLOCKS[:] = alive
    return out
