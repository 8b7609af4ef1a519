"""Causal tracing: lightweight spans with head-based sampling (the port's
copy of the JAX package's ``obs/trace.py``).

:mod:`reservoir_tpu_torch.utils.tracing` puts named ranges into a
``torch.profiler`` capture, which is rarely running when an interesting
failure happens.  This module is the always-available half: a Dapper-style
span record small enough to keep on at production rates.

A :class:`Span` is trace_id/span_id/parent plus a monotonic start, a
duration, a stage tag, and the correlation fields the event log uses
(``shard``/``session``/``flush_seq``/``epoch``), so a span tree joins
against journal frames and event records offline.  The bridge opens
``bridge.queue``, ``bridge.journal`` and ``bridge.dispatch`` spans keyed
by the flush sequence number.

**Head-based sampling**: the keep/drop decision is made once, at the root
(1-in-``sample_every`` by a stable hash of the root key), and every nested
span inherits it through a per-thread stack.  Error and fence paths force
sampling (``force=True``).

Activation follows the fault plane's discipline
(:mod:`reservoir_tpu_torch.utils.faults`, :mod:`reservoir_tpu_torch.obs.registry`):
a module-global :func:`enable`/:func:`disable` pair, every instrumented hot
path gating on ``get() is None``.  Tracing is purely observational:
journals and snapshots are byte-identical with tracing on or off.

:func:`attribution` turns the retained spans into a latency report:
per-stage p50/p99 and share of the end-to-end wait of a root span, plus
the critical path of the worst traces.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "enable",
    "disable",
    "active",
    "get",
    "attribution",
]


class Span:
    """One causal span: identity, timing, stage tag, correlation fields.

    ``trace_id``/``span_id``/``parent_id`` are small process-local ints
    (a root span's trace_id is its own span_id); ``start_s`` is the
    tracer's monotonic clock, ``ts`` the wall clock at start (bundles are
    read by humans), ``duration_s`` is filled at end.  ``fields`` carries
    the correlation keys (``session``/``shard``/``flush_seq``/``epoch``/
    ``error``) the site knows."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name",
        "ts", "start_s", "duration_s", "forced", "fields",
    )

    def __init__(
        self,
        trace_id: int,
        span_id: int,
        parent_id: Optional[int],
        name: str,
        ts: float,
        start_s: float,
        *,
        forced: bool = False,
        fields: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.ts = ts
        self.start_s = start_s
        self.duration_s = 0.0
        self.forced = forced
        self.fields = fields if fields is not None else {}

    def to_dict(self) -> dict:
        """The JSON form bundles and the postmortem viewer consume."""
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "ts": self.ts,
            "start_s": self.start_s,
            "duration_s": self.duration_s,
        }
        if self.forced:
            out["forced"] = True
        if self.fields:
            out["fields"] = dict(self.fields)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, trace={self.trace_id}, "
            f"dur={self.duration_s:.6f}, {self.fields})"
        )


#: Stack sentinel: an *unsampled* root still pushes this, so nested span
#: sites skip in O(1) without re-deciding (head-based sampling: one
#: decision at the root, inherited everywhere below it on this thread).
_SKIP = object()


class Tracer:
    """Bounded retention of causal spans with head-based sampling.

    Finished spans land in a fixed-size ring (``capacity`` most recent;
    the flight recorder's bounded-memory contract extends here), appended
    under the GIL's deque atomicity — no lock on the hot path.  The
    per-thread span stack makes nesting free at call sites: a nested
    ``span()`` needs no parent argument, and a span opened on the bridge's
    dispatch worker is automatically a root there.

    Args:
      sample_every: keep 1-in-N roots (stable ``crc32`` hash of the root
        key, NOT a counter — the same session/seq samples the same way at
        every site, which is what makes cross-site correlation work).
        ``1`` keeps everything (bench/tests).
      capacity: ring size (spans retained for bundles/attribution).
      clock: monotonic duration clock (injectable for tests).
      wall: wall clock stamped on each span start.
    """

    def __init__(
        self,
        *,
        sample_every: int = 8,
        capacity: int = 4096,
        clock=time.perf_counter,
        wall=time.time,
    ) -> None:
        self._sample_every = max(1, int(sample_every))
        self._spans: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self._clock = clock
        self._wall = wall
        self._local = threading.local()
        self.sampled = 0
        self.skipped = 0
        self.forced = 0

    # ------------------------------------------------------------- sampling

    @property
    def sample_every(self) -> int:
        return self._sample_every

    def sample(self, key: Any) -> bool:
        """The head-based keep/drop decision for root key ``key`` — a
        pure function of the key, so every site agrees on it."""
        n = self._sample_every
        if n <= 1:
            return True
        return zlib.crc32(str(key).encode("utf-8")) % n == 0

    # ---------------------------------------------------------------- spans

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        key: Any = None,
        force: bool = False,
        **fields: Any,
    ) -> Iterator[Optional[Span]]:
        """Record one stage.  At a root (no enclosing span on this
        thread), ``key`` drives the sampling decision and ``force=True``
        bypasses it (error/fence/promotion paths).  Nested, the decision
        is inherited: under a sampled root this records a child; under an
        unsampled root it skips in O(1).  Yields the live :class:`Span`
        (``None`` when skipping) so the site can attach late fields."""
        st = self._stack()
        parent: Optional[Span] = None
        if st:
            top = st[-1]
            if top is _SKIP and not force:
                st.append(_SKIP)
                try:
                    yield None
                finally:
                    st.pop()
                return
            parent = top if isinstance(top, Span) else None
        if parent is None and not force and not (
            key is not None and self.sample(key)
        ):
            self.skipped += 1
            st.append(_SKIP)
            try:
                yield None
            finally:
                st.pop()
            return
        span_id = next(self._ids)
        span = Span(
            parent.trace_id if parent is not None else span_id,
            span_id,
            parent.span_id if parent is not None else None,
            name,
            self._wall(),
            self._clock(),
            forced=force,
            fields=dict(fields) if fields else {},
        )
        if force:
            self.forced += 1
        else:
            self.sampled += 1
        st.append(span)
        try:
            yield span
        finally:
            st.pop()
            span.duration_s = self._clock() - span.start_s
            self._spans.append(span)

    def point(
        self,
        name: str,
        *,
        force: bool = True,
        detached: bool = False,
        **fields: Any,
    ) -> Span:
        """A zero-duration marker span (reject/fence/kill markers on the
        failover critical path).  Forced by default — markers exist
        precisely because something went wrong.  ``detached=True`` starts
        its own trace even under an open span (markers whose duration
        spans many calls, like the coalesce wait)."""
        st = self._stack()
        parent = (
            None
            if detached
            else (st[-1] if st and isinstance(st[-1], Span) else None)
        )
        span_id = next(self._ids)
        span = Span(
            parent.trace_id if parent is not None else span_id,
            span_id,
            parent.span_id if parent is not None else None,
            name,
            self._wall(),
            self._clock(),
            forced=force,
            fields=dict(fields) if fields else {},
        )
        self.forced += 1
        self._spans.append(span)
        return span

    # -------------------------------------------------------------- readout

    def spans(self) -> List[Span]:
        """The retained spans, oldest first (bounded by ``capacity``)."""
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def snapshot(self) -> dict:
        return {
            "sample_every": self._sample_every,
            "capacity": self._spans.maxlen,
            "retained": len(self._spans),
            "sampled": self.sampled,
            "skipped": self.skipped,
            "forced": self.forced,
        }


# ---------------------------------------------------------------- activation

_TRACER: Optional[Tracer] = None


def get() -> Optional[Tracer]:
    """The active tracer, or ``None`` (tracing disabled — the default).
    Hot paths gate on this: one global load, one ``is None`` test."""
    return _TRACER


def enable(tracer: Optional[Tracer] = None, **kwargs: Any) -> Tracer:
    """Activate causal tracing process-wide; returns the active tracer.
    Keyword arguments construct one (``sample_every=``, ``capacity=``)."""
    global _TRACER
    if tracer is None:
        tracer = Tracer(**kwargs)
    _TRACER = tracer
    return tracer


def disable() -> None:
    """Deactivate tracing: every span site reverts to the zero-overhead
    no-op path."""
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def active(tracer: Optional[Tracer] = None, **kwargs: Any) -> Iterator[Tracer]:
    """``with trace.active(sample_every=1) as tr: ...`` — scoped (tests)."""
    global _TRACER
    prev = _TRACER
    tr = enable(tracer, **kwargs)
    try:
        yield tr
    finally:
        _TRACER = prev


# -------------------------------------------------------------- attribution


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def attribution(
    spans: Optional[List[Span]] = None,
    *,
    root: str = "bridge.dispatch",
    worst: int = 3,
) -> dict:
    """Per-stage latency attribution over retained spans.

    Groups spans by trace, keeps traces rooted at a ``root``-named span,
    and attributes each span's **self time** (duration minus its direct
    children's durations — spans nest on one thread, so children tile
    their parent) to its stage tag: total time, p50/p99, and share of
    the summed end-to-end wait.  The root's own self time is reported as
    ``other``.  Self times of a trace partition its end-to-end wait, so
    the stage sums plus ``other`` reconcile with the e2e sum *by
    construction*.  ``critical_path`` lists the
    ``worst`` traces by end-to-end wait with their ordered stages and
    correlation fields.
    """
    if spans is None:
        tr = get()
        spans = tr.spans() if tr is not None else []
    by_trace: Dict[int, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    e2e: List[float] = []
    stage_durs: Dict[str, List[float]] = {}
    other_total = 0.0
    traces: List[tuple] = []  # (e2e_s, root_span, children)
    for tid, group in by_trace.items():
        root_span = next((s for s in group if s.name == root), None)
        if root_span is None:
            continue
        children = sorted(
            (s for s in group if s.span_id != root_span.span_id),
            key=lambda s: s.start_s,
        )
        e2e.append(root_span.duration_s)
        child_sum: Dict[int, float] = {}
        for c in children:
            if c.parent_id is not None:
                child_sum[c.parent_id] = (
                    child_sum.get(c.parent_id, 0.0) + c.duration_s
                )
        for c in children:
            self_s = max(
                0.0, c.duration_s - child_sum.get(c.span_id, 0.0)
            )
            stage_durs.setdefault(c.name, []).append(self_s)
        other_total += max(
            0.0,
            root_span.duration_s - child_sum.get(root_span.span_id, 0.0),
        )
        traces.append((root_span.duration_s, root_span, children))
    e2e_sorted = sorted(e2e)
    e2e_sum = sum(e2e)
    stages: Dict[str, dict] = {}
    for name in sorted(stage_durs):
        durs = sorted(stage_durs[name])
        total = sum(durs)
        stages[name] = {
            "count": len(durs),
            "sum_s": total,
            "p50_s": _quantile(durs, 0.5),
            "p99_s": _quantile(durs, 0.99),
            "share": (total / e2e_sum) if e2e_sum else 0.0,
        }
    traces.sort(key=lambda t: t[0], reverse=True)
    critical = []
    for dur, root_span, children in traces[: max(0, int(worst))]:
        critical.append({
            "trace_id": root_span.trace_id,
            "e2e_s": dur,
            "fields": dict(root_span.fields),
            "stages": [
                {
                    "name": c.name,
                    "duration_s": c.duration_s,
                    **{
                        k: v
                        for k, v in c.fields.items()
                        if k in ("session", "shard", "flush_seq", "epoch")
                    },
                }
                for c in children
            ],
        })
    return {
        "root": root,
        "traces": len(e2e),
        "spans": len(spans),
        "e2e_s": {
            "count": len(e2e),
            "sum": e2e_sum,
            "mean": (e2e_sum / len(e2e)) if e2e else 0.0,
            "p50": _quantile(e2e_sorted, 0.5),
            "p99": _quantile(e2e_sorted, 0.99),
        },
        "stages": stages,
        "other": {
            "sum_s": other_total,
            "share": (other_total / e2e_sum) if e2e_sum else 0.0,
        },
        "critical_path": critical,
    }
