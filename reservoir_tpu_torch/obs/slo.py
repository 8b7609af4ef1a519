"""Declarative SLOs with multi-window burn-rate verdicts (the port's copy
of the JAX package's ``obs/slo.py``, the same verdicts).

A set of :class:`SLOSpec` objectives is evaluated over **rolling windows**
of the :class:`~reservoir_tpu_torch.obs.registry.Registry` instruments,
each yielding an ``ok`` / ``warn`` / ``page`` verdict with the burn rates
that justify it.

The model is the multi-window burn rate of the Google SRE workbook
(ch. 5): an objective grants an **error budget**, the fraction of events
allowed to be bad (``1 - quantile`` for a latency objective, an explicit
``budget`` for error-rate objectives).  The *burn rate* over a window is
``observed_bad_fraction / budget``.  A verdict escalates only when **both**
the short window and the long window agree:

- ``page``: both windows burn at >= ``page_burn`` (default 14.4);
- ``warn``: both windows burn at >= ``warn_burn`` (default 3.0);
- ``ok``: anything less.

Four objective kinds, all reading instruments the stack feeds:

- ``latency_quantile``: a registry histogram of seconds; a bad event is an
  observation above ``threshold``, and the budget is ``1 - quantile``;
- ``staleness``: the same over a staleness histogram
  (``serve.snapshot_staleness_s``);
- ``error_rate``: two counters, bad over total, with an explicit
  ``budget`` fraction (``serve.ingest_errors`` / ``serve.ingest_total``);
- ``sample_quality``: the counters a sample-quality auditor feeds
  (``audit.ks_breaches`` / ``audit.ks_checks``), judged as an error rate;
  ``value_instrument`` (default ``audit.ks_statistic``) carries the live
  KS distance into the verdict.

An :class:`SLOPlane` holds the specs and a bounded history of instrument
frames; every :meth:`~SLOPlane.evaluate` records one frame and diffs it
against the newest frame at least one window old (or the oldest frame: a
young plane judges everything since construction).  The plane attaches
itself to its registry, so :func:`~reservoir_tpu_torch.obs.export.json_snapshot`
(and so ``heartbeat.json``) and the Prometheus exporter carry the verdicts.
Nothing here sits on a hot path: evaluation happens at the export or
heartbeat cadence.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, Iterable, Optional, Tuple

from . import registry as _obs
from .registry import Counter, Histogram, Registry

__all__ = ["SLOSpec", "SLOVerdict", "SLOPlane", "default_slos", "KINDS"]

#: The objective kinds :class:`SLOSpec` accepts.
KINDS: Tuple[str, ...] = (
    "latency_quantile",
    "staleness",
    "error_rate",
    "sample_quality",
)

#: Verdict severity order (worst() folds with this).
_SEVERITY = {"ok": 0, "warn": 1, "page": 2}


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over registry instruments.

    Attributes:
      name: verdict key (stable across exports — dashboards join on it).
      kind: one of :data:`KINDS`.
      instrument: the histogram (latency/staleness kinds) or the
        bad-event counter (error kinds) to read.
      threshold: the objective bound — seconds for latency/staleness
        (an observation above it is a bad event); for error kinds it is
        display-only context (the gate the bad counter already applied,
        e.g. the auditor's KS gate).
      quantile: latency/staleness only — the objective's quantile; the
        error budget is ``1 - quantile``.
      total_instrument: error kinds only — the total-events counter.
      budget: error kinds only — allowed bad fraction (0..1).
      short_window_s / long_window_s: the two burn-rate windows.
      warn_burn / page_burn: burn-rate escalation thresholds (both
        windows must agree).
      value_instrument: optional gauge whose live value rides the
        verdict (``sample_quality`` defaults it to the auditor's
        ``audit.ks_statistic``).
      description: human objective line for status panels.
    """

    name: str
    kind: str
    instrument: str
    threshold: float = 0.0
    quantile: float = 0.99
    total_instrument: str = ""
    budget: float = 0.01
    short_window_s: float = 300.0
    long_window_s: float = 3600.0
    warn_burn: float = 3.0
    page_burn: float = 14.4
    value_instrument: str = ""
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"SLOSpec {self.name!r}: kind must be one of {KINDS}, "
                f"got {self.kind!r}"
            )
        if self.kind in ("latency_quantile", "staleness"):
            if not (0.0 < self.quantile < 1.0):
                raise ValueError(
                    f"SLOSpec {self.name!r}: quantile must be in (0, 1)"
                )
            if self.threshold <= 0.0:
                raise ValueError(
                    f"SLOSpec {self.name!r}: latency/staleness objectives "
                    "need a positive threshold (seconds)"
                )
        else:
            if not self.total_instrument:
                raise ValueError(
                    f"SLOSpec {self.name!r}: error-rate objectives need "
                    "total_instrument"
                )
            if not (0.0 < self.budget < 1.0):
                raise ValueError(
                    f"SLOSpec {self.name!r}: budget must be in (0, 1)"
                )
        if not (0 < self.short_window_s <= self.long_window_s):
            raise ValueError(
                f"SLOSpec {self.name!r}: need 0 < short_window_s <= "
                "long_window_s"
            )
        if not (0 < self.warn_burn <= self.page_burn):
            raise ValueError(
                f"SLOSpec {self.name!r}: need 0 < warn_burn <= page_burn"
            )

    def error_budget(self) -> float:
        """The allowed bad-event fraction this objective grants."""
        if self.kind in ("latency_quantile", "staleness"):
            return 1.0 - self.quantile
        return self.budget

    def objective(self) -> str:
        """One-line human rendering for status panels."""
        if self.description:
            return self.description
        if self.kind in ("latency_quantile", "staleness"):
            return (
                f"p{self.quantile * 100:g} {self.instrument} "
                f"<= {self.threshold * 1e3:g}ms"
            )
        return (
            f"{self.instrument}/{self.total_instrument} "
            f"<= {self.budget:g}"
        )


@dataclasses.dataclass
class SLOVerdict:
    """One evaluated objective: the actionable ``verdict`` plus the burn
    rates and window deltas that justify it (``bad``/``total`` are the
    short-window event deltas)."""

    name: str
    kind: str
    verdict: str
    burn_short: float
    burn_long: float
    bad: float
    total: float
    budget: float
    threshold: float
    value: float
    objective: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def default_slos(
    *,
    ingest_p99_s: float = 0.050,
    snapshot_p99_s: float = 0.050,
    staleness_s: float = 2.0,
    error_budget: float = 0.01,
    quality_budget: float = 0.05,
    short_window_s: float = 300.0,
    long_window_s: float = 3600.0,
    scope: Optional[str] = None,
) -> Tuple[SLOSpec, ...]:
    """The serving plane's standard objective set: ingest and snapshot
    latency, snapshot staleness, admission error rate, and sample quality.

    ``scope`` labels every instrument name with a per-shard scope
    (:func:`~reservoir_tpu_torch.obs.registry.scoped`): a cluster runs one
    :class:`SLOPlane` per shard over ``serve.*@shardN`` instruments, so one
    saturated shard pages alone while its neighbors stay ``ok``.  Spec
    names are unchanged: planes are per-shard objects, so dashboards join
    on the same objective names across shards."""
    common = dict(
        short_window_s=short_window_s, long_window_s=long_window_s
    )

    def _n(name: str) -> str:
        return _obs.scoped(name, scope)

    return (
        SLOSpec(
            "ingest_latency_p99",
            "latency_quantile",
            _n("serve.ingest_s"),
            threshold=ingest_p99_s,
            quantile=0.99,
            **common,
        ),
        SLOSpec(
            "snapshot_latency_p99",
            "latency_quantile",
            _n("serve.snapshot_s"),
            threshold=snapshot_p99_s,
            quantile=0.99,
            **common,
        ),
        SLOSpec(
            "snapshot_staleness_p99",
            "staleness",
            _n("serve.snapshot_staleness_s"),
            threshold=staleness_s,
            quantile=0.99,
            **common,
        ),
        SLOSpec(
            "ingest_error_rate",
            "error_rate",
            _n("serve.ingest_errors"),
            total_instrument=_n("serve.ingest_total"),
            budget=error_budget,
            **common,
        ),
        SLOSpec(
            "sample_quality",
            "sample_quality",
            _n("audit.ks_breaches"),
            total_instrument=_n("audit.ks_checks"),
            budget=quality_budget,
            value_instrument=_n("audit.ks_statistic"),
            **common,
        ),
    )


class SLOPlane:
    """Burn-rate evaluator over one registry.

    Single-writer like the metric blocks: call :meth:`evaluate` from one
    thread (the heartbeat/export cadence).  Construction records the
    baseline frame, so the first evaluation already judges everything
    observed since the plane came up.

    Args:
      specs: objectives (default: :func:`default_slos`).
      registry: the registry to read; ``None`` binds to the active one at
        each call (and the plane attaches itself to whichever registry it
        reads, so exporters find it via ``registry.slo_plane``).
      clock: time source (injectable for deterministic window tests).
      max_frames: bounded history (frames arrive at evaluation cadence;
        the default covers an hour-long window at one-second beats).
      attach: publish this plane on its registry (``registry.slo_plane``)
        so exporters pick the verdicts up.  Per-shard planes pass
        ``False``: N shard planes must not fight over the one registry
        slot; the cluster aggregates their verdicts itself.
    """

    def __init__(
        self,
        specs: Optional[Iterable[SLOSpec]] = None,
        registry: Optional[Registry] = None,
        *,
        clock=time.time,
        max_frames: int = 4096,
        attach: bool = True,
    ) -> None:
        self._attach = bool(attach)
        self.specs: Tuple[SLOSpec, ...] = tuple(
            specs if specs is not None else default_slos()
        )
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._registry = registry
        self._clock = clock
        self._frames: Deque[Tuple[float, Dict[str, Tuple[float, float]]]] = (
            collections.deque(maxlen=max_frames)
        )
        self.last: Dict[str, SLOVerdict] = {}
        reg = self._resolve()
        if reg is not None:
            self._frames.append((float(clock()), self._capture(reg)))

    # ------------------------------------------------------------- plumbing

    def _resolve(self) -> Optional[Registry]:
        reg = self._registry if self._registry is not None else _obs.get()
        if (
            self._attach
            and reg is not None
            and getattr(reg, "slo_plane", None) is not self
        ):
            reg.slo_plane = self  # exporters find the plane via its registry
        return reg

    @staticmethod
    def _histogram_bad(h: Histogram, threshold: float) -> Tuple[float, float]:
        """(bad, total) for a histogram objective: observations whose
        bucket representative (the same geometric midpoint ``quantile()``
        reads back) exceeds ``threshold``.  Overflow is always bad."""
        counts = h.bucket_counts()
        bounds = h.bounds()
        bad = counts[-1]  # > hi: worse than any finite bucket
        for i, c in enumerate(counts[:-1]):
            if not c:
                continue
            lower = bounds[i - 1] if i else 0.0
            rep = math.sqrt(lower * bounds[i]) if lower else bounds[i]
            if rep > threshold:
                bad += c
        return float(bad), float(sum(counts))

    def _capture(
        self, reg: Registry
    ) -> Dict[str, Tuple[float, float]]:
        """One frame: per-spec (bad, total) cumulative event counts.
        Missing instruments read as (0, 0) — :meth:`Registry.peek` never
        creates, so the plane cannot geometry-default a histogram into
        existence before its owning site does."""
        frame: Dict[str, Tuple[float, float]] = {}
        for spec in self.specs:
            inst = reg.peek(spec.instrument)
            if spec.kind in ("latency_quantile", "staleness"):
                frame[spec.name] = (
                    self._histogram_bad(inst, spec.threshold)
                    if isinstance(inst, Histogram)
                    else (0.0, 0.0)
                )
            else:
                total = reg.peek(spec.total_instrument)
                frame[spec.name] = (
                    float(inst.value) if isinstance(inst, Counter) else 0.0,
                    float(total.value)
                    if isinstance(total, Counter)
                    else 0.0,
                )
        return frame

    def _window_base(
        self, now: float, window_s: float
    ) -> Dict[str, Tuple[float, float]]:
        """The newest frame at least ``window_s`` old, else the oldest
        frame (a young plane judges its whole life)."""
        base = self._frames[0][1] if self._frames else {}
        for ts, frame in self._frames:
            if ts <= now - window_s:
                base = frame
            else:
                break
        return base

    # ------------------------------------------------------------ judgment

    def evaluate(self, now: Optional[float] = None) -> Dict[str, SLOVerdict]:
        """Record one frame and judge every objective; returns (and
        caches in :attr:`last`) the verdicts keyed by spec name."""
        reg = self._resolve()
        if reg is None:
            return dict(self.last)  # telemetry off: nothing new to judge
        now = float(self._clock()) if now is None else float(now)
        frame = self._capture(reg)
        verdicts: Dict[str, SLOVerdict] = {}
        for spec in self.specs:
            budget = spec.error_budget()
            burns: Dict[float, Tuple[float, float, float]] = {}
            for window in (spec.short_window_s, spec.long_window_s):
                base = self._window_base(now, window)
                b0, t0 = base.get(spec.name, (0.0, 0.0))
                bad = max(0.0, frame[spec.name][0] - b0)
                total = max(0.0, frame[spec.name][1] - t0)
                frac = (bad / total) if total > 0 else 0.0
                burns[window] = (frac / budget, bad, total)
            burn_short, bad_s, total_s = burns[spec.short_window_s]
            burn_long, _, _ = burns[spec.long_window_s]
            floor = min(burn_short, burn_long)
            verdict = (
                "page"
                if floor >= spec.page_burn
                else "warn" if floor >= spec.warn_burn else "ok"
            )
            value = 0.0
            if spec.kind in ("latency_quantile", "staleness"):
                inst = reg.peek(spec.instrument)
                if isinstance(inst, Histogram):
                    value = inst.quantile(spec.quantile)
            elif spec.value_instrument:
                inst = reg.peek(spec.value_instrument)
                value = float(getattr(inst, "value", 0.0) or 0.0)
            else:
                value = (bad_s / total_s) if total_s > 0 else 0.0
            verdicts[spec.name] = SLOVerdict(
                name=spec.name,
                kind=spec.kind,
                verdict=verdict,
                burn_short=burn_short,
                burn_long=burn_long,
                bad=bad_s,
                total=total_s,
                budget=budget,
                threshold=spec.threshold,
                value=value,
                objective=spec.objective(),
            )
        paged = [
            name
            for name, v in verdicts.items()
            if v.verdict == "page"
            and (
                name not in self.last
                or self.last[name].verdict != "page"
            )
        ]
        self._frames.append((now, frame))
        self.last = verdicts
        if paged:
            # an SLO page transition is a flight-recorder trigger: the page
            # should arrive with its own postmortem bundle
            from . import flight as _flight

            fl = _flight.get()
            if fl is not None:
                fl.trigger("slo_page", slos=",".join(sorted(paged)))
        return verdicts

    def worst(self) -> str:
        """The most severe verdict across :attr:`last` (``ok`` when the
        plane has never evaluated)."""
        if not self.last:
            return "ok"
        return max(
            (v.verdict for v in self.last.values()),
            key=lambda v: _SEVERITY[v],
        )

    def snapshot(self, evaluate: bool = True) -> Dict[str, object]:
        """JSON-able export payload (what ``json_snapshot`` embeds under
        ``"slo"``)."""
        if evaluate:
            self.evaluate()
        return {
            "worst": self.worst(),
            "verdicts": {k: v.as_dict() for k, v in self.last.items()},
        }
