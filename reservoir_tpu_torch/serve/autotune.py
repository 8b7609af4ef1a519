"""Service-knob autotuner: the knob cache and the online SLO closed loop.

The port's copy of the JAX package's ``serve/autotune.py``.  The serving
plane's knobs (``coalesce_bytes``, ``max_inflight_bytes``,
``checkpoint_every``, ``sweep_interval_s``, ``gate_push_chunk``) have
winners that depend on the workload as well as the device.  Two halves:

- **the knob cache**: a swept winner is kept under a *workload
  fingerprint* key (``serve|device|R|k|mode|gated|rate-band|zipf-band``) in
  the autotune store (:mod:`reservoir_tpu_torch.ops.autotune`, the JAX
  package's JSON file and keys).
  :class:`~reservoir_tpu_torch.serve.service.ReservoirService` takes the
  cached winner for any knob left unset at construction; an explicit
  argument always wins, and without an entry the builtin defaults hold.
  On the card the device field is ``torch.cuda.get_device_name``.
- **the online controller** (:class:`ServiceTuner`): it reads an SLO
  plane's burn verdict (any object with ``evaluate(now)`` and ``worst()``)
  and nudges the live knobs inside declared bounds with AIMD hysteresis: a
  multiplicative backoff toward each knob's safe end on a warn or page,
  an additive re-probe toward the optimum after a healthy dwell.  Each
  decision is kept, emitted as a ``tune.decide`` event, traced as a span
  and set on ``tune.*`` instruments while telemetry is on.

The controller never touches what is sampled: a nudge changes when bytes
ship and state checkpoints, never the reservoirs.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, NamedTuple, Optional, Tuple

from ..obs import registry as _obs
from ..obs import trace as _trace
from ..ops import autotune as _store

__all__ = [
    "ServiceKnobs",
    "DEFAULT_KNOBS",
    "KnobBounds",
    "DEFAULT_BOUNDS",
    "SAFE_END",
    "device_kind_of",
    "rate_band",
    "zipf_band",
    "make_serve_key",
    "lookup_knobs",
    "record_knobs",
    "TuneDecision",
    "ServiceTuner",
]


class ServiceKnobs(NamedTuple):
    """One complete serving-knob assignment.

    ``sweep_interval_s=0.0`` means manual-only sweeps (the service's
    ``None``); ``gate_push_chunk=0`` defers to the bridge's own default
    (1 Mi).  Both zeros survive the JSON
    round-trip, which is why the sentinel is numeric here rather than
    ``None``."""

    coalesce_bytes: int
    max_inflight_bytes: int
    checkpoint_every: int
    sweep_interval_s: float
    gate_push_chunk: int


#: The service's builtin defaults, as a knob vector: what a service takes
#: when the cache has no entry for its fingerprint.
DEFAULT_KNOBS = ServiceKnobs(
    coalesce_bytes=1 << 16,
    max_inflight_bytes=1 << 24,
    checkpoint_every=64,
    sweep_interval_s=0.0,
    gate_push_chunk=0,
)

#: Which end of a knob's range is the SAFE end under latency burn:
#: smaller coalesce/admission/push-chunk = shed earlier + smaller device
#: dispatches; larger checkpoint/sweep cadence = less background work on
#: the ingest path.
SAFE_END = {
    "coalesce_bytes": "lo",
    "max_inflight_bytes": "lo",
    "checkpoint_every": "hi",
    "sweep_interval_s": "hi",
    "gate_push_chunk": "lo",
}


@dataclass(frozen=True)
class KnobBounds:
    """Declared safe range per knob — the controller clamps every nudge
    into these, so a pathological burn signal can degrade throughput but
    never push a knob somewhere the service was not designed to run."""

    coalesce_bytes: Tuple[int, int] = (1 << 12, 1 << 22)
    max_inflight_bytes: Tuple[int, int] = (1 << 16, 1 << 28)
    checkpoint_every: Tuple[int, int] = (8, 1024)
    sweep_interval_s: Tuple[float, float] = (0.05, 30.0)
    gate_push_chunk: Tuple[int, int] = (1 << 12, 1 << 22)

    def clamp(self, name: str, value):
        lo, hi = getattr(self, name)
        return min(hi, max(lo, value))


DEFAULT_BOUNDS = KnobBounds()


# --------------------------------------------------------------- fingerprint


#: the device name the cache keys on (:func:`.ops.autotune.device_kind`)
device_kind_of = _store.device_kind


def rate_band(rate: Optional[float]) -> str:
    """Decade band of the offered arrival rate (``1e3`` = [1000, 10000)),
    ``any`` when unknown — knob winners are stable within an order of
    magnitude of load, not at one exact rate."""
    if rate is None or rate <= 0:
        return "any"
    return f"1e{int(math.floor(math.log10(rate)))}"


def zipf_band(zipf_s: Optional[float]) -> str:
    """Key-skew band: the Zipf exponent rounded to the nearest 0.5
    (``1.0`` covers s in [0.75, 1.25)), ``any`` when unknown."""
    if zipf_s is None or zipf_s < 0:
        return "any"
    return f"{round(zipf_s * 2) / 2:.1f}"


def make_serve_key(
    device_kind: str,
    R: int,
    k: int,
    mode: str,
    gated: bool,
    rate: Optional[float] = None,
    zipf_s: Optional[float] = None,
) -> str:
    """Workload-fingerprint cache key for a serve-knob entry.  ``mode`` is
    ``plain`` / ``weighted`` / ``distinct`` (what the sessions sample);
    rate/skew land in coarse bands so one sweep covers a neighborhood."""
    if mode not in ("plain", "weighted", "distinct"):
        raise ValueError(f"unknown service mode {mode!r}")
    return (
        f"serve|{device_kind}|R={R}|k={k}|mode={mode}"
        f"|gated={int(bool(gated))}"
        f"|rate={rate_band(rate)}|zipf={zipf_band(zipf_s)}"
    )


def lookup_knobs(
    device_kind: str,
    R: int,
    k: int,
    mode: str,
    gated: bool,
    rate: Optional[float] = None,
    zipf_s: Optional[float] = None,
    path: Optional[str] = None,
) -> Optional[ServiceKnobs]:
    """The tuned knob vector for this workload fingerprint, or ``None``
    (keep the builtin defaults).  Falls back from the exact rate/skew
    bands to the ``any`` entry, so a service constructed without a
    traffic forecast still gets the sweep's overall winner."""
    data = _store.load(path)
    for key in (
        make_serve_key(device_kind, R, k, mode, gated, rate, zipf_s),
        make_serve_key(device_kind, R, k, mode, gated, None, None),
    ):
        entry = data.get(key)
        if isinstance(entry, dict):
            try:
                return ServiceKnobs(
                    coalesce_bytes=int(entry["coalesce_bytes"]),
                    max_inflight_bytes=int(entry["max_inflight_bytes"]),
                    checkpoint_every=int(entry["checkpoint_every"]),
                    sweep_interval_s=float(
                        entry.get("sweep_interval_s", 0.0)
                    ),
                    gate_push_chunk=int(entry.get("gate_push_chunk", 0)),
                )
            except (KeyError, TypeError, ValueError):
                return None
    return None


def record_knobs(
    device_kind: str,
    R: int,
    k: int,
    mode: str,
    gated: bool,
    knobs: ServiceKnobs,
    rate: Optional[float] = None,
    zipf_s: Optional[float] = None,
    elem_per_sec: Optional[float] = None,
    ingest_p99_s: Optional[float] = None,
    source: Optional[str] = None,
    path: Optional[str] = None,
) -> str:
    """Persist one swept winner under its workload fingerprint (atomic
    merge into the shared store; other entries untouched).
    Returns the key written.  Provenance rides along like the kernel
    entries' ``elem_per_sec``/``source``."""
    knobs = ServiceKnobs(*knobs)
    entry = {
        "coalesce_bytes": int(knobs.coalesce_bytes),
        "max_inflight_bytes": int(knobs.max_inflight_bytes),
        "checkpoint_every": int(knobs.checkpoint_every),
        "sweep_interval_s": float(knobs.sweep_interval_s),
        "gate_push_chunk": int(knobs.gate_push_chunk),
    }
    if elem_per_sec is not None:
        entry["elem_per_sec"] = float(elem_per_sec)
    if ingest_p99_s is not None:
        entry["ingest_p99_s"] = float(ingest_p99_s)
    if source is not None:
        entry["source"] = source
    key = make_serve_key(device_kind, R, k, mode, gated, rate, zipf_s)
    _store.record_raw(key, entry, path)
    return key


def service_fingerprint(service: Any) -> Tuple[str, int, int, str, bool]:
    """The (device_kind, R, k, mode, gated) slice of a live service's
    workload fingerprint — what construction-time lookup and the sweep
    tool both key on."""
    config = service.config
    mode = (
        "weighted"
        if config.weighted
        else "distinct" if config.distinct else "plain"
    )
    return (
        device_kind_of(service.device),
        int(config.num_reservoirs),
        int(config.max_sample_size),
        mode,
        bool(getattr(service.bridge, "gate_active", False)),
    )


# ------------------------------------------------------------ online control


@dataclass
class TuneDecision:
    """One controller step, journaled: what the plane said, what the
    controller did, and the knob vector it left behind."""

    at: float
    verdict: str
    action: str  # "backoff" | "probe" | "hold"
    knobs: ServiceKnobs
    healthy_streak: int


class ServiceTuner:
    """SLO-closed-loop knob controller (AIMD with hysteresis).

    Attach one per service: ``ServiceTuner(service, plane)`` registers
    itself via :meth:`ReservoirService.attach_tuner`, after which the
    ingest hot path calls :meth:`maybe_observe` — one ``None`` test plus
    a clock read per accepted ingest, a full evaluation at most every
    ``interval_s``.  The control law:

    - **warn/page burn** → multiplicative backoff: every active knob
      moves toward its :data:`SAFE_END` by ``backoff_factor`` (halving /
      doubling at the default 0.5), clamped into ``bounds``.  The healthy
      streak resets — one bad window is enough to retreat.
    - **ok** for ``healthy_dwell`` consecutive evaluations →
      additive re-probe: every knob steps a ``probe_step`` fraction of
      its remaining distance back toward ``optimum`` (the cached sweep
      winner, or the knobs at attach time).  Hysteresis: backoff is
      immediate and large, recovery is dwelled and small, so an
      oscillating signal parks the knobs near the safe end instead of
      thrashing.

    Knobs that are inert for this service (sweep cadence without a TTL,
    gate push chunk on an ungated bridge) are never touched.  Decisions
    land in :attr:`decisions` (bounded), the ``tune.decide`` event/span,
    and ``tune.*`` gauges — all zero-overhead while telemetry is off.
    """

    def __init__(
        self,
        service: Any,
        plane: Any,
        *,
        optimum: Optional[ServiceKnobs] = None,
        bounds: Optional[KnobBounds] = None,
        backoff_factor: float = 0.5,
        probe_step: float = 0.25,
        healthy_dwell: int = 2,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        max_decisions: int = 256,
        attach: bool = True,
    ) -> None:
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError("backoff_factor must be in (0, 1)")
        if not 0.0 < probe_step <= 1.0:
            raise ValueError("probe_step must be in (0, 1]")
        if healthy_dwell < 1:
            raise ValueError("healthy_dwell must be >= 1")
        self._service = service
        self._plane = plane
        self._bounds = bounds if bounds is not None else DEFAULT_BOUNDS
        self._backoff = float(backoff_factor)
        self._probe = float(probe_step)
        self._dwell = int(healthy_dwell)
        self._interval_s = float(interval_s)
        self._clock = clock
        live = ServiceKnobs(*service.live_knobs())
        self._optimum = (
            ServiceKnobs(*optimum) if optimum is not None else live
        )
        # inert knobs stay untouched: no TTL = no sweep cadence to tune,
        # ungated bridge = the push chunk never slices anything
        active = ["coalesce_bytes", "max_inflight_bytes", "checkpoint_every"]
        if service.table.ttl_s is not None and (
            live.sweep_interval_s > 0 or self._optimum.sweep_interval_s > 0
        ):
            active.append("sweep_interval_s")
        if getattr(service.bridge, "gate_active", False):
            active.append("gate_push_chunk")
        self._active = tuple(active)
        self._healthy_streak = 0
        self._last_eval = -math.inf
        self.decisions: Deque[TuneDecision] = deque(maxlen=max_decisions)
        self.backoffs = 0
        self.probes = 0
        if attach:
            service.attach_tuner(self)

    # ------------------------------------------------------------- observe

    @property
    def optimum(self) -> ServiceKnobs:
        return self._optimum

    def maybe_observe(
        self, now: Optional[float] = None
    ) -> Optional[TuneDecision]:
        """Rate-limited hot-path hook: a full :meth:`observe` at most
        every ``interval_s``, else nothing (one clock read)."""
        now = self._clock() if now is None else now
        if now - self._last_eval < self._interval_s:
            return None
        return self.observe(now)

    def observe(self, now: Optional[float] = None) -> TuneDecision:
        """Evaluate the SLO plane and take one control step; returns the
        journaled decision."""
        now = self._clock() if now is None else now
        self._last_eval = now
        tr = _trace.get()
        if tr is not None:
            with tr.span("tune.decide"):
                return self._decide(now)
        return self._decide(now)

    def _decide(self, now: float) -> TuneDecision:
        self._plane.evaluate(now)
        verdict = self._plane.worst()
        live = ServiceKnobs(*self._service.live_knobs())
        if verdict in ("warn", "page"):
            self._healthy_streak = 0
            target = self._backoff_from(live)
            action = "backoff" if target != live else "hold"
        else:
            self._healthy_streak += 1
            if self._healthy_streak >= self._dwell:
                target = self._probe_from(live)
                action = "probe" if target != live else "hold"
            else:
                target, action = live, "hold"
        if action != "hold":
            self._service.apply_knobs(target)
            if action == "backoff":
                self.backoffs += 1
            else:
                self.probes += 1
        decision = TuneDecision(
            at=now,
            verdict=verdict,
            action=action,
            knobs=target,
            healthy_streak=self._healthy_streak,
        )
        self.decisions.append(decision)
        self._instrument(decision)
        return decision

    # ------------------------------------------------------------ control law

    def _backoff_from(self, live: ServiceKnobs) -> ServiceKnobs:
        """Multiplicative retreat: every active knob toward its safe end
        by ``backoff_factor``, clamped into bounds."""
        out = live._asdict()
        for name in self._active:
            cur = out[name]
            if name == "gate_push_chunk" and cur == 0:
                continue  # bridge-resolved: nothing concrete to halve yet
            if SAFE_END[name] == "lo":
                nxt = cur * self._backoff
            else:
                nxt = cur / self._backoff
            nxt = self._bounds.clamp(name, nxt)
            out[name] = type(cur)(nxt) if isinstance(cur, int) else float(nxt)
        knobs = ServiceKnobs(**out)
        # the pair constraint survives every nudge
        if knobs.coalesce_bytes > knobs.max_inflight_bytes:
            out["coalesce_bytes"] = out["max_inflight_bytes"]
            knobs = ServiceKnobs(**out)
        return knobs

    def _probe_from(self, live: ServiceKnobs) -> ServiceKnobs:
        """Additive recovery: every active knob a ``probe_step`` fraction
        of its remaining distance toward the optimum (at least one unit,
        never overshooting)."""
        out = live._asdict()
        opt = self._optimum._asdict()
        for name in self._active:
            cur, goal = out[name], opt[name]
            if cur == goal:
                continue
            if isinstance(cur, int):
                step = max(1, int(round(abs(goal - cur) * self._probe)))
                nxt = cur + step if goal > cur else cur - step
                nxt = min(nxt, goal) if goal > cur else max(nxt, goal)
            else:
                nxt = cur + (goal - cur) * self._probe
                if abs(goal - nxt) < 1e-9:
                    nxt = goal
            out[name] = self._bounds.clamp(name, nxt) if nxt != goal else goal
        knobs = ServiceKnobs(**out)
        if knobs.coalesce_bytes > knobs.max_inflight_bytes:
            out["coalesce_bytes"] = out["max_inflight_bytes"]
            knobs = ServiceKnobs(**out)
        return knobs

    # ------------------------------------------------------------- telemetry

    def _instrument(self, decision: TuneDecision) -> None:
        """Structured journal + gauges for one decision — one global load
        and a ``None`` test when telemetry is disabled."""
        reg = _obs.get()
        if reg is not None:
            for name, value in decision.knobs._asdict().items():
                reg.gauge(f"tune.{name}").set(float(value))
            reg.gauge("tune.healthy_streak").set(
                float(decision.healthy_streak)
            )
            if decision.action == "backoff":
                reg.counter("tune.backoffs").inc()
            elif decision.action == "probe":
                reg.counter("tune.probes").inc()
        _obs.emit(
            "tune.decide",
            site="serve.tune",
            verdict=decision.verdict,
            action=decision.action,
            **{
                f"knob_{k}": v
                for k, v in decision.knobs._asdict().items()
            },
        )
