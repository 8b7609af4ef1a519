"""Failover control: heartbeats, health verdicts, epoch-fenced promotion
(the port's copy of the JAX package's ``serve/ha.py``; ``heartbeat.json``
has the same fields and format).

Replication lives in :mod:`reservoir_tpu_torch.serve.replica`; this module
decides when to use it and makes using it safe:

- :class:`HeartbeatWriter`: the primary's liveness beacon, an atomic
  ``heartbeat.json`` in the checkpoint dir carrying a timestamp, the
  writer's epoch, the durable flush watermark, and the health signals the
  stack emits (``BridgeMetrics.watchdog_trips``/``demotions``/``failures``,
  ``ServiceMetrics.rejections``).  A fenced writer (a newer persisted
  epoch) refuses to beat, so a zombie primary cannot keep claiming
  liveness.
- :class:`FailoverController`: the standby side's health model over those
  signals: heartbeat staleness (a crash or hang), watchdog trips (a wedged
  flush pipeline, which ``recover()`` cannot ride out in place), and
  optional demotion and rejection thresholds.
  :meth:`FailoverController.maybe_promote` turns an unhealthy verdict into
  :meth:`StandbyReplica.promote`, which bumps the **epoch** persisted next
  to the checkpoint (fsynced, atomic): every journaling writer checks it
  before each flush and checkpoint, so the old primary fails its next
  durable write with a typed
  :class:`~reservoir_tpu_torch.errors.FencedError` instead of serving rows
  the promoted primary now owns.

Fault plane: the ``ha.heartbeat`` site fires on every beat and every
controller read.  A failing writer lets the file go stale (the controller
then promotes); a failing read counts as a missing heartbeat (stale after
the timeout).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, List, Optional, Tuple

from ..errors import FencedError
from ..obs import flight as _flight
from ..obs import registry as _obs
from ..obs import trace as _ctrace
from ..obs.export import json_snapshot, write_json_atomic
from ..utils import faults as _faults
from ..utils.checkpoint import read_epoch
from ..utils.metrics import HAMetrics

__all__ = [
    "HeartbeatWriter",
    "read_heartbeat",
    "HealthReport",
    "FailoverController",
]

_HEARTBEAT_NAME = "heartbeat.json"


def read_heartbeat(checkpoint_dir: str) -> Optional[dict]:
    """The last heartbeat payload, or ``None`` when missing/unreadable (a
    torn/corrupt heartbeat is indistinguishable from a dead primary, and
    is treated exactly that way: stale)."""
    try:
        with open(
            os.path.join(checkpoint_dir, _HEARTBEAT_NAME), encoding="utf-8"
        ) as fh:
            return json.load(fh)
    except (FileNotFoundError, OSError, json.JSONDecodeError, ValueError):
        return None


class HeartbeatWriter:
    """The primary's liveness beacon.

    Call :meth:`beat` on a cadence (each sync, a timer thread, the ingest
    loop — anything faster than the controller's
    ``heartbeat_timeout_s``).  Each beat is an atomic temp-file + rename
    (readers never see a torn payload) and carries the signals the
    controller's health model consumes.  A writer admitted at epoch E
    refuses to beat once the persisted epoch exceeds E
    (:class:`FencedError`, counted in ``metrics.fenced_writes``) — a
    fenced zombie must look dead, not alive.
    """

    def __init__(
        self,
        checkpoint_dir: str,
        service: Optional[Any] = None,
        bridge: Optional[Any] = None,
        *,
        clock=time.time,
        faults: Optional[Any] = None,
        metrics: Optional[HAMetrics] = None,
    ) -> None:
        self._dir = checkpoint_dir
        self._svc = service
        self._bridge = bridge if bridge is not None else (
            service.bridge if service is not None else None
        )
        self._clock = clock
        self._faults = faults
        self._metrics = metrics if metrics is not None else HAMetrics()
        self._epoch = read_epoch(checkpoint_dir)

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def metrics(self) -> HAMetrics:
        return self._metrics

    def beat(self) -> dict:
        """Write one heartbeat; returns the payload written."""
        _faults.fire("ha.heartbeat", self._faults)
        current = read_epoch(self._dir)
        if current > self._epoch:
            self._metrics.fenced_writes += 1
            _obs.emit(
                "ha.fenced",
                site="ha.heartbeat",
                epoch=current,
                own_epoch=self._epoch,
            )
            tr = _ctrace.get()
            if tr is not None:
                tr.point(
                    "ha.fenced", epoch=current, own_epoch=self._epoch
                )
            fl = _flight.get()
            if fl is not None:
                fl.trigger(
                    "fenced",
                    epoch=current,
                    own_epoch=self._epoch,
                    checkpoint_dir=self._dir,
                )
            raise FencedError(
                f"heartbeat fenced: {self._dir!r} is at primary epoch "
                f"{current}, this writer was admitted at {self._epoch}",
                observed_epoch=current,
                own_epoch=self._epoch,
            )
        payload: dict = {"ts": float(self._clock()), "epoch": self._epoch}
        if self._bridge is not None:
            m = self._bridge.metrics
            payload.update(
                seq=int(self._bridge.flushed_seq),
                watchdog_trips=m.watchdog_trips,
                demotions=m.demotions,
                failures=m.failures,
            )
        if self._svc is not None:
            payload["rejections"] = self._svc.metrics.rejections
            payload["sessions_open"] = self._svc.metrics.sessions_open
        reg = _obs.get()
        if reg is not None:
            # the beat carries the JSON exporter's snapshot: one schema,
            # wherever the numbers surface
            payload["telemetry"] = json_snapshot(reg)
            slo = payload["telemetry"].get("slo")
            if isinstance(slo, dict) and slo.get("verdicts"):
                # the worst burn-rate verdict rides the beat's top level:
                # the standby side's controller reads health from the
                # heartbeat alone, and an SLO page is a health signal
                payload["slo_worst"] = slo.get("worst", "ok")
        write_json_atomic(os.path.join(self._dir, _HEARTBEAT_NAME), payload, suffix=".tmp.hb")
        self._metrics.heartbeats += 1
        return payload


@dataclasses.dataclass
class HealthReport:
    """One controller verdict.  ``should_promote`` is the actionable bit;
    ``reasons`` name every signal that contributed (promote-worthy ones
    first), ``heartbeat_age_s`` the observed staleness (``None`` before
    the first check can age anything).

    ``triggers`` is the machine-readable companion of ``reasons``: one
    stable tag per contributing signal, in the same order (``staleness`` /
    ``watchdog`` / ``demotions`` / ``rejections`` for the promote-worthy
    ones, then ``slo_worst`` and the degraded-only ``demotions`` /
    ``rejections`` / ``heartbeat_read``), so a chaos soak or a promotion
    audit names its trigger without parsing the human strings."""

    healthy: bool
    should_promote: bool
    reasons: List[str]
    heartbeat_age_s: Optional[float]
    heartbeat: Optional[dict]
    triggers: List[str] = dataclasses.field(default_factory=list)


class FailoverController:
    """Standby-side failover decision over the primary's emitted signals.

    Args:
      standby: the :class:`~reservoir_tpu_torch.serve.replica.StandbyReplica`
        to promote (shares its :class:`HAMetrics`).
      heartbeat_timeout_s: staleness past which the primary is presumed
        dead/hung.  A missing heartbeat ages from this controller's first
        health check (a primary that never once beat is equally dead).
      max_watchdog_trips: heartbeat-reported ``watchdog_trips`` above this
        promote (default 0: one tripped flush watchdog means the primary's
        pipeline is wedged inside the runtime — the failure mode in-place
        recovery cannot fix).
      max_demotions / max_rejections: optional promote thresholds for the
        degraded-but-alive signals (kernel demotions, which a port primary
        never reports, and admission-control rejections).  ``None`` (default) records them as degraded
        health without promoting — a slow primary is still a primary.
      clock: time source matching the writer's (``time.time`` default).
    """

    def __init__(
        self,
        standby: Any,
        *,
        heartbeat_timeout_s: float = 5.0,
        max_watchdog_trips: int = 0,
        max_demotions: Optional[int] = None,
        max_rejections: Optional[int] = None,
        clock=time.time,
        faults: Optional[Any] = None,
    ) -> None:
        self._standby = standby
        self._dir = standby.checkpoint_dir
        self._timeout = float(heartbeat_timeout_s)
        self._max_watchdog = int(max_watchdog_trips)
        self._max_demotions = max_demotions
        self._max_rejections = max_rejections
        self._clock = clock
        self._faults = faults
        self._metrics = standby.metrics
        self._first_check_t: Optional[float] = None
        self._was_healthy = True
        self.last_promotion_reason: Optional[str] = None
        self.last_promotion_triggers: List[str] = []

    @property
    def metrics(self) -> HAMetrics:
        return self._metrics

    def health(self) -> HealthReport:
        """Evaluate the primary's health from its emitted signals.  Every
        reason string is paired with a stable trigger tag
        (:attr:`HealthReport.triggers`), promote-worthy signals first."""
        now = self._clock()
        if self._first_check_t is None:
            self._first_check_t = now
        promote: List[Tuple[str, str]] = []  # (trigger, reason)
        degraded: List[Tuple[str, str]] = []
        hb: Optional[dict] = None
        try:
            _faults.fire("ha.heartbeat", self._faults)
            hb = read_heartbeat(self._dir)
        except Exception as e:
            degraded.append((
                "heartbeat_read",
                f"heartbeat read failed ({type(e).__name__}: {e})",
            ))
        if hb is None:
            age = now - self._first_check_t
            if age > self._timeout:
                promote.append((
                    "staleness",
                    f"no heartbeat for {age:.1f}s "
                    f"(timeout {self._timeout:g}s)",
                ))
        else:
            age = now - float(hb.get("ts", 0.0))
            if age > self._timeout:
                promote.append((
                    "staleness",
                    f"heartbeat stale ({age:.1f}s > {self._timeout:g}s)",
                ))
            trips = int(hb.get("watchdog_trips", 0))
            if trips > self._max_watchdog:
                promote.append((
                    "watchdog",
                    f"flush watchdog tripped {trips}x (pipeline wedged)",
                ))
            demotions = int(hb.get("demotions", 0))
            if self._max_demotions is not None and (
                demotions > self._max_demotions
            ):
                promote.append(
                    ("demotions", f"{demotions} Pallas->XLA demotions")
                )
            elif demotions:
                degraded.append(
                    ("demotions", f"degraded: {demotions} demotions")
                )
            rejections = int(hb.get("rejections", 0))
            if self._max_rejections is not None and (
                rejections > self._max_rejections
            ):
                promote.append((
                    "rejections",
                    f"{rejections} admission rejections (saturated)",
                ))
            elif rejections:
                degraded.append(
                    ("rejections", f"degraded: {rejections} rejections")
                )
            worst = hb.get("slo_worst")
            if worst in ("warn", "page"):
                # burn-rate verdicts are health signals, never promote
                # triggers on their own: a slow-but-alive primary
                # is still a primary (same posture as demotions), and a
                # failover would not fix a biased sampler anyway
                degraded.append(("slo_worst", f"degraded: SLO {worst}"))
        signals = promote + degraded
        report = HealthReport(
            healthy=not signals,
            should_promote=bool(promote),
            reasons=[r for _, r in signals],
            heartbeat_age_s=age,
            heartbeat=hb,
            triggers=[t for t, _ in signals],
        )
        was_healthy, self._was_healthy = self._was_healthy, report.healthy
        if was_healthy and not report.healthy and not report.should_promote:
            # healthy -> degraded transition (promote-worthy verdicts dump
            # from promote() itself): capture the flight ring while the
            # degradation is fresh, rate-limited per reason
            fl = _flight.get()
            if fl is not None:
                fl.trigger(
                    "degraded",
                    triggers=",".join(report.triggers),
                    checkpoint_dir=self._dir,
                )
        return report

    def maybe_promote(self) -> Optional[Any]:
        """One control-loop step: promote iff the health verdict says so.
        Returns the promoted service, or ``None`` (primary healthy/only
        degraded)."""
        report = self.health()
        if not report.should_promote:
            return None
        return self.promote(
            reason="; ".join(report.reasons) or "unhealthy",
            triggers=report.triggers,
        )

    def promote(
        self, reason: str = "manual", triggers: Optional[List[str]] = None
    ) -> Any:
        """Force the failover (epoch fence + tail drain + flip); returns
        the promoted service.  ``promotions`` counts on the shared
        metrics (inside ``StandbyReplica.promote``).  The promotion event
        record (``ha.promote_decision``) names the trigger tags beside the
        human reason, so a chaos soak can say which signal pulled the
        trigger."""
        tr = _ctrace.get()
        cm = (
            tr.span("ha.promote", force=True, reason=reason)
            if tr is not None
            else contextlib.nullcontext()
        )
        with cm as span:
            service = self._standby.promote()
            if span is not None:
                span.fields["epoch"] = getattr(service, "epoch", None)
        self.last_promotion_reason = reason
        self.last_promotion_triggers = list(triggers or [])
        _obs.emit(
            "ha.promote_decision",
            site="ha.promote",
            reason=reason,
            triggers=",".join(self.last_promotion_triggers) or "manual",
        )
        fl = _flight.get()
        if fl is not None:
            fl.trigger(
                "promotion",
                promote_reason=reason,
                triggers=",".join(self.last_promotion_triggers) or "manual",
                checkpoint_dir=self._dir,
            )
        return service
