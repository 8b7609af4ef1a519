"""One shard: one independent failure domain of the serving plane (the
port's copy of the JAX package's ``serve/shard.py``).

Each shard is its own availability stack, with nothing shared: its own
engine and bridge, its own checkpoint and journal directory, its own epoch
fence, its own :class:`~reservoir_tpu_torch.serve.ha.HeartbeatWriter`
beacon, and (optionally) its own hot
:class:`~reservoir_tpu_torch.serve.replica.StandbyReplica` under a
shard-scoped :class:`~reservoir_tpu_torch.serve.ha.FailoverController`.  A
wedged flush pipeline or a lost fence on shard 3 is shard 3's outage.

:class:`ShardUnit` is that bundle, so a single-shard deployment and an
N-shard :class:`~reservoir_tpu_torch.serve.cluster.ShardedReservoirService`
are the same code: the cluster is N units plus routing.  The unit owns the
levers a chaos soak (and an operator) pulls:

- :meth:`~ShardUnit.kill`: simulate a primary crash (no shutdown, no
  flush; the zombie is kept, its flushes in flight, for fence probes);
- :meth:`~ShardUnit.promote`: epoch-fenced standby promotion (fires the
  ``shard.promote`` fault site; an injected failure leaves the standby
  un-promoted and re-promotable), then a fresh standby and controller
  tailing the new primary;
- :meth:`~ShardUnit.recover`: stop-the-world
  :meth:`ReservoirService.recover` from the shard's own directory (the
  path without a standby); a lineage fenced by a promotion fails typed,
  before replay;
- :meth:`~ShardUnit.beat` / :meth:`~ShardUnit.health` /
  :meth:`~ShardUnit.maybe_promote`: the per-shard heartbeat and health
  loop, its verdicts carrying trigger tags.

The unit's service records its ``serve.*`` instruments under
``@shard<i>`` labels (:func:`~reservoir_tpu_torch.obs.registry.scoped`),
and :meth:`~ShardUnit.slo_verdicts` judges them with a per-shard
:class:`~reservoir_tpu_torch.obs.slo.SLOPlane` (``attach=False``: N planes
must not fight over the registry's one export slot), so one saturated
shard pages alone.

The primary, its standby and every later promoted or recovered primary
live on the unit's ``device`` (``None`` means the card and raises without
one; ``"cpu"`` runs the plain versions).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

from ..config import SamplerConfig
from ..errors import RetryPolicy
from ..obs import flight as _flight
from ..obs import registry as _obs
from ..obs import trace as _ctrace
from ..utils import faults as _faults
from ..utils.checkpoint import advance_epoch, read_epoch
from .ha import FailoverController, HealthReport, HeartbeatWriter
from .replica import StandbyReplica
from .service import ReservoirService

__all__ = ["ShardUnit"]


class ShardUnit:
    """One shard's primary + beacon + (optional) hot standby, as a unit.

    Args:
      config: the shard's engine config (``num_reservoirs`` = this
        shard's session capacity; the cluster's total capacity is
        ``n_shards * num_reservoirs``).
      shard_id: this shard's index (names its obs scope and directory).
      checkpoint_dir: this shard's OWN durability directory — never
        shared with another shard; the whole failure-domain story rests
        on that.
      key: engine PRNG seed for this shard (the cluster derives one per
        shard; kept on :attr:`engine_seed` for oracle replays).
      standby: keep a hot :class:`StandbyReplica` tailing the journal
        (with a :class:`FailoverController` over the heartbeat).
        ``False`` = recover-in-place only.
      heartbeat_timeout_s / max_watchdog_trips / max_demotions /
        max_rejections: forwarded to the shard's controller.
      clock: controller/heartbeat time source (injectable for tests).
      obs_scope: instrument label (default ``shard<i>``).
      slo_kwargs: overrides for this shard's
        :func:`~reservoir_tpu_torch.obs.slo.default_slos` objectives (e.g.
        ``{"staleness_s": 30.0}``) — thresholds are deployment knobs, the
        scoping is not.
      faults: fault plane for this unit's sites (``shard.promote`` fires
        here; the cluster fires ``shard.route``).
      device: this shard's torch device, passed to its service and its
        standby and again on :meth:`recover`; ``None`` means the card and
        raises without one, ``"cpu"`` runs the plain versions.
      **service_kwargs: forwarded to :class:`ReservoirService`
        (``ttl_s``, ``coalesce_bytes``, ``gated``, ``durability``, ...).
    """

    def __init__(
        self,
        config: SamplerConfig,
        shard_id: int,
        checkpoint_dir: str,
        *,
        key: Any = None,
        standby: bool = True,
        heartbeat_timeout_s: float = 5.0,
        max_watchdog_trips: int = 0,
        max_demotions: Optional[int] = None,
        max_rejections: Optional[int] = None,
        clock=time.time,
        obs_scope: Optional[str] = None,
        slo_kwargs: Optional[dict] = None,
        faults: Optional[Any] = None,
        retry_policy: Optional[RetryPolicy] = None,
        device: Optional[Any] = None,
        _service: Optional[ReservoirService] = None,
        **service_kwargs: Any,
    ) -> None:
        self.shard_id = int(shard_id)
        self.checkpoint_dir = checkpoint_dir
        self.engine_seed = key
        self.device = device
        self._config = config
        self._standby_enabled = bool(standby)
        self._clock = clock
        self._faults = faults
        self._obs_scope = (
            obs_scope if obs_scope is not None else f"shard{self.shard_id}"
        )
        self._slo_kwargs = dict(slo_kwargs or {})
        self._ctl_kwargs = dict(
            heartbeat_timeout_s=heartbeat_timeout_s,
            max_watchdog_trips=max_watchdog_trips,
            max_demotions=max_demotions,
            max_rejections=max_rejections,
        )
        self._service_kwargs = dict(service_kwargs)
        self._service_kwargs.setdefault("retry_policy", retry_policy)
        self._service_kwargs["device"] = device
        if _service is not None:
            # adoption path (cluster recover): the service was rebuilt by
            # ReservoirService.recover and already owns the directory
            self._service: Optional[ReservoirService] = _service
            _service._obs_scope = self._obs_scope
        else:
            os.makedirs(checkpoint_dir, exist_ok=True)
            self._service = ReservoirService(
                config,
                key=key,
                checkpoint_dir=checkpoint_dir,
                obs_scope=self._obs_scope,
                faults=faults,
                **self._service_kwargs,
            )
        self.last_zombie: Optional[ReservoirService] = None
        self._unavailable_reason: Optional[str] = None
        self._slo_plane = None
        self._hb: Optional[HeartbeatWriter] = None
        self._standby: Optional[StandbyReplica] = None
        self._controller: Optional[FailoverController] = None
        self._arm()

    # ------------------------------------------------------------ properties

    @property
    def alive(self) -> bool:
        """Whether this shard has a live primary (killed/fenced = False)."""
        return self._service is not None

    @property
    def unavailable_reason(self) -> Optional[str]:
        """Why the shard is down (``killed`` / ``fenced``), None while up."""
        return self._unavailable_reason

    @property
    def service(self) -> ReservoirService:
        if self._service is None:
            raise RuntimeError(
                f"shard {self.shard_id} has no live primary "
                f"({self._unavailable_reason}); promote() or recover() first"
            )
        return self._service

    @property
    def table(self):
        return self.service.table

    @property
    def standby(self) -> Optional[StandbyReplica]:
        return self._standby

    @property
    def controller(self) -> Optional[FailoverController]:
        return self._controller

    @property
    def obs_scope(self) -> str:
        return self._obs_scope

    @property
    def epoch(self) -> int:
        """The persisted fence epoch of this shard's directory."""
        return read_epoch(self.checkpoint_dir)

    # --------------------------------------------------------------- arming

    def _arm(self) -> None:
        """(Re-)attach the beacon and, when enabled, a fresh standby +
        controller tailing the CURRENT primary.  Called at construction
        and after every promote/recover — the old standby's service
        identity is stale either way."""
        if self._service is None:
            return
        self._hb = HeartbeatWriter(
            self.checkpoint_dir,
            service=self._service,
            clock=self._clock,
            faults=self._faults,
        )
        if self._standby_enabled:
            self._standby = StandbyReplica(
                self.checkpoint_dir, faults=self._faults, device=self.device
            )
            self._controller = FailoverController(
                self._standby,
                clock=self._clock,
                faults=self._faults,
                **self._ctl_kwargs,
            )

    # -------------------------------------------------------------- levers

    def kill(self) -> ReservoirService:
        """Simulate a primary crash: drop the service with NO shutdown or
        flush (pending coalesced elements die with it, exactly the crash
        contract).  The zombie is kept on :attr:`last_zombie` so chaos
        tests can probe the fence; the standby (if any) keeps tailing the
        journal and is ready to promote."""
        zombie = self.service
        self.last_zombie = zombie
        self._service = None
        self._hb = None
        self._unavailable_reason = "killed"
        _obs.emit(
            "shard.killed", site="shard.promote", shard=self.shard_id
        )
        tr = _ctrace.get()
        if tr is not None:
            tr.point(
                "shard.killed",
                shard=self.shard_id,
                flush_seq=zombie.flushed_seq,
            )
        return zombie

    def fence(self) -> int:
        """Advance the shard's persisted epoch WITHOUT promoting — the
        split-brain chaos lever: the current primary's next durable write
        fails with :class:`~reservoir_tpu_torch.errors.FencedError`."""
        return advance_epoch(self.checkpoint_dir)

    def mark_fenced(self) -> None:
        """Record that the primary hit its fence (the cluster calls this
        when a delegated call raises ``FencedError``): the shard rejects
        with ``retry_after`` until promoted/recovered."""
        if self._service is not None:
            self.last_zombie = self._service
        self._service = None
        self._hb = None
        self._unavailable_reason = "fenced"

    def promote(
        self, reason: str = "manual", triggers: Optional[list] = None
    ) -> ReservoirService:
        """Epoch-fenced failover onto this shard's hot standby; the
        ``shard.promote`` fault site fires first, so an injected failure
        leaves the standby un-promoted (and this method re-callable).
        Re-arms a fresh beacon + standby + controller on success."""
        if self._standby is None:
            raise RuntimeError(
                f"shard {self.shard_id} has no standby to promote"
            )
        _faults.fire("shard.promote", self._faults)
        if self._service is not None:
            # promoting over a live primary: it becomes the fenced zombie
            self.last_zombie = self._service
        assert self._controller is not None
        tr = _ctrace.get()
        if tr is None:
            promoted = self._controller.promote(
                reason=reason, triggers=triggers
            )
        else:
            with tr.span(
                "shard.promote",
                force=True,
                shard=self.shard_id,
                reason=reason,
            ) as span:
                promoted = self._controller.promote(
                    reason=reason, triggers=triggers
                )
                if span is not None:
                    span.fields["flush_seq"] = promoted.flushed_seq
                    span.fields["epoch"] = self.epoch
        promoted._obs_scope = self._obs_scope
        self._service = promoted
        self._unavailable_reason = None
        self._arm()
        return promoted

    def recover(self, **kwargs: Any) -> ReservoirService:
        """Stop-the-world rebuild from this shard's own directory
        (:meth:`ReservoirService.recover`), with its pre-flight: a lineage
        fenced by a promotion raises
        :class:`~reservoir_tpu_torch.errors.CheckpointMismatch` before
        replay.
        Re-arms the beacon/standby on success."""
        fwd = {
            k: self._service_kwargs[k]
            for k in (
                "ttl_s", "coalesce_bytes", "max_inflight_bytes",
                "retry_after_s", "sweep_interval_s", "auditor",
                "retry_policy", "flush_timeout_s", "checkpoint_every",
                "durability", "pipelined", "device",
            )
            if k in self._service_kwargs
        }
        fwd.update(kwargs)
        tr = _ctrace.get()
        cm = (
            tr.span("shard.recover", force=True, shard=self.shard_id)
            if tr is not None
            else contextlib.nullcontext()
        )
        with cm as span:
            service = ReservoirService.recover(
                self.checkpoint_dir,
                obs_scope=self._obs_scope,
                faults=self._faults,
                **fwd,
            )
            if span is not None:
                span.fields["flush_seq"] = service.flushed_seq
                span.fields["epoch"] = self.epoch
        fl = _flight.get()
        if fl is not None:
            fl.note(
                "shard.recovered",
                shard=self.shard_id,
                flush_seq=service.flushed_seq,
                epoch=self.epoch,
            )
        self._service = service
        self._unavailable_reason = None
        self._arm()
        return service

    # ------------------------------------------------------- health plane

    def beat(self) -> Optional[dict]:
        """One heartbeat of the live primary (None while the shard is
        down — a dead shard must look dead, not quietly skipped)."""
        if self._hb is None:
            return None
        return self._hb.beat()

    def poll(self) -> int:
        """One standby replication step (0 when no standby)."""
        if self._standby is None:
            return 0
        return self._standby.poll()

    def health(self) -> Optional[HealthReport]:
        """The shard controller's verdict (None when no standby)."""
        if self._controller is None:
            return None
        return self._controller.health()

    def maybe_promote(self) -> Optional[ReservoirService]:
        """Controller-driven failover: promote iff the shard-scoped health
        verdict says so; returns the promoted service or None."""
        report = self.health()
        if report is None or not report.should_promote:
            return None
        return self.promote(
            reason="; ".join(report.reasons) or "unhealthy",
            triggers=report.triggers,
        )

    def slo_verdicts(self) -> Dict[str, str]:
        """This shard's burn-rate verdicts over its scoped instruments
        (empty while telemetry is disabled).  The plane is created lazily
        on the first call with a live registry, detached
        (``attach=False``)."""
        if _obs.get() is None:
            return {}
        if self._slo_plane is None:
            from ..obs.slo import SLOPlane, default_slos

            self._slo_plane = SLOPlane(
                default_slos(scope=self._obs_scope, **self._slo_kwargs),
                attach=False,
            )
        return {
            name: v.verdict
            for name, v in self._slo_plane.evaluate().items()
        }

    def status(self) -> dict:
        """One JSON-able row for the cluster heartbeat / status panel."""
        row: dict = {
            "alive": self.alive,
            "epoch": self.epoch,
            "reason": self._unavailable_reason,
        }
        if self._service is not None:
            row.update(
                seq=self._service.flushed_seq,
                sessions_open=len(self._service.table),
                watchdog_trips=self._service.bridge.metrics.watchdog_trips,
                demotions=self._service.bridge.metrics.demotions,
                rejections=self._service.metrics.rejections,
            )
        if self._standby is not None:
            row["standby_applied_seq"] = self._standby.applied_seq
            row["standby_lag_seq"] = self._standby.metrics.lag_seq
        verdicts = self.slo_verdicts()
        if verdicts:
            row["slo_worst"] = max(
                verdicts.values(),
                key=lambda v: {"ok": 0, "warn": 1, "page": 2}[v],
            )
            row["slo"] = verdicts
        return row

    def shutdown(self) -> None:
        if self._service is not None:
            self._service.shutdown()
