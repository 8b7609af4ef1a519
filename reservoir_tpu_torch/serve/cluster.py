"""The sharded serving plane: N independent shard units behind one front
end (the port's copy of the JAX package's ``serve/cluster.py``).

:class:`ShardedReservoirService` fronts N independent
:class:`~reservoir_tpu_torch.serve.shard.ShardUnit` failure domains (engine,
bridge, journal and checkpoint directory, epoch fence and optional hot
standby each), so one wedged or fenced shard degrades ``1/N`` of the key
space while every other shard keeps serving.

- **Deterministic routing**: ``shard_of(key) = crc32(routing_epoch:key) %
  n_shards``, a stable hash with a pinned routing epoch.  The header of
  ``routing.jsonl`` journals ``(n_shards, routing_epoch, key)`` and every
  open appends a ``route`` record, so :meth:`~ShardedReservoirService.recover`
  re-routes identically (each replayed record is checked against the hash;
  a torn tail, a crash mid-append, is dropped).
- **Per-shard admission and partial degradation**: a saturated shard's
  :class:`~reservoir_tpu_torch.errors.ServiceSaturated` rejects its own
  sessions only; a fenced or killed shard rejects with
  :class:`~reservoir_tpu_torch.errors.ShardUnavailable` (a
  ``ServiceSaturated`` carrying ``shard`` and ``retry_after_s``), and
  nothing routed elsewhere notices.  The ``shard.route`` fault site fires
  on every resolution; a failure there surfaces as a typed per-call
  :class:`~reservoir_tpu_torch.errors.SessionIngestError`.
- **Cluster health over per-shard HA**: each unit runs the heartbeat and
  controller loop against its own directory;
  :meth:`~ShardedReservoirService.beat` gathers the shards' beats into one
  cluster ``heartbeat.json`` (per-shard epoch, seq, lag and SLO rows, and
  the worst verdict).
- **Merged snapshots across shards**:
  :meth:`~ShardedReservoirService.merged_snapshot` reads each named session
  at its shard and merges them with the exact hypergeometric pairwise merge
  in a deterministic log-depth tree over the shards' devices as ranks
  (:func:`~reservoir_tpu_torch.parallel.merge.merge_samples_device`: on the
  card the ``merge_ring_gather`` and ``algl_merge_draws`` kernels), or, when
  asked with ``device="host"``, on the CPU
  (:func:`~reservoir_tpu_torch.parallel.merge.merge_samples_host`), with
  the same result.

Placement: ``devices=None`` puts every shard on the card (they share it,
as merge ranks may), ``"spread"`` deals the visible cards round robin,
and a sequence names a torch device a shard (``"cpu"`` runs the plain
versions).  Without a card, the first two raise.

One writer, as everything below: one thread drives the cluster.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SamplerConfig
from ..errors import (
    FencedError,
    SessionIngestError,
    ShardUnavailable,
)
from ..obs import registry as _obs
from ..obs.export import write_json_atomic
from ..obs import trace as _ctrace
from ..utils import faults as _faults
from ..utils.tracing import trace_span
from .service import ReservoirService
from .shard import ShardUnit

__all__ = ["ShardedReservoirService", "shard_of"]

_ROUTING_NAME = "routing.jsonl"
_ROUTING_VERSION = 1
_HEARTBEAT_NAME = "heartbeat.json"

#: Verdict severity order shared with the SLO plane.
_SEVERITY = {"ok": 0, "warn": 1, "page": 2}


def shard_of(key: str, n_shards: int, routing_epoch: int = 0) -> int:
    """The deterministic session-to-shard route: a stable 32-bit hash of
    ``routing_epoch:key`` mod ``n_shards``.  A pure function, so recovery,
    standbys and external routers agree by construction; bumping
    ``routing_epoch`` re-deals the whole key space."""
    h = zlib.crc32(f"{routing_epoch}:{key}".encode("utf-8"))
    return h % int(n_shards)


def _resolve_devices(devices: Optional[Any], n_shards: int) -> List[Any]:
    """Normalize the cluster ``devices=`` knob into one entry per shard:
    ``None`` -> all ``None`` (the card), ``"spread"`` -> the visible cards
    round robin, a sequence -> taken as it is (its length must match: a
    silent cut would strand shards on the wrong card)."""
    if devices is None:
        return [None] * n_shards
    if isinstance(devices, str):
        if devices != "spread":
            raise ValueError(
                f"devices= accepts None, 'spread', or a sequence of "
                f"{n_shards} devices; got {devices!r}"
            )
        from ..parallel.multihost import spread_devices

        return spread_devices(n_shards)
    devs = list(devices)
    if len(devs) != n_shards:
        raise ValueError(
            f"devices= sequence has {len(devs)} entries for "
            f"{n_shards} shards"
        )
    return devs


class ShardedReservoirService:
    """N independent shard units behind one session-keyed front-end.

    The public surface mirrors :class:`ReservoirService` (open, ingest,
    snapshot, close, sync), so a traffic harness drives a cluster
    unchanged; each call routes to exactly one shard and fails (typed, with
    ``retry_after_s``) only with that shard.

    Args:
      config: PER-SHARD engine config (total capacity =
        ``n_shards * config.num_reservoirs``).
      n_shards: shard count (pinned in the routing journal).
      cluster_dir: the cluster's root directory; shard ``i`` owns
        ``<cluster_dir>/shard<i>`` and the cluster itself journals
        routing (``routing.jsonl``) and aggregates health
        (``heartbeat.json``) here.
      key: base engine seed; shard ``i`` seeds its engine with
        ``key + 7919 * i`` (distinct, deterministic, replayable — kept on
        each unit's ``engine_seed`` for oracle replays).
      routing_epoch: the pinned routing-epoch of :func:`shard_of`.
      standby: run a hot standby + failover controller per shard.
      retry_after_s: the retry hint a down shard's
        :class:`ShardUnavailable` carries.
      faults: fault plane reaching the cluster's ``shard.*`` sites and
        every unit's lower-layer sites.
      devices: per-shard placement: ``None`` (every shard on the card),
        ``"spread"`` (the visible cards round robin), or a sequence of
        ``n_shards`` torch devices (``"cpu"`` runs the plain versions).
        Shard ``i``'s engine lives on its device, so :meth:`migrate` ships
        rows from device to device, not through the host.  Without a card,
        ``None`` and ``"spread"`` raise.
      **shard_kwargs: forwarded to every :class:`ShardUnit` (and through
        it to each :class:`ReservoirService`): ``ttl_s``, ``gated``,
        ``coalesce_bytes``, ``durability``, ``heartbeat_timeout_s``, ...
    """

    def __init__(
        self,
        config: SamplerConfig,
        n_shards: int,
        cluster_dir: str,
        *,
        key: int = 0,
        routing_epoch: int = 0,
        standby: bool = True,
        retry_after_s: float = 0.05,
        faults: Optional[Any] = None,
        devices: Optional[Any] = None,
        _units: Optional[List[ShardUnit]] = None,
        **shard_kwargs: Any,
    ) -> None:
        if n_shards < 1:
            raise ValueError("n_shards must be positive")
        self._config = config
        self.n_shards = int(n_shards)
        self.cluster_dir = cluster_dir
        self.routing_epoch = int(routing_epoch)
        self._base_key = int(key)
        self._retry_after_s = float(retry_after_s)
        self._faults = faults
        #: session-key -> shard overrides left by :meth:`migrate`; consulted
        #: before the hash so migrated keys keep landing on their new home.
        self._overrides: Dict[str, int] = {}
        os.makedirs(cluster_dir, exist_ok=True)
        if _units is not None:
            self._units = _units
            self._routing_fh = open(
                os.path.join(cluster_dir, _ROUTING_NAME),
                "a",
                encoding="utf-8",
            )
        else:
            devs = _resolve_devices(devices, self.n_shards)
            self._units = [
                ShardUnit(
                    config,
                    i,
                    self.shard_dir(i),
                    key=self.shard_seed(i),
                    standby=standby,
                    faults=faults,
                    device=devs[i],
                    **shard_kwargs,
                )
                for i in range(self.n_shards)
            ]
            self._routing_fh = open(
                os.path.join(cluster_dir, _ROUTING_NAME),
                "w",
                encoding="utf-8",
            )
            self._append_routing(
                {
                    "op": "base",
                    "v": _ROUTING_VERSION,
                    "shards": self.n_shards,
                    "routing_epoch": self.routing_epoch,
                    "key": self._base_key,
                }
            )

    # ------------------------------------------------------------ structure

    def shard_dir(self, shard: int) -> str:
        return os.path.join(self.cluster_dir, f"shard{int(shard)}")

    def shard_seed(self, shard: int) -> int:
        """Shard ``i``'s engine seed: distinct per shard, derived from the
        cluster base key deterministically (oracle replays re-derive it)."""
        return self._base_key + 7919 * int(shard)

    @property
    def config(self) -> SamplerConfig:
        return self._config

    @property
    def units(self) -> List[ShardUnit]:
        return self._units

    def unit(self, shard: int) -> ShardUnit:
        return self._units[int(shard)]

    def _append_routing(self, rec: dict) -> None:
        self._routing_fh.write(json.dumps(rec) + "\n")
        self._routing_fh.flush()

    # -------------------------------------------------------------- routing

    def shard_of(self, key: str) -> int:
        """Resolve ``key``'s shard (no fault site, no journal): the
        :meth:`migrate` override if one exists, else the pinned hash."""
        ov = self._overrides.get(key)
        if ov is not None:
            return ov
        return shard_of(key, self.n_shards, self.routing_epoch)

    def _route(self, key: str) -> Tuple[ShardUnit, int]:
        """The serving-path resolution: fires the ``shard.route`` fault
        site (injected failures surface as a typed per-call
        :class:`SessionIngestError` — the cluster stays live) and turns a
        down shard into :class:`ShardUnavailable` scoped to it."""
        tr = _ctrace.get()
        cm = (
            tr.span("cluster.route", key=key, session=key)
            if tr is not None
            else contextlib.nullcontext()
        )
        with cm, trace_span("reservoir_cluster_route"):
            return self._route_impl(key, tr)

    def _route_impl(
        self, key: str, tr: Optional[Any]
    ) -> Tuple[ShardUnit, int]:
        try:
            _faults.fire("shard.route", self._faults)
        except Exception as e:
            raise SessionIngestError(
                key, f"shard routing failed: {type(e).__name__}: {e}"
            ) from e
        shard = self.shard_of(key)
        unit = self._units[shard]
        if not unit.alive:
            if tr is not None:
                # a routed-to-dead-shard reject is exactly the trace a
                # postmortem wants: force it past the sampler
                tr.point(
                    "cluster.reject",
                    session=key,
                    shard=shard,
                    error="ShardUnavailable",
                    reason=unit.unavailable_reason or "unavailable",
                )
            raise ShardUnavailable(
                f"session {key!r} routes to shard {shard}, which is "
                f"{unit.unavailable_reason or 'unavailable'}; retry after "
                "failover/recovery completes",
                retry_after_s=self._retry_after_s,
                shard=shard,
                reason=unit.unavailable_reason or "unavailable",
            )
        return unit, shard

    def _guard(self, unit: ShardUnit, shard: int, exc: FencedError):
        """A delegated call hit the shard's fence mid-flight: the primary
        is a zombie (a standby was promoted, or a chaos fence landed).
        Mark the shard down and re-raise scoped — every other shard is
        untouched."""
        unit.mark_fenced()
        tr = _ctrace.get()
        if tr is not None:
            tr.point(
                "cluster.reject",
                shard=shard,
                error="FencedError",
                reason="fenced",
                epoch=exc.observed_epoch,
            )
        raise ShardUnavailable(
            f"shard {shard} primary is fenced (epoch "
            f"{exc.observed_epoch} > {exc.own_epoch}); promote its standby "
            "or recover it",
            retry_after_s=self._retry_after_s,
            shard=shard,
            reason="fenced",
        ) from exc

    # ------------------------------------------------------------- sessions

    def open_session(self, key: str):
        """Lease ``key`` on its (deterministic) shard; the route is
        journaled so recovery re-routes identically."""
        unit, shard = self._route(key)
        try:
            sess = unit.service.open_session(key)
        except FencedError as e:
            self._guard(unit, shard, e)
        self._append_routing({"op": "route", "key": key, "shard": shard})
        _obs.emit(
            "shard.route", site="shard.route", session=key, shard=shard
        )
        return sess

    def ingest(self, key: str, elements: Any, weights: Optional[Any] = None) -> int:
        tr = _ctrace.get()
        if tr is None:
            return self._ingest_impl(key, elements, weights)
        with tr.span("cluster.ingest", key=key, session=key):
            return self._ingest_impl(key, elements, weights)

    def _ingest_impl(
        self, key: str, elements: Any, weights: Optional[Any]
    ) -> int:
        unit, shard = self._route(key)
        try:
            return unit.service.ingest(key, elements, weights)
        except FencedError as e:
            self._guard(unit, shard, e)

    def snapshot(self, key: str, sync: bool = True) -> np.ndarray:
        unit, shard = self._route(key)
        try:
            return unit.service.snapshot(key, sync=sync)
        except FencedError as e:
            self._guard(unit, shard, e)

    def close_session(self, key: str) -> np.ndarray:
        unit, shard = self._route(key)
        try:
            return unit.service.close_session(key)
        except FencedError as e:
            self._guard(unit, shard, e)

    # ------------------------------------------------------- live migration

    def migrate(self, key: str, dst_shard: int) -> Any:
        """Move ``key``'s live reservoir row to ``dst_shard`` without
        losing an element or serving a stale row.

        The move is fence-then-drain on the source (close the lease, so
        the source row's generation bumps and any straggler touch raises
        :class:`~reservoir_tpu_torch.errors.StaleSessionError`), ship the
        row's state from device to device (a ``.to`` of every exported
        tensor onto the destination service's device), then reset and
        adopt on the destination at a journaled adopt record.
        The routing override is journaled LAST — every crash window fails
        CLOSED: before the record lands, ``key`` still routes to the
        source, where the session is already closed, so a caller gets
        :class:`~reservoir_tpu_torch.errors.UnknownSessionError` (never a stale
        or double-served row; at worst one orphaned lease leaks on the
        destination until its TTL sweep).  :meth:`recover` and the
        standbys replay the same records bit-exactly.

        Returns the destination's new :class:`~.sessions.Session`.
        """
        dst_shard = int(dst_shard)
        if not 0 <= dst_shard < self.n_shards:
            raise ValueError(
                f"dst_shard {dst_shard} out of range [0, {self.n_shards})"
            )
        src_unit, src_shard = self._route(key)
        if dst_shard == src_shard:
            raise ValueError(
                f"session {key!r} already lives on shard {src_shard}"
            )
        dst_unit = self._units[dst_shard]
        if not dst_unit.alive:
            raise ShardUnavailable(
                f"migration target shard {dst_shard} is "
                f"{dst_unit.unavailable_reason or 'unavailable'}",
                retry_after_s=self._retry_after_s,
                shard=dst_shard,
                reason=dst_unit.unavailable_reason or "unavailable",
            )
        reg = _obs.get()
        t0 = time.perf_counter()
        tr = _ctrace.get()
        cm = (
            tr.span(
                "cluster.migrate",
                force=True,
                session=key,
                src=src_shard,
                dst=dst_shard,
            )
            if tr is not None
            else contextlib.nullcontext()
        )
        with cm, trace_span("reservoir_cluster_migrate"):
            try:
                sess = src_unit.service.table.route(key)
                elements = int(sess.elements)
                # export drains the source first (sync inside), so the
                # shipped state holds every ingested element
                sub = src_unit.service.export_rows([sess.row])
                # device to device: every exported tensor onto the
                # destination's device (the card when it names none)
                dst_dev = dst_unit.service.device
                if dst_dev is None:
                    dst_dev = resolve_device(None)
                shipped = type(sub)(
                    *(None if t is None else t.to(dst_dev) for t in sub)
                )
                src_unit.service.close_session(key)
            except FencedError as e:
                self._guard(src_unit, src_shard, e)
            try:
                new_sess = dst_unit.service.open_session(key)
                dst_unit.service.adopt_rows([new_sess.row], shipped)
                new_sess.elements = elements
            except FencedError as e:
                self._guard(dst_unit, dst_shard, e)
        self._overrides[key] = dst_shard
        self._append_routing(
            {
                "op": "migrate",
                "key": key,
                "src": src_shard,
                "dst": dst_shard,
                "elements": elements,
            }
        )
        dt = time.perf_counter() - t0
        if reg is not None:
            reg.histogram("cluster.migrate_s").observe(dt)
        _obs.emit(
            "shard.migrate",
            site="shard.migrate",
            session=key,
            src=src_shard,
            dst=dst_shard,
            elements=elements,
        )
        return new_sess

    def sync(self) -> Dict[int, int]:
        """Barrier every LIVE shard; returns ``{shard: flushed_seq}``.
        A shard hitting its fence mid-sync is marked down and skipped —
        partial degradation, not a cluster-wide failure."""
        seqs: Dict[int, int] = {}
        for unit in self._units:
            if not unit.alive:
                continue
            try:
                seqs[unit.shard_id] = unit.service.sync()
            except FencedError:
                unit.mark_fenced()
        return seqs

    def sessions_open(self) -> int:
        return sum(
            len(u.service.table) for u in self._units if u.alive
        )

    # ------------------------------------------------------------ HA plane

    def poll(self) -> int:
        """One replication step on every shard's standby; returns total
        sequences advanced."""
        return sum(unit.poll() for unit in self._units)

    def health(self) -> Dict[int, Any]:
        """Per-shard controller verdicts (shards without standbys omitted)."""
        out = {}
        for unit in self._units:
            report = unit.health()
            if report is not None:
                out[unit.shard_id] = report
        return out

    def maybe_promote(self) -> List[Tuple[int, str]]:
        """One cluster control-loop step: promote every shard whose OWN
        health verdict says so; returns ``[(shard, reason), ...]``."""
        promoted = []
        for unit in self._units:
            report = unit.health()
            if report is None or not report.should_promote:
                continue
            unit.promote(
                reason="; ".join(report.reasons) or "unhealthy",
                triggers=report.triggers,
            )
            promoted.append((unit.shard_id, ",".join(report.triggers)))
        return promoted

    def kill_shard(self, shard: int):
        return self._units[int(shard)].kill()

    def fence_shard(self, shard: int) -> int:
        return self._units[int(shard)].fence()

    def promote_shard(self, shard: int, reason: str = "manual"):
        return self._units[int(shard)].promote(reason=reason)

    def recover_shard(self, shard: int, **kwargs):
        return self._units[int(shard)].recover(**kwargs)

    def beat(self) -> dict:
        """Beat every live shard, then aggregate ONE cluster heartbeat
        (``<cluster_dir>/heartbeat.json``, atomic): per-shard
        epoch/seq/lag/SLO rows plus the worst verdict.  A shard whose
        beacon fails (fenced zombie, injected fault) is
        recorded down, never skipped silently."""
        shards: Dict[str, dict] = {}
        worst = "ok"
        for unit in self._units:
            try:
                unit.beat()
                row = unit.status()
            except Exception as e:  # fenced/faulted beacon: the row says so
                row = unit.status()
                row["beat_error"] = f"{type(e).__name__}: {e}"
            if not row.get("alive"):
                worst = "page"
            worst = max(
                (worst, row.get("slo_worst", "ok")),
                key=lambda v: _SEVERITY.get(v, 0),
            )
            shards[str(unit.shard_id)] = row
        payload = {
            "ts": time.time(),
            "cluster": True,
            "n_shards": self.n_shards,
            "routing_epoch": self.routing_epoch,
            "sessions_open": self.sessions_open(),
            "worst": worst,
            "shards": shards,
        }
        write_json_atomic(os.path.join(self.cluster_dir, _HEARTBEAT_NAME), payload, suffix=".tmp.hb")
        return payload

    # ------------------------------------------------------ merged snapshots

    def merged_snapshot(
        self,
        keys: Sequence[str],
        *,
        merge_key: int = 0,
        sync: bool = True,
        device: Optional[str] = None,
    ) -> np.ndarray:
        """One logical uniform sample over the named sessions' combined
        streams, merged across shards with the exact mergeable-reservoir
        math.  Deterministic for a fixed ``merge_key`` and key order.
        Uniform (plain) mode only: weighted and distinct merges are keyed
        by state and go through the stream mergers of
        :mod:`reservoir_tpu_torch.parallel.merge`.

        ``device=None`` runs the merge tree with each part on its shard's
        device as a rank
        (:func:`~reservoir_tpu_torch.parallel.merge.merge_samples_device`):
        on the card the parts are all-gathered by ``merge_ring_gather`` and
        each tree level draws through ``algl_merge_draws``; CPU ranks take
        the plain gather.  ``"cuda"`` is the same but raises unless every
        rank is a card.  ``"host"`` runs the plain tree on the CPU
        (:func:`~reservoir_tpu_torch.parallel.merge.merge_samples_host`),
        the reference the others equal bit for bit; it is timed under
        ``cluster.merge_s``, the others under ``cluster.merge_device_s``."""
        if self._config.weighted or self._config.distinct:
            raise ValueError(
                "merged_snapshot is uniform-mode only: weighted/distinct "
                "merges need state-level keys (ES keys / hash planes); use "
                "the stream mergers in reservoir_tpu_torch.parallel.merge"
            )
        if device not in (None, "cuda", "host"):
            raise ValueError(
                f"merged_snapshot(device=) takes None (the merge over the "
                f"shards' devices), 'cuda' (the same, card ranks only) or "
                f"'host' (the plain tree on the CPU); got {device!r}"
            )
        if not keys:
            raise ValueError("merged_snapshot needs at least one session key")
        from ..parallel.merge import merge_samples_device, merge_samples_host

        reg = _obs.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        parts = []
        ranks = []
        for key in keys:
            unit, _ = self._route(key)
            sample = unit.service.snapshot(key, sync=sync)
            parts.append((sample, unit.service.table.route(key).elements))
            ranks.append(unit.service.device)
        if device == "host":
            merged, _total = merge_samples_host(
                parts, merge_key, max_sample_size=self._config.max_sample_size
            )
        else:
            merged, _total = merge_samples_device(
                parts,
                merge_key,
                max_sample_size=self._config.max_sample_size,
                impl=device or "auto",
                devices=ranks,
            )
            merged = np.asarray(merged)
        if reg is not None:
            name = "cluster.merge_s" if device == "host" else "cluster.merge_device_s"
            reg.histogram(name).observe(time.perf_counter() - t0)
        return merged

    # -------------------------------------------------------------- recovery

    @classmethod
    def recover(
        cls,
        cluster_dir: str,
        *,
        standby: bool = True,
        retry_after_s: float = 0.05,
        faults: Optional[Any] = None,
        devices: Optional[Any] = None,
        **shard_kwargs: Any,
    ) -> "ShardedReservoirService":
        """Rebuild a crashed cluster from ``cluster_dir``.

        The routing journal's header re-pins ``(n_shards, routing_epoch,
        key)`` — the entire routing function — so every session re-routes
        identically; each replayed ``route`` record is cross-checked
        against the hash *with the migration overrides replayed in
        order* (a ``migrate`` record re-homes its key exactly as the live
        :meth:`migrate` did; divergence is a hard error, it would strand
        sessions on the wrong shard) and a torn final line is dropped
        (crash mid-append: the open it described is re-journaled by the
        shard's own session journal or never happened; a torn ``migrate``
        fails CLOSED — the key re-routes to its source, whose session
        journal already closed the lease).  Each shard then recovers
        independently via :meth:`ReservoirService.recover`, including its
        epoch pre-flight, so a shard whose lineage was fenced by a
        promotion fails typed instead of double-serving.  Element
        counts for migrated sessions (plain session-table state, not
        engine state) are restored from the last ``migrate`` record per
        key.  ``devices=`` re-pins shard engines exactly as at
        construction — placement is process-local, never journaled."""
        path = os.path.join(cluster_dir, _ROUTING_NAME)
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        records: List[dict] = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn tail: crash mid-append, dropped
                raise ValueError(
                    f"{path!r}: corrupt routing journal at line {i + 1}"
                )
        if not records or records[0].get("op") != "base":
            raise ValueError(
                f"{path!r}: routing journal has no base header record"
            )
        header = records[0]
        n_shards = int(header["shards"])
        routing_epoch = int(header["routing_epoch"])
        base_key = int(header["key"])
        overrides: Dict[str, int] = {}
        migrated: Dict[str, dict] = {}
        for rec in records[1:]:
            op = rec.get("op")
            if op == "route":
                want = overrides.get(
                    rec["key"],
                    shard_of(rec["key"], n_shards, routing_epoch),
                )
                if int(rec["shard"]) != want:
                    raise ValueError(
                        f"routing journal replay diverged at {rec!r}: the "
                        f"pinned routing function routes {rec['key']!r} to "
                        f"shard {want}"
                    )
            elif op == "migrate":
                want = overrides.get(
                    rec["key"],
                    shard_of(rec["key"], n_shards, routing_epoch),
                )
                if int(rec["src"]) != want:
                    raise ValueError(
                        f"routing journal replay diverged at {rec!r}: "
                        f"{rec['key']!r} lived on shard {want}, not "
                        f"{rec['src']}"
                    )
                overrides[rec["key"]] = int(rec["dst"])
                migrated[rec["key"]] = rec
            else:
                raise ValueError(
                    f"routing journal: unknown op {op!r}"
                )
        devs = _resolve_devices(devices, n_shards)
        units = []
        for i in range(n_shards):
            shard_dir = os.path.join(cluster_dir, f"shard{i}")
            service = ReservoirService.recover(
                shard_dir,
                obs_scope=f"shard{i}",
                faults=faults,
                device=devs[i],
                **{
                    k: v
                    for k, v in shard_kwargs.items()
                    if k in (
                        "ttl_s", "coalesce_bytes", "max_inflight_bytes",
                        "retry_after_s", "sweep_interval_s", "auditor",
                        "retry_policy", "flush_timeout_s",
                        "checkpoint_every", "durability", "pipelined",
                    )
                },
            )
            units.append(
                ShardUnit(
                    service.config,
                    i,
                    shard_dir,
                    key=base_key + 7919 * i,
                    standby=standby,
                    faults=faults,
                    device=devs[i],
                    _service=service,
                    **shard_kwargs,
                )
            )
        inst = cls(
            units[0].service.config,
            n_shards,
            cluster_dir,
            key=base_key,
            routing_epoch=routing_epoch,
            standby=standby,
            retry_after_s=retry_after_s,
            faults=faults,
            _units=units,
        )
        inst._overrides = overrides
        # Session.elements is front-end bookkeeping the shard journals
        # don't carry for an adopted row; the migrate record does.
        for key, rec in migrated.items():
            table = units[int(rec["dst"])].service.table
            if key in table:
                table.route(key).elements = int(rec["elements"])
        return inst

    # -------------------------------------------------------------- teardown

    def metrics_snapshot(self) -> dict:
        """Per-shard metric blocks plus cluster totals (bench evidence)."""
        shards = {
            str(u.shard_id): (
                u.service.metrics.snapshot() if u.alive else None
            )
            for u in self._units
        }
        live = [u.service.metrics for u in self._units if u.alive]
        return {
            "shards": shards,
            "ingested_elements": sum(m.ingested_elements for m in live),
            "rejections": sum(m.rejections for m in live),
            "sessions_open": self.sessions_open(),
        }

    def shutdown(self) -> None:
        for unit in self._units:
            if unit.alive:
                unit.shutdown()
        if self._routing_fh is not None:
            self._routing_fh.close()
            self._routing_fh = None

    def __del__(self) -> None:
        fh = getattr(self, "_routing_fh", None)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
