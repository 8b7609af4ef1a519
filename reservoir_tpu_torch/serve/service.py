"""Multi-tenant reservoir service: many sessions, one batched engine.

The port's copy of the JAX package's ``serve/service.py``.
:class:`ReservoirService` is the stack's traffic-facing entry point: it
multiplexes tenant sessions onto the rows of one
:class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge` (one engine
on the card, tens of thousands of rows) and serves results while streams
are still open.  Over the raw bridge it adds:

- **session lifecycle**: :meth:`~ReservoirService.open_session` /
  :meth:`~ReservoirService.ingest` / :meth:`~ReservoirService.snapshot` /
  :meth:`~ReservoirService.close_session` against opaque string keys,
  backed by the lease/evict
  :class:`~reservoir_tpu_torch.serve.sessions.SessionTable` (TTL and LRU
  eviction, generation-guarded recycling, and counter-keyed sub-keys, so a
  recycled row restarts through
  :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.reset_rows` without
  reseeding the engine);
- **coalescing across sessions**: ingests append to a pending buffer that
  ships through the bridge's ``push_interleaved`` demux in batches;
- **admission control**: a bounded in-flight byte budget; past it, and
  while the flush pipeline cannot take more
  (:meth:`DeviceStreamBridge.flush_would_block`), an ingest is rejected
  with :class:`~reservoir_tpu_torch.errors.ServiceSaturated` and a
  ``retry_after_s``, not queued;
- **live snapshots**: :meth:`~ReservoirService.snapshot` reads a session's
  sample without closing anything (``ReservoirEngine.peek_arrays``), from a
  host cache of the whole table keyed by ``(flushed_seq, reset_epoch)``;
- **failures scoped to a session and crash recovery**: a ``serve.ingest``
  fault surfaces as a :class:`~reservoir_tpu_torch.errors.SessionIngestError`
  and the service stays live; :meth:`~ReservoirService.recover` rebuilds the
  session table from its journal (``sessions.jsonl`` beside the bridge's
  checkpoint and journal, the JAX package's format) and re-applies the row
  resets between the replayed flushes they fell between (the bridge's
  ``replay_hook``), so the reservoirs come back bit-identical.

Every engine call runs on the card's path: the bridge's flushes launch the
update kernels (``algl_update``, ``weighted_update``, ``distinct_update``,
or ``algl_update_gated`` with ``gated=True``), and ``device=None`` means
the card.  ``device="cpu"`` runs the plain versions.

One writer, as the stack below: put a lock or a queue in front for
multi-producer traffic.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from ..config import SamplerConfig
from ..errors import (
    CheckpointMismatch,
    RetryPolicy,
    ServiceSaturated,
    SessionIngestError,
)
from ..obs import registry as _obs
from ..obs import trace as _trace
from ..stream.bridge import DeviceStreamBridge
from ..utils import faults as _faults
from ..utils.metrics import ServiceMetrics
from . import autotune as _serve_tune
from .autotune import DEFAULT_KNOBS, ServiceKnobs
from .sessions import Session, SessionTable

__all__ = ["ReservoirService"]

_JOURNAL_NAME = "sessions.jsonl"
_JOURNAL_VERSION = 1

class _Unset:
    """Distinct from ``None``: ``sweep_interval_s=None`` is a meaningful
    setting (manual sweeps only), so "not passed — resolve from the knob
    cache" needs its own sentinel.  The stable repr keeps generated API
    manifests deterministic across processes."""

    def __repr__(self) -> str:
        return "<UNSET>"


_UNSET: Any = _Unset()


def _read_session_journal(path: str) -> Tuple[dict, List[dict]]:
    """Parse the session journal: ``(header, ops)``.  A torn final line
    (crash mid-append) is dropped — the same tolerance the bridge's tile
    journal extends to its tail record."""
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
                break  # torn tail: the op it described never completed
            raise ValueError(
                f"{path!r}: corrupt session journal at line {i + 1}"
            )
    if not records or records[0].get("op") != "base":
        raise ValueError(
            f"{path!r}: session journal has no base header record"
        )
    return records[0], records[1:]


class ReservoirService:
    """Serve many tenant sessions from one batched device engine.

    Args:
      config: engine configuration; ``num_reservoirs`` is the session
        capacity (rows leasable at once) and ``distinct``/``weighted``
        select the sampling mode every session of this service uses.
      key: engine PRNG key/seed (per-row keys are split from it once).
      ttl_s: idle lease time after which a session is evictable (sweep or
        row pressure); ``None`` = LRU-only eviction.
      session_seed: base seed of the per-lease sub-key schedule (recycled
        rows draw from ``fold_in(fold_in(key(session_seed), row), gen)``).
      coalesce_bytes: pending-ingest threshold at which the buffer ships
        through ``push_interleaved`` (cross-session batching lever).
        Like every serving knob below (``max_inflight_bytes`` /
        ``checkpoint_every`` / ``sweep_interval_s`` / ``gate_push_chunk``),
        leaving it unset takes the swept winner from the knob cache
        (:mod:`reservoir_tpu_torch.serve.autotune`) for this service's
        workload fingerprint.  An explicit value always wins; no cache
        entry means the builtin default.
      max_inflight_bytes: admission-control budget over pending bytes;
        beyond it, ingest either flushes (pipeline willing) or rejects
        with :class:`ServiceSaturated`.
      retry_after_s: floor of the rejection's retry hint (the live hint
        scales with the observed per-flush dispatch time).
      sweep_interval_s: opportunistic TTL-sweep cadence.  When set (and
        ``ttl_s`` is), every :meth:`ingest` / :meth:`snapshot` /
        :meth:`sync` first evicts TTL-expired sessions if at least this
        many seconds passed since the last sweep — an idle-but-queried
        service sheds expired leases without anyone calling
        :meth:`sweep_expired` manually.  ``None`` (default) keeps sweeps
        manual-only.
      auditor: an optional sample-quality auditor, duck-typed: any object
        with ``record_ingest(key, elements)`` (called on every accepted
        ingest) and ``observe_snapshot(key, sample, n)`` (called on every
        read-your-writes snapshot).
      obs_scope: per-shard instrument label.  When set, the service's
        ``serve.*`` instruments are recorded under scoped names
        (``serve.ingest_s@<scope>``,
        :func:`reservoir_tpu_torch.obs.registry.scoped`), so services
        sharing one registry stay separately observable.  ``None``
        (default) keeps the unscoped names.
      pipelined / retry_policy / flush_timeout_s / checkpoint_dir /
        checkpoint_every / durability / faults / gated / gate_tile:
        forwarded to the underlying :class:`DeviceStreamBridge` (its
        robustness plane; ``gated`` is the ingest-side skip gate, and
        ``gate_tile=0`` means 64).  With ``checkpoint_dir`` set the service
        also journals the session map to ``sessions.jsonl`` there, which
        is what makes :meth:`recover` possible.  Admission control comes
        before the gate: ``coalesce_bytes`` / ``max_inflight_bytes`` bound
        the raw ingested bytes and ``flush_would_block`` probes the
        pipeline, so the gate changes neither the rejection threshold nor
        what ``ServiceSaturated.retry_after_s`` means.
      device: the engine's device, forwarded to the bridge; ``None``
        means the card and raises without one, ``"cpu"`` runs the plain
        versions.
    """

    def __init__(
        self,
        config: SamplerConfig,
        key: Any = None,
        *,
        ttl_s: Optional[float] = None,
        session_seed: int = 0,
        coalesce_bytes: Optional[int] = None,
        max_inflight_bytes: Optional[int] = None,
        retry_after_s: float = 0.05,
        sweep_interval_s: Optional[float] = _UNSET,
        auditor: Optional[Any] = None,
        obs_scope: Optional[str] = None,
        pipelined: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
        flush_timeout_s: Optional[float] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        durability: str = "buffered",
        faults: Optional[Any] = None,
        gated: bool = False,
        gate_tile: int = 64,
        gate_push_chunk: Optional[int] = None,
        device: Optional[Any] = None,
        _bridge: Optional[DeviceStreamBridge] = None,
        _table: Optional[SessionTable] = None,
    ) -> None:
        # the knob cache: any knob left unset resolves to the swept winner
        # for this workload fingerprint, then to the builtin default;
        # explicit arguments always win
        if (
            coalesce_bytes is None
            or max_inflight_bytes is None
            or checkpoint_every is None
            or gate_push_chunk is None
            or sweep_interval_s is _UNSET
        ):
            mode = (
                "weighted"
                if config.weighted
                else "distinct" if config.distinct else "plain"
            )
            tuned = _serve_tune.lookup_knobs(
                _serve_tune.device_kind_of(device),
                int(config.num_reservoirs),
                int(config.max_sample_size),
                mode,
                bool(gated),
            ) or DEFAULT_KNOBS
            if coalesce_bytes is None:
                coalesce_bytes = tuned.coalesce_bytes
            if max_inflight_bytes is None:
                max_inflight_bytes = tuned.max_inflight_bytes
            if checkpoint_every is None:
                checkpoint_every = tuned.checkpoint_every
            if gate_push_chunk is None:
                gate_push_chunk = tuned.gate_push_chunk
            if sweep_interval_s is _UNSET:
                # cache 0.0 = manual-only, the constructor's None
                sweep_interval_s = tuned.sweep_interval_s or None
        if coalesce_bytes <= 0 or max_inflight_bytes <= 0:
            raise ValueError(
                "coalesce_bytes and max_inflight_bytes must be positive"
            )
        if coalesce_bytes > max_inflight_bytes:
            raise ValueError(
                "coalesce_bytes must not exceed max_inflight_bytes (the "
                "coalesce buffer is what the admission bound bounds)"
            )
        self._faults = faults
        self._bridge = _bridge if _bridge is not None else DeviceStreamBridge(
            config,
            key=key,
            reusable=True,  # the serve plane never spends the lifecycle
            pipelined=pipelined,
            retry_policy=retry_policy,
            flush_timeout_s=flush_timeout_s,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            durability=durability,
            faults=faults,
            gated=gated,
            gate_tile=gate_tile,
            # cache 0 = "no opinion": keep the bridge's builtin default
            # rather than triggering its gate-geometry resolution
            gate_push_chunk=int(gate_push_chunk) if gate_push_chunk else 1 << 20,
            device=device,
        )
        config = self._bridge._config
        self._config = config
        self._table = _table if _table is not None else SessionTable(
            config.num_reservoirs, ttl_s=ttl_s, seed=session_seed
        )
        self._dtype = np.dtype(config.element_dtype)
        self._coalesce_bytes = int(coalesce_bytes)
        self._max_inflight_bytes = int(max_inflight_bytes)
        self._retry_after_s = float(retry_after_s)
        self._sweep_interval_s = (
            float(sweep_interval_s) if sweep_interval_s is not None else None
        )
        self._auditor = auditor
        self._obs_scope = obs_scope
        self._last_sweep = self._table._clock()
        self._tuner = None  # a ServiceTuner attaches itself
        self._metrics = ServiceMetrics()
        self._metrics.sessions_open = len(self._table)
        # pending cross-session coalesce buffer: (rows, elems, weights)
        # triples appended per ingest, shipped as ONE interleaved push
        self._pend: List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]] = []
        self._pend_bytes = 0
        self._pend_t0 = time.perf_counter()
        # snapshot cache: (samples, sizes) host arrays keyed by
        # (flushed_seq, reset_epoch) — reset_epoch invalidates on row
        # recycling, else a cached snapshot could leak the previous
        # tenant's data into a freshly opened session
        self._snap: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._snap_key: Optional[Tuple[int, int]] = None
        self._snap_at = time.monotonic()  # cache fill time (staleness)
        self._reset_epoch = 0
        # session journal (crash recovery of the table itself)
        self._journal_fh = None
        if checkpoint_dir is not None:
            path = os.path.join(checkpoint_dir, _JOURNAL_NAME)
            if _bridge is None:
                # fresh service: the bridge just wrote its seq-0 anchor and
                # rotated its tile journal; start the session map fresh too
                self._journal_fh = open(path, "w", encoding="utf-8")
                self._append_journal(
                    {
                        "op": "base",
                        "v": _JOURNAL_VERSION,
                        "seed": self._table.seed,
                        "rows": self._table.capacity,
                        "ttl_s": self._table.ttl_s,
                    }
                )
            else:
                # recovery adoption: continue appending to the replayed map
                self._journal_fh = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------ properties

    @property
    def config(self) -> SamplerConfig:
        return self._config

    @property
    def metrics(self) -> ServiceMetrics:
        return self._metrics

    @property
    def table(self) -> SessionTable:
        return self._table

    @property
    def bridge(self) -> DeviceStreamBridge:
        return self._bridge

    @property
    def flushed_seq(self) -> int:
        """The underlying bridge's durable flush watermark."""
        return self._bridge.flushed_seq

    @property
    def device(self) -> Optional[Any]:
        """The device this service's engine is pinned to (``None`` when
        unpinned)."""
        return self._bridge.device

    # ---------------------------------------------------------- live knobs

    def live_knobs(self) -> ServiceKnobs:
        """The serving knobs as currently live (constructor-resolved plus
        any :meth:`apply_knobs` nudges since) — what the
        :class:`~reservoir_tpu_torch.serve.autotune.ServiceTuner` reads before
        every control step and the sweep tool scores."""
        return ServiceKnobs(
            coalesce_bytes=self._coalesce_bytes,
            max_inflight_bytes=self._max_inflight_bytes,
            checkpoint_every=self._bridge.checkpoint_every,
            sweep_interval_s=self._sweep_interval_s or 0.0,
            gate_push_chunk=self._bridge.gate_push_chunk,
        )

    def apply_knobs(self, knobs: ServiceKnobs) -> None:
        """Apply a knob vector to the LIVE service (the online controller's
        write path).  Validates the same invariants as construction; takes
        effect from the next ingest/flush — never retroactively, so a
        nudge can change when bytes ship or state checkpoints, but no
        accepted element is ever dropped or resampled."""
        knobs = ServiceKnobs(*knobs)
        if knobs.coalesce_bytes <= 0 or knobs.max_inflight_bytes <= 0:
            raise ValueError(
                "coalesce_bytes and max_inflight_bytes must be positive"
            )
        if knobs.coalesce_bytes > knobs.max_inflight_bytes:
            raise ValueError(
                "coalesce_bytes must not exceed max_inflight_bytes"
            )
        self._coalesce_bytes = int(knobs.coalesce_bytes)
        self._max_inflight_bytes = int(knobs.max_inflight_bytes)
        self._bridge.set_checkpoint_every(knobs.checkpoint_every)
        if knobs.gate_push_chunk:
            self._bridge.set_gate_push_chunk(knobs.gate_push_chunk)
        self._sweep_interval_s = (
            float(knobs.sweep_interval_s)
            if knobs.sweep_interval_s > 0
            else None
        )

    def attach_tuner(self, tuner: Optional[Any]) -> None:
        """Attach (or detach, with ``None``) the online knob controller:
        every accepted ingest then gives it a rate-limited
        ``maybe_observe`` tick.  With no tuner attached the hot path pays
        one ``None`` test."""
        self._tuner = tuner

    def _scoped(self, name: str) -> str:
        """Instrument name under this service's per-shard scope; the
        unscoped name when the service is not shard-labeled."""
        return _obs.scoped(name, self._obs_scope)

    def _append_journal(self, rec: dict) -> None:
        if self._journal_fh is None:
            return
        self._journal_fh.write(json.dumps(rec) + "\n")
        self._journal_fh.flush()

    # ----------------------------------------------------------- lifecycle

    def open_session(self, key: str) -> Session:
        """Lease a reservoir row to ``key`` and return the live handle.

        A full table evicts first (TTL-expired sessions, then the LRU
        one); a recycled row (generation > 0) is reset on device with this
        lease's counter-keyed sub-seed — after every element already
        accepted for the previous tenant has been flushed, so no byte of
        the old stream can bleed into the new one."""
        sess, evicted = self._table.open(key)
        for ev in evicted:
            self._append_journal(
                {
                    "op": "evict",
                    "key": ev.key,
                    "row": ev.row,
                    "at_seq": self._bridge.flushed_seq,
                }
            )
            self._metrics.evictions += 1
        at_seq = self._bridge.flushed_seq
        if sess.generation > 0:
            # recycle: the previous tenant's staged/pending elements must
            # reach the device BEFORE the reset wipes the row (and the
            # worker must be idle — reset shares the single-writer slot)
            self.sync()
            at_seq = self._bridge.flushed_seq
            self._bridge.engine.reset_rows(
                [sess.row], self._table.sub_key(sess.row, sess.generation)
            )
            self._reset_epoch += 1
            self._metrics.recycles += 1
            _obs.emit(
                "session.recycle",
                site="serve.open",
                session=key,
                row=sess.row,
                gen=sess.generation,
                flush_seq=at_seq,
            )
        self._append_journal(
            {
                "op": "open",
                "key": key,
                "row": sess.row,
                "gen": sess.generation,
                "at_seq": at_seq,
            }
        )
        self._metrics.sessions_opened += 1
        self._metrics.sessions_open = len(self._table)
        _obs.emit(
            "session.open",
            site="serve.open",
            session=key,
            row=sess.row,
            flush_seq=at_seq,
        )
        return sess

    def close_session(self, key: str) -> np.ndarray:
        """End ``key``'s lease and return its final sample (the same
        non-destructive snapshot path — the engine stays open for every
        other session).  The freed row recycles on a later open."""
        final = self.snapshot(key)
        sess = self._table.close(key)
        self._append_journal(
            {
                "op": "close",
                "key": key,
                "row": sess.row,
                "at_seq": self._bridge.flushed_seq,
            }
        )
        self._metrics.closes += 1
        self._metrics.sessions_open = len(self._table)
        _obs.emit(
            "session.close",
            site="serve.close",
            session=key,
            row=sess.row,
            flush_seq=self._bridge.flushed_seq,
        )
        return final

    def _maybe_sweep(self) -> None:
        """Opportunistic TTL sweep: ingest/snapshot/
        sync call this first, so an idle-but-queried service still sheds
        expired leases on its own once ``sweep_interval_s`` elapses."""
        if self._sweep_interval_s is None or self._table.ttl_s is None:
            return
        now = self._table._clock()
        if now - self._last_sweep >= self._sweep_interval_s:
            self._last_sweep = now
            self.sweep_expired(now)

    def sweep_expired(self, now: Optional[float] = None) -> List[str]:
        """Evict every TTL-expired session; returns their keys."""
        evicted = self._table.sweep(now)
        for ev in evicted:
            self._append_journal(
                {
                    "op": "evict",
                    "key": ev.key,
                    "row": ev.row,
                    "at_seq": self._bridge.flushed_seq,
                }
            )
            self._metrics.evictions += 1
            _obs.emit(
                "session.evict",
                site="serve.sweep",
                session=ev.key,
                row=ev.row,
                flush_seq=self._bridge.flushed_seq,
            )
        self._metrics.sessions_open = len(self._table)
        return [ev.key for ev in evicted]

    # -------------------------------------------------------------- ingest

    def ingest(
        self, key: str, elements: Any, weights: Optional[Any] = None
    ) -> int:
        """Accept a 1-D chunk of elements for session ``key``; returns the
        count accepted.  Failures are scoped to this call — a typed
        :class:`SessionIngestError` (or a :class:`ServiceSaturated`
        rejection) leaves the service and every other session live.

        The elements join the cross-session coalesce buffer and ship
        through the bridge's interleaved demux once ``coalesce_bytes``
        accumulate (or at the next sync/snapshot barrier)."""
        # causal trace root: head-sampled on the session key (the same
        # stable hash at every site, so a kept session's route, admission,
        # ship and gate spans land in one trace).  One global load and a
        # None test when tracing is disabled.
        # Opened FIRST so the root's duration covers the whole call —
        # sweep and telemetry setup included — and the attribution
        # reconciles with a caller's wall clock up to span bookkeeping.
        tr = _trace.get()
        if tr is not None:
            with tr.span(
                "serve.ingest",
                key=key,
                session=key,
                shard=self._obs_scope,
            ):
                return self._ingest_counted(key, elements, weights, tr)
        return self._ingest_counted(key, elements, weights, None)

    def _ingest_counted(
        self,
        key: str,
        elements: Any,
        weights: Optional[Any],
        tr: Optional[Any],
    ) -> int:
        self._maybe_sweep()
        # telemetry: admission latency, the accept path's wall time
        # including any coalesce-buffer ship this call triggers, and the
        # error-rate counters: every call into serve.ingest_total, every
        # typed failure or rejection into serve.ingest_errors.  One global
        # load and a None test when disabled.
        reg = _obs.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        try:
            n = self._ingest_impl(key, elements, weights)
        except (SessionIngestError, ServiceSaturated) as e:
            if tr is not None:
                # rejections force-sample: the traces worth keeping are
                # never the ones the head sampler happened to keep
                tr.point(
                    "serve.reject",
                    session=key,
                    shard=self._obs_scope,
                    error=type(e).__name__,
                    flush_seq=self._bridge.flushed_seq,
                )
            if reg is not None:
                reg.counter(self._scoped("serve.ingest_total")).inc()
                reg.counter(self._scoped("serve.ingest_errors")).inc()
            raise
        if reg is not None:
            reg.counter(self._scoped("serve.ingest_total")).inc()
            reg.histogram(self._scoped("serve.ingest_s")).observe(
                time.perf_counter() - t0
            )
        if self._tuner is not None:
            # closed loop, rate-limited inside: steady traffic drives the
            # SLO evaluation without a background thread
            self._tuner.maybe_observe()
        return n

    def _ingest_impl(
        self, key: str, elements: Any, weights: Optional[Any]
    ) -> int:
        tr = _trace.get()
        adm_cm = (
            tr.span("serve.admission", session=key)
            if tr is not None
            else contextlib.nullcontext()
        )
        with adm_cm:
            sess = self._table.route(key)
            try:
                _faults.fire("serve.ingest", self._faults)
            except Exception as e:
                raise SessionIngestError(
                    key, f"{type(e).__name__}: {e}"
                ) from e
            try:
                arr = np.atleast_1d(
                    np.ascontiguousarray(elements, self._dtype)
                )
            except (TypeError, ValueError) as e:
                raise SessionIngestError(
                    key, f"elements not convertible to {self._dtype}: {e}"
                ) from None
            if arr.ndim != 1:
                raise SessionIngestError(
                    key, f"elements must be 1-D, got shape {arr.shape}"
                )
            warr: Optional[np.ndarray] = None
            if self._config.weighted:
                if weights is None:
                    raise SessionIngestError(
                        key, "weighted service requires weights"
                    )
                warr = np.atleast_1d(
                    np.ascontiguousarray(weights, np.float32)
                )
                if warr.shape != arr.shape:
                    raise SessionIngestError(
                        key,
                        f"weights must match elements shape {arr.shape}, "
                        f"got {warr.shape}",
                    )
                if not np.all(warr >= 0):
                    bad = int(np.argmax(warr < 0))
                    raise SessionIngestError(
                        key,
                        f"weights must be nonnegative (weights[{bad}] = "
                        f"{warr[bad]})",
                    )
            elif weights is not None:
                raise SessionIngestError(
                    key, "weights are only meaningful with weighted=True"
                )
            nbytes = arr.nbytes + (warr.nbytes if warr is not None else 0)
            if nbytes > self._max_inflight_bytes:
                raise SessionIngestError(
                    key,
                    f"single request of {nbytes} bytes exceeds "
                    f"max_inflight_bytes={self._max_inflight_bytes} "
                    "(split it)",
                )
            # Admission: past the coalesce threshold a flush is due, but a
            # saturated pipeline means flushing would BLOCK — buffer on
            # while the hard byte budget allows, then reject with a retry
            # hint.  (Never block the ingest path on a slow device:
            # bounded memory and an explicit 429 is the contract.)
            saturated = (
                self._pend_bytes + nbytes >= self._coalesce_bytes
                and self._bridge.flush_would_block()
            )
            if saturated and (
                self._pend_bytes + nbytes > self._max_inflight_bytes
            ):
                self._metrics.rejections += 1
                _obs.emit(
                    "serve.rejected",
                    site="serve.ingest",
                    session=key,
                    pending_bytes=self._pend_bytes + nbytes,
                    flush_seq=self._bridge.flushed_seq,
                )
                raise ServiceSaturated(
                    f"in-flight bytes {self._pend_bytes + nbytes} over "
                    f"budget {self._max_inflight_bytes} with the flush "
                    "pipeline saturated",
                    retry_after_s=self._retry_hint(),
                )
        n = int(arr.shape[0])
        if not self._pend:
            # coalesce-wait anchor: the first pending append starts the
            # clock the traced ship stage reports as serve.coalesce_wait
            self._pend_t0 = time.perf_counter()
        self._pend.append(
            (np.full(n, sess.row, np.int32), arr, warr)
        )
        self._pend_bytes += nbytes
        sess.elements += n
        self._metrics.ingested_elements += n
        if self._auditor is not None:
            # the sample-quality auditor's ingest ledger
            self._auditor.record_ingest(key, arr)
        if self._pend_bytes >= self._coalesce_bytes and not saturated:
            self._flush_pending()
        return n

    def _retry_hint(self) -> float:
        """Retry-after estimate: the observed per-flush dispatch time (what
        a permit actually takes to free), floored at ``retry_after_s``."""
        m = self._bridge.metrics
        per_flush = m.dispatch_s / m.flushes if m.flushes else 0.0
        return max(self._retry_after_s, per_flush)

    def _flush_pending(self) -> None:
        """Ship the coalesce buffer as one interleaved push (rows filling
        mid-batch flush tiles to the device as they do on the raw bridge)."""
        if not self._pend:
            return
        reg = _obs.get()
        if reg is not None:
            # coalesce occupancy: how full the cross-session buffer was
            # when it shipped (1.0 = exactly at threshold; < 1.0 = a
            # barrier flushed it early) — the `coalesce_bytes` tuning lever
            reg.histogram(
                self._scoped("serve.coalesce_fill"), lo=1e-3, hi=10.0
            ).observe(self._pend_bytes / self._coalesce_bytes)
        tr = _trace.get()
        ship_cm = contextlib.nullcontext()
        if tr is not None:
            # coalesce wait: age of the buffer when it ships.  Detached —
            # it spans many ingest calls' wall time, so folding it into
            # one call's trace would break the attribution reconciliation.
            marker = tr.point(
                "serve.coalesce_wait",
                force=False,
                detached=True,
                pending_bytes=self._pend_bytes,
                flush_seq=self._bridge.flushed_seq,
            )
            marker.duration_s = time.perf_counter() - self._pend_t0
            ship_cm = tr.span(
                "serve.ship", pending_bytes=self._pend_bytes
            )
        pend, self._pend, self._pend_bytes = self._pend, [], 0
        with ship_cm:
            streams = np.concatenate([p[0] for p in pend])
            elems = np.concatenate([p[1] for p in pend])
            warr = (
                np.concatenate([p[2] for p in pend])
                if self._config.weighted
                else None
            )
            self._bridge.push_interleaved(streams, elems, warr)
            # kick rows the demux filled to the device now instead of
            # waiting for the next push to overflow them — but never at the
            # cost of blocking the ingest path (the pipeline overlaps the
            # dispatch)
            if not self._bridge.flush_would_block():
                self._bridge.flush()

    def sync(self) -> int:
        """Barrier: coalesce buffer -> staging -> device, then wait out the
        pipeline.  Returns the durable ``flushed_seq`` watermark — after
        sync, every accepted element is journaled/applied and visible to
        snapshots."""
        self._maybe_sweep()
        self._flush_pending()
        self._bridge.flush()
        self._bridge.drain_barrier()
        return self._bridge.flushed_seq

    # ------------------------------------------------------- live migration

    def export_rows(self, rows: Any) -> Any:
        """Drain everything pending, then export the state of ``rows`` as
        fresh tensors (the source half of a live migration).
        The sync barrier first makes the export a consistent cut: every
        accepted element for those rows is reflected in it."""
        self.sync()
        return self._bridge.engine.export_rows(rows)

    def adopt_rows(self, rows: Any, sub_state: Any) -> None:
        """Adopt exported reservoir rows into this service's engine (the
        destination half of a live migration).  Journaled as one
        RTJA frame by the bridge; the snapshot cache epoch bumps so no
        cached read can serve the rows' previous contents."""
        self.sync()  # pending elements precede the adopt (stream order)
        self._bridge.adopt_rows(rows, sub_state)
        self._reset_epoch += 1

    # ------------------------------------------------------------ snapshots

    def snapshot(self, key: str, sync: bool = True) -> np.ndarray:
        """LIVE per-session result read — non-destructive, any number of
        times, while the session keeps streaming (the ``peek`` path; the
        raw engine's ``result()`` stays terminal and untouched).

        ``sync=True`` (default) gives read-your-writes: everything this
        thread ingested is flushed and visible.  ``sync=False`` serves the
        current durable watermark only (pending coalesced elements are not
        yet visible) — cheaper under heavy ingest.

        Reads are served from a whole-table device->host snapshot cache
        keyed by ``(flushed_seq, reset_epoch)``: N sessions polling between
        flushes cost ONE device readback, not N."""
        self._maybe_sweep()
        reg = _obs.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        sess = self._table.route(key)
        self._table.check(sess)  # generation guard: no stale-row reads
        if sync:
            self.sync()
        else:
            # peek shares the engine's single-writer slot with the worker
            self._bridge.drain_barrier()
        cache_key = (self._bridge.flushed_seq, self._reset_epoch)
        if self._snap_key != cache_key:
            self._snap = self._bridge.engine.peek_arrays()
            self._snap_key = cache_key
            self._snap_at = time.monotonic()
            self._metrics.snapshot_misses += 1
        else:
            self._metrics.snapshot_hits += 1
        samples, sizes = self._snap
        out = samples[sess.row, : int(sizes[sess.row])].copy()
        if self._auditor is not None and sync:
            # the sample-quality auditor: rolling KS pool and stratum
            # inclusion counts; n is this session's own stream length.
            # Only the read-your-writes path feeds the auditor — a
            # sync=False read can trail sess.elements by the coalesce
            # backlog, which would register as low-position bias that the
            # sampler never committed.
            self._auditor.observe_snapshot(key, out, sess.elements)
        if reg is not None:
            # sync=True reads pay a flush barrier — a different latency
            # population than the live cache-read path; keep the two
            # histograms separate so `snapshot_p*` stays the live number
            reg.histogram(
                self._scoped(
                    "serve.snapshot_sync_s" if sync else "serve.snapshot_s"
                )
            ).observe(time.perf_counter() - t0)
            # staleness: age of the device->host snapshot this read was
            # served from (0-ish on a miss; grows while the cache serves)
            reg.histogram(
                self._scoped("serve.snapshot_staleness_s")
            ).observe(time.monotonic() - self._snap_at)
        return out

    # ------------------------------------------------------------- recovery

    @classmethod
    def recover(
        cls,
        checkpoint_dir: str,
        *,
        ttl_s: Optional[float] = None,
        coalesce_bytes: Optional[int] = None,
        max_inflight_bytes: Optional[int] = None,
        retry_after_s: float = 0.05,
        sweep_interval_s: Optional[float] = _UNSET,
        auditor: Optional[Any] = None,
        obs_scope: Optional[str] = None,
        pipelined: Optional[bool] = None,
        retry_policy: Optional[RetryPolicy] = None,
        flush_timeout_s: Optional[float] = None,
        checkpoint_every: Optional[int] = None,
        durability: Optional[str] = None,
        faults: Optional[Any] = None,
        device: Optional[Any] = None,
    ) -> "ReservoirService":
        """Rebuild a crashed service from ``checkpoint_dir``.

        Two journals replay together: the bridge's checkpoint + tile
        journal rebuild the reservoirs, and ``sessions.jsonl`` rebuilds
        the session table (leases, rows, generations, free-list order).
        Row resets from session recycling are re-applied *between* the
        replayed flushes they originally fell between (the ``replay_hook``
        protocol), so recovered reservoirs are bit-identical to an
        uninterrupted run.

        Elements ingested but never flushed (the coalesce buffer at crash
        time) are not recoverable — they never left the producer's
        custody; producers resume from :attr:`flushed_seq`, exactly the
        raw bridge's contract."""
        header, ops = _read_session_journal(
            os.path.join(checkpoint_dir, _JOURNAL_NAME)
        )
        if ttl_s is None:
            ttl_s = header.get("ttl_s")  # default to the crashed service's
        table = SessionTable(
            int(header["rows"]), ttl_s=ttl_s, seed=int(header["seed"])
        )
        resets: List[Tuple[int, int, int]] = []  # (at_seq, row, gen)
        for rec in ops:
            if rec["op"] == "open":
                sess, evicted = table.open(rec["key"])
                if evicted or sess.row != rec["row"] or (
                    sess.generation != rec["gen"]
                ):
                    raise ValueError(
                        f"session journal replay diverged at {rec!r}: "
                        f"rebuilt lease (row={sess.row}, "
                        f"gen={sess.generation}) does not match the record"
                    )
                if sess.generation > 0:
                    resets.append(
                        (int(rec["at_seq"]), sess.row, sess.generation)
                    )
            elif rec["op"] in ("close", "evict"):
                table.close(rec["key"])
            else:
                raise ValueError(
                    f"session journal: unknown op {rec.get('op')!r}"
                )
        # interleave journaled row resets into the tile replay at their
        # original positions; resets the checkpoint already covers
        # (at_seq < covered) are skipped — they are baked into its state
        cursor = {"i": 0, "covered": None}

        def replay_hook(bridge: DeviceStreamBridge, watermark: int) -> None:
            if cursor["covered"] is None:
                cursor["covered"] = watermark
                while (
                    cursor["i"] < len(resets)
                    and resets[cursor["i"]][0] < watermark
                ):
                    cursor["i"] += 1
            while (
                cursor["i"] < len(resets)
                and resets[cursor["i"]][0] <= watermark
            ):
                _, row, gen = resets[cursor["i"]]
                bridge.engine.reset_rows([row], table.sub_key(row, gen))
                cursor["i"] += 1

        bridge = DeviceStreamBridge.recover(
            checkpoint_dir,
            pipelined=pipelined,
            retry_policy=retry_policy,
            flush_timeout_s=flush_timeout_s,
            checkpoint_every=checkpoint_every,
            durability=durability,
            faults=faults,
            replay_hook=replay_hook,
            device=device,
        )
        if bridge._config.num_reservoirs != table.capacity:
            # recovery pre-flight: the two journals
            # must describe the SAME plane — a swapped/stale sessions.jsonl
            # would otherwise lease rows the engine does not have
            raise CheckpointMismatch(
                f"session journal in {checkpoint_dir!r} leases "
                f"{table.capacity} rows, but the engine checkpoint has "
                f"num_reservoirs={bridge._config.num_reservoirs}"
            )
        service = cls(
            bridge._config,
            ttl_s=ttl_s,
            coalesce_bytes=coalesce_bytes,
            max_inflight_bytes=max_inflight_bytes,
            retry_after_s=retry_after_s,
            sweep_interval_s=sweep_interval_s,
            auditor=auditor,
            obs_scope=obs_scope,
            faults=faults,
            checkpoint_dir=checkpoint_dir,
            _bridge=bridge,
            _table=table,
        )
        service._metrics.recoveries += 1
        return service

    # ------------------------------------------------------------- teardown

    def shutdown(self) -> None:
        """Flush everything pending, wait out the pipeline, and close the
        session journal.  Sessions stay leased (the table is durable via
        the journal) — this is a clean process exit, not a mass close."""
        self.sync()
        if self._journal_fh is not None:
            self._journal_fh.close()
            self._journal_fh = None

    def __del__(self) -> None:
        fh = getattr(self, "_journal_fh", None)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
