"""Hot standby: tail a primary's flush journal into a warm replica (the
port's copy of the JAX package's ``serve/replica.py``).

The bridge's recovery plane already writes everything a replica needs:
``engine.npz`` (atomic checkpoints carrying the flush watermark),
``journal.bin`` (CRC-framed tiles keyed by ``flushed_seq``) and, for the
serving plane, ``sessions.jsonl`` (the session map, each op at its
``at_seq`` between flushes).  A :class:`StandbyReplica` keeps a warm copy
caught up, so a failover is an epoch bump plus the last few records
instead of a checkpoint load and a whole journal's replay.

- :class:`JournalFollower`: a resumable byte-cursor tail of
  ``journal.bin``: CRC-checked, tolerant of a torn tail (a partial frame
  is a primary mid-append, read again next poll), aware of rotation (the
  file shrinking below the cursor, or another record at the cursor, means
  the primary checkpointed and truncated: the scan restarts at byte 0 and
  skips applied sequence numbers), and of gaps (records lost to a rotation
  the standby slept through force a checkpoint-shipping re-bootstrap).
- :class:`StandbyReplica`: the checkpoint-shipping bootstrap and the
  incremental apply.  It holds a warm
  :class:`~reservoir_tpu_torch.serve.service.ReservoirService` (never
  journaling, never checkpointing: one primary owns the durable state) and
  applies shipped tiles through the replay path ``recover()`` uses, each
  with one launch of the mode's update kernel on the card (``algl_update``,
  ``weighted_update``, ``distinct_update``, or ``algl_update_gated`` for a
  gated frame), with the session ops (row resets between flushes) applied
  at their journaled ``at_seq``.  Bit-identical to the primary by
  construction: it replays the same journaled bytes in the same order.
  :meth:`StandbyReplica.lag` reports (seq delta, staleness seconds);
  :meth:`StandbyReplica.promote` performs the epoch-fenced failover (see
  :mod:`reservoir_tpu_torch.serve.ha` for the fencing).

The standby's engine lives on ``device`` (``None`` means the card and
raises without one; ``"cpu"`` runs the plain versions).

Fault plane: ``replica.ship`` fires on the follower's read path and
``replica.apply`` before each tile lands on the standby's engine.  An
injected failure at either makes the poll return early (counted in
:class:`~reservoir_tpu_torch.utils.metrics.HAMetrics`); the cursor does
not pass unapplied records, and the next poll retries: lag grows, the
state is never wrong.

One writer, as everything below it: one thread owns a replica's ``poll``
and ``promote``; snapshot reads share that thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from ..obs import registry as _obs
from ..obs import trace as _ctrace
from ..obs.export import json_snapshot, write_json_atomic
from ..stream.bridge import (
    DeviceStreamBridge,
    _FlushJournal,
    _unpack_adopt_payload,
)
from ..utils import faults as _faults
from ..utils.checkpoint import (
    advance_epoch,
    load_engine,
    read_engine_metadata,
)
from ..utils.metrics import HAMetrics
from ..utils.tracing import trace_span
from .service import _JOURNAL_NAME, ReservoirService
from .sessions import SessionTable

__all__ = ["JournalFollower", "StandbyReplica"]


class JournalFollower:
    """Resumable byte-cursor tail of a bridge tile journal.

    The cursor is ``(seq, offset)``: :meth:`poll` returns every intact
    record past it (bounded by ``max_records``), stopping cleanly at a
    torn tail.  The caller advances the cursor explicitly
    (:meth:`advance`) after *applying* each record, so a failed apply is
    re-read on the next poll — the follower can never skip a record it
    only read.
    """

    def __init__(
        self,
        path: str,
        num_streams: int,
        tile_width: int,
        dtype,
        weighted: bool,
        *,
        start_seq: int = 0,
        max_records: int = 256,
        faults: Optional[Any] = None,
    ) -> None:
        self._path = path
        self._S = int(num_streams)
        self._B = int(tile_width)
        self._dtype = np.dtype(dtype)
        self._weighted = weighted
        self._seq = int(start_seq)
        self._offset = 0
        self._offset_seq = 0
        # byte offset where the record ending at the cursor starts, tracked
        # because gated frames make records variable-size, so the
        # predecessor probe cannot assume a fixed stride
        self._offset_start: Optional[int] = None
        self._starts: dict = {}
        self._max = int(max_records)
        self._faults = faults
        n_payload = self._S * 4 + self._S * self._B * (
            self._dtype.itemsize + (4 if weighted else 0)
        )
        # a PLAIN frame's size: the largest frame a non-gated primary
        # writes; used as the conservative misalignment bound below
        self._record_nbytes = _FlushJournal._HEADER.size + n_payload + 4

    @property
    def seq(self) -> int:
        """Sequence number of the last record the caller acknowledged."""
        return self._seq

    @property
    def offset(self) -> int:
        return self._offset

    def advance(self, seq: int, offset: int) -> None:
        """Acknowledge a record as applied: the cursor moves past it."""
        self._seq = int(seq)
        self._offset = int(offset)
        self._offset_seq = int(seq)
        start = self._starts.get(int(offset))
        if start is not None:
            self._offset_start = start

    def rewind(self, seq: int) -> None:
        """Reset after a re-bootstrap: scan from byte 0, skipping records
        the fresh checkpoint covers (``seq`` is its watermark)."""
        self._seq = int(seq)
        self._offset = 0
        self._offset_start = None

    def _cursor_valid(self) -> bool:
        """Whether the record ending at the cursor is still the one we
        read there.  Rotation truncates the journal and new records land
        at reusable byte offsets, so a size check alone cannot detect it —
        re-read the header of the record ending at the cursor (its start
        offset is tracked per ack: gated frames make records
        variable-size) and compare its sequence number."""
        start = (
            self._offset_start
            if self._offset_start is not None
            else self._offset - self._record_nbytes
        )
        if start < 0:
            return False
        try:
            with open(self._path, "rb") as fh:
                fh.seek(start)
                head = fh.read(_FlushJournal._HEADER.size)
        except FileNotFoundError:
            return False
        if len(head) < _FlushJournal._HEADER.size:
            return False
        magic, seq, _ = _FlushJournal._HEADER.unpack(head)
        return magic in (
            _FlushJournal._MAGIC,
            _FlushJournal._MAGIC_GATED,
            _FlushJournal._MAGIC_ADOPT,
        ) and seq == self._offset_seq

    def poll(
        self,
    ) -> Tuple[
        List[
            Tuple[
                int, int, np.ndarray, np.ndarray, Optional[np.ndarray],
                Optional[np.ndarray],
            ]
        ],
        bool,
        bool,
    ]:
        """Read intact records past the cursor.

        Returns ``(records, rotated, gap)``: ``records`` is a list of
        ``(end_offset, seq, tile, valid, wtile, advance)`` in sequence
        order (``advance`` non-None marks a gated or adopt frame);
        ``rotated`` flags a detected journal rotation (file shrank below
        the cursor); ``gap`` means an intact record was found whose seq
        skips past the cursor — records were lost to a rotation and the
        caller must re-bootstrap from the checkpoint.  The ``replica.ship``
        fault site fires before any file I/O.
        """
        _faults.fire("replica.ship", self._faults)
        rotated = False
        try:
            size = os.path.getsize(self._path)
        except FileNotFoundError:
            return [], False, False
        if self._offset and (size < self._offset or not self._cursor_valid()):
            rotated = True
            self._offset = 0
            self._offset_start = None
        records: List = []
        gap = False
        prev_end = self._offset
        starts: dict = {}
        for end, seq, tile, valid, wtile, adv in _FlushJournal.read_records(
            self._path,
            self._S,
            self._B,
            self._dtype,
            self._weighted,
            offset=self._offset,
        ):
            start, prev_end = prev_end, end
            if seq <= self._seq:
                # already applied (post-rotation rescan): skip permanently
                self._offset = end
                self._offset_seq = seq
                self._offset_start = start
                continue
            if seq != self._seq + len(records) + 1:
                gap = True
                break
            records.append((end, seq, tile, valid, wtile, adv))
            starts[end] = start
            if len(records) >= self._max:
                break
        self._starts = starts
        if not records and not gap and self._offset:
            # Misalignment detector: a rotation can go unnoticed when the
            # new journal grows past the old cursor (size never dipped
            # below it) — the cursor then points mid-record and parses
            # nothing, forever.  The primary appends record-at-a-time
            # (each fully flushed before the next starts), so a full
            # record's worth of bytes beyond the cursor that does NOT
            # parse cannot be a torn tail: declare a gap and let the
            # caller re-bootstrap, which realigns the scan at byte 0.
            try:
                size = os.path.getsize(self._path)
            except FileNotFoundError:
                size = 0
            if size >= self._offset + self._record_nbytes:
                gap = True
        return records, rotated, gap


class StandbyReplica:
    """A warm replica of a checkpointing bridge or service, caught up by
    tailing its journal: the hot-standby half of the HA plane.

    Construction performs the checkpoint-shipping bootstrap: load
    ``engine.npz``, rebuild the session table from ``sessions.jsonl``
    (row resets the checkpoint already covers are skipped — they are
    baked into its state), and point a :class:`JournalFollower` at the
    post-checkpoint tail.  :meth:`poll` then applies newly journaled
    tiles and session ops in their original interleaving; because every
    draw is counter-keyed on absolute stream indices, the standby's
    reservoirs are **bit-identical** to the primary's at every applied
    watermark.

    The standby never writes to ``checkpoint_dir``: one primary owns the
    durable state until :meth:`promote` fences it (epoch bump), drains
    the remaining tail, and flips this replica into a live, journaling
    primary.  Until then, :meth:`snapshot` serves read-only (bounded-
    staleness) session queries — a read replica for free.

    Args:
      checkpoint_dir: the primary's checkpoint directory (shared or
        shipped filesystem).
      map_fn / hash_fn: code is not data: pass again the hooks the
        primary's engine runs with; the standby's engine (and a
        re-bootstrap's, and the promoted primary's) runs them.
      max_records: tile-apply batch bound per :meth:`poll`.
      clock: monotonic time source for staleness accounting (injectable).
      faults: fault plane for the ``replica.*`` sites.
      metrics: shared :class:`HAMetrics` (one is created when omitted).
      status_path: when set, every :meth:`poll` / :meth:`promote` writes an
        atomic JSON status file there (applied watermark, lag, promotion
        state, plus the telemetry JSON export when the registry is
        enabled).  Never inside ``checkpoint_dir``: the standby does not
        write to the primary's durable state.
      device: the standby's engine and warm service live here; ``None``
        means the card and raises without one, ``"cpu"`` runs the plain
        versions.  A re-bootstrap and the promoted primary stay on it.
    """

    def __init__(
        self,
        checkpoint_dir: str,
        *,
        map_fn: Optional[Any] = None,
        hash_fn: Optional[Any] = None,
        max_records: int = 256,
        clock=time.monotonic,
        faults: Optional[Any] = None,
        metrics: Optional[HAMetrics] = None,
        status_path: Optional[str] = None,
        device: Optional[Any] = None,
    ) -> None:
        self._dir = checkpoint_dir
        self._map_fn = map_fn
        self._hash_fn = hash_fn
        self._device = device
        self._status_path = status_path
        self._max_records = int(max_records)
        self._clock = clock
        self._faults = faults
        self._metrics = metrics if metrics is not None else HAMetrics()
        self._promoted = False
        self._last_error: Optional[BaseException] = None
        self._started_at = clock()
        self._caught_up_at: Optional[float] = None
        self._target_seq = 0
        self._covered_cache: Tuple[Optional[Tuple[int, int]], int] = (None, 0)
        self._bootstrap()

    # ------------------------------------------------------------ properties

    @property
    def checkpoint_dir(self) -> str:
        return self._dir

    @property
    def metrics(self) -> HAMetrics:
        return self._metrics

    @property
    def applied_seq(self) -> int:
        """The flush watermark this replica has applied (its reservoirs
        are bit-identical to the primary's as of this sequence)."""
        return self._applied_seq

    @property
    def is_promoted(self) -> bool:
        return self._promoted

    @property
    def service(self) -> ReservoirService:
        """The warm service.  NOTE: its identity changes when a journal
        rotation forces a re-bootstrap — hold the replica, not this."""
        return self._service

    @property
    def table(self) -> SessionTable:
        return self._service.table

    @property
    def last_error(self) -> Optional[BaseException]:
        """The most recent ship/apply failure (retried on the next poll)."""
        return self._last_error

    # ------------------------------------------------------------- bootstrap

    def _bootstrap(self) -> None:
        """Checkpoint-shipping bootstrap: engine from ``engine.npz``,
        session table from the full ``sessions.jsonl``, follower cursor at
        the checkpoint's watermark."""
        engine_path = os.path.join(self._dir, "engine.npz")
        engine, metadata = load_engine(
            engine_path, device=self._device, with_metadata=True,
            map_fn=self._map_fn, hash_fn=self._hash_fn,
        )
        info = (metadata or {}).get("bridge")
        if info is None:
            raise ValueError(
                f"{engine_path!r} was not written by an auto-checkpointing "
                "bridge (no bridge metadata); a standby can only follow one"
            )
        engine._faults = self._faults
        covered = int(info["seq"])
        self._bridge_info = dict(info)
        config = engine.config
        # the standby's bridge holds the engine and keys the snapshot cache:
        # unpipelined (tiles apply on the poll thread) and not journaling
        # (one primary owns the durable state until promote())
        bridge = DeviceStreamBridge(
            config,
            reusable=True,
            pipelined=False,
            faults=self._faults,
            _engine=engine,
        )
        bridge._flush_seq = covered
        self._engine = engine
        self._bridge = bridge
        self._covered = covered
        self._applied_seq = covered
        self._target_seq = max(self._target_seq, covered)
        self._pending_ops: Deque[dict] = deque()
        self._sess_offset = 0
        header = self._read_session_header()
        table = SessionTable(
            config.num_reservoirs,
            ttl_s=(header or {}).get("ttl_s"),
            seed=int((header or {}).get("seed", 0)),
        )
        self._service = ReservoirService(
            config,
            ttl_s=table.ttl_s,
            faults=self._faults,
            _bridge=bridge,
            _table=table,
        )
        self._table = table
        self._follower = JournalFollower(
            os.path.join(self._dir, "journal.bin"),
            config.num_reservoirs,
            config.tile_size,
            np.dtype(config.element_dtype),
            config.weighted,
            start_seq=covered,
            max_records=self._max_records,
            faults=self._faults,
        )
        # ops journaled before the checkpoint watermark apply immediately
        # (their table effect; resets with at_seq < covered are baked into
        # the checkpointed state and skipped — the recover() cursor rule)
        self._pending_ops.extend(self._tail_session_ops())
        self._drain_ready_ops()
        self._metrics.bootstraps += 1
        _obs.emit(
            "replica.bootstrap", site="replica.ship", flush_seq=covered
        )

    def _read_session_header(self) -> Optional[dict]:
        """Parse and consume the ``base`` header record, when a session
        journal exists (bridge-only primaries have none — the replica then
        follows tiles alone over a fresh table)."""
        ops = self._tail_session_ops()
        if not ops:
            return None
        header = ops[0]
        if header.get("op") != "base":
            raise ValueError(
                f"{os.path.join(self._dir, _JOURNAL_NAME)!r}: session "
                "journal has no base header record"
            )
        self._pending_ops.extend(ops[1:])
        return header

    # ------------------------------------------------------------- tailing

    def _tail_session_ops(self) -> List[dict]:
        """Incremental session-journal tail: parse newline-terminated
        lines past the byte cursor (a torn final line is a primary
        mid-append — left unconsumed for the next poll)."""
        path = os.path.join(self._dir, _JOURNAL_NAME)
        try:
            with open(path, "rb") as fh:
                fh.seek(self._sess_offset)
                data = fh.read()
        except FileNotFoundError:
            return []
        ops: List[dict] = []
        consumed = 0
        for line in data.split(b"\n")[:-1]:
            consumed += len(line) + 1
            if line.strip():
                ops.append(json.loads(line))
        self._sess_offset += consumed
        return ops

    def _apply_op(self, op: dict) -> None:
        """One session-map op at its journaled position.  Engine resets go
        FIRST (from the record's own row/gen, so a failure retries
        cleanly with the table untouched), then the table op with the same
        divergence check ``recover()`` applies."""
        kind = op.get("op")
        if kind == "open":
            row, gen = int(op["row"]), int(op["gen"])
            if gen > 0 and int(op["at_seq"]) >= self._covered:
                with self._bridge._on_stream():
                    self._engine.reset_rows(
                        [row], self._table.sub_key(row, gen)
                    )
                self._service._reset_epoch += 1
            sess, evicted = self._table.open(op["key"])
            if evicted or sess.row != row or sess.generation != gen:
                raise ValueError(
                    f"session journal replay diverged at {op!r}: rebuilt "
                    f"lease (row={sess.row}, gen={sess.generation}) does "
                    "not match the record"
                )
        elif kind in ("close", "evict"):
            self._table.close(op["key"])
        else:
            raise ValueError(f"session journal: unknown op {kind!r}")
        self._metrics.applied_ops += 1

    def _drain_ready_ops(self) -> None:
        """Apply queued ops whose journaled position has been reached.
        An op at ``at_seq`` happened after flush ``at_seq`` on the
        primary, so it applies once ``applied_seq`` reaches it — both its
        table effect and its engine reset, together, so a standby
        snapshot can never route a new lease to a not-yet-reset row."""
        while self._pending_ops and (
            int(self._pending_ops[0]["at_seq"]) <= self._applied_seq
        ):
            self._apply_op(self._pending_ops[0])
            self._pending_ops.popleft()

    def _checkpoint_covered(self) -> int:
        """The current checkpoint's flush watermark, stat-cached so the
        per-poll staleness probe costs one stat until the primary actually
        checkpoints again (manifest-only read on change)."""
        path = os.path.join(self._dir, "engine.npz")
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return 0
        key = (st.st_mtime_ns, st.st_size)
        if self._covered_cache[0] != key:
            meta = read_engine_metadata(path)
            self._covered_cache = (
                key,
                int((meta.get("bridge") or {}).get("seq", 0)),
            )
        return self._covered_cache[1]

    # --------------------------------------------------------------- polling

    def poll(self) -> int:
        """One replication step: tail new session ops and journal records,
        apply them in their original interleaving.  Returns the number of
        flush sequences advanced (0 = caught up, or a ship/apply failure
        — inspect :attr:`last_error` / :attr:`metrics`; the failed work is
        retried on the next poll, never skipped)."""
        if self._promoted:
            raise RuntimeError(
                "this replica was promoted; poll the new primary's standby"
            )
        applied = 0
        try:
            self._pending_ops.extend(self._tail_session_ops())
            self._drain_ready_ops()
            records, rotated, gap = self._follower.poll()
            if not records and not gap:
                # Nothing readable: records may have been lost to a
                # rotation this follower could not witness (journal
                # truncated before it ever read them — e.g. a fresh
                # re-follow whose cursor is still at byte 0, so neither
                # the size dip nor the content probe can fire).  The
                # checkpoint watermark is the authority: anything it
                # covers beyond our applied seq means re-bootstrap.
                if self._checkpoint_covered() > self._applied_seq:
                    gap = True
            if gap:
                # records were lost to a rotation we slept through (or
                # the cursor is misaligned past one): the newer checkpoint
                # covers everything before its watermark — re-bootstrap
                # from it, then tail the realigned journal in this poll
                old = self._applied_seq
                self._bootstrap()
                applied += max(0, self._applied_seq - old)
                records, _, _ = self._follower.poll()
                if records:
                    self._target_seq = max(
                        self._target_seq, records[-1][1]
                    )
        except Exception as e:
            self._metrics.ship_errors += 1
            self._last_error = e
            self._update_lag()
            return applied
        if records:
            self._target_seq = max(self._target_seq, records[-1][1])
        for end, seq, tile, valid, wtile, advance in records:
            try:
                _faults.fire("replica.apply", self._faults)
                # the replay path recover() uses, bit-exact by construction
                # (counter-keyed draws); gated frames apply through the
                # gated engine path
                reg = _obs.get()
                tr = _ctrace.get()
                t0 = time.perf_counter() if reg is not None else 0.0
                # causal root keyed by the flush seq: the same stable hash
                # the bridge used, so a sampled flush is sampled here too
                # and the two sides of a journal frame join on flush_seq
                acm = (
                    tr.span("replica.apply", key=seq, flush_seq=seq)
                    if tr is not None
                    else contextlib.nullcontext()
                )
                with acm, trace_span("reservoir_replica_apply"), self._bridge._on_stream():
                    if advance is _FlushJournal.ADOPT:
                        # adopt frame: a live migration landed rows on the
                        # primary; apply them here at the same position
                        # between flushes
                        rows, sub = _unpack_adopt_payload(tile)
                        self._engine.adopt_rows(rows, sub)
                        self._service._reset_epoch += 1
                    elif advance is not None:
                        self._engine.sample_gated(tile, valid, advance)
                    else:
                        self._engine.sample(tile, valid=valid, weights=wtile)
                if reg is not None:
                    reg.histogram("replica.apply_s").observe(
                        time.perf_counter() - t0
                    )
                self._applied_seq = seq
                self._bridge._flush_seq = seq  # keys the snapshot cache
                self._follower.advance(seq, end)
                self._metrics.applied_tiles += 1
                applied += 1
                self._drain_ready_ops()
            except Exception as e:
                self._metrics.apply_errors += 1
                self._last_error = e
                break
        self._update_lag()
        self._write_status()
        return applied

    def _update_lag(self) -> None:
        now = self._clock()
        lag_seq = max(0, self._target_seq - self._applied_seq)
        if lag_seq == 0 and not self._pending_ops:
            self._caught_up_at = now
            lag_s = 0.0
        else:
            since = (
                self._caught_up_at
                if self._caught_up_at is not None
                else self._started_at
            )
            lag_s = max(0.0, now - since)
        self._metrics.lag_seq = lag_seq
        self._metrics.lag_s = lag_s
        reg = _obs.get()
        if reg is not None:
            # gauges carry the instantaneous lag; histograms accumulate
            # the distribution over polls
            reg.gauge("replica.lag_seq").set(lag_seq)
            reg.gauge("replica.lag_s").set(lag_s)
            reg.histogram(
                "replica.lag_seq_dist", lo=1e-3, hi=1e9, buckets_per_decade=4
            ).observe(lag_seq)
            reg.histogram("replica.lag_s_dist").observe(lag_s)

    def _write_status(self) -> None:
        """Atomic standby status file (``status_path=``).  Best effort: a
        failed status write never fails replication."""
        if self._status_path is None:
            return
        payload = {
            "ts": time.time(),
            "applied_seq": self._applied_seq,
            "target_seq": self._target_seq,
            "lag_seq": self._metrics.lag_seq,
            "lag_s": self._metrics.lag_s,
            "bootstraps": self._metrics.bootstraps,
            "apply_errors": self._metrics.apply_errors,
            "ship_errors": self._metrics.ship_errors,
            "promoted": self._promoted,
            "last_error": (
                repr(self._last_error) if self._last_error else None
            ),
        }
        reg = _obs.get()
        if reg is not None:
            payload["telemetry"] = json_snapshot(reg)
        try:
            write_json_atomic(self._status_path, payload, suffix=".tmp.status")
        except OSError:
            pass

    def lag(self) -> Tuple[int, float]:
        """Replication lag as ``(seq_delta, staleness_s)``: flush
        sequences known-durable but not yet applied, and seconds since
        this replica was last provably caught up (0.0 while caught up).
        The seq target is the newest record the follower has *seen* — a
        ship failure freezes it, so staleness keeps growing while the
        delta may under-report until the next successful read."""
        self._update_lag()
        return self._metrics.lag_seq, self._metrics.lag_s

    def snapshot(self, key: str) -> np.ndarray:
        """Read-only per-session snapshot at the applied watermark (the
        bounded-staleness read-replica path; never flushes, never
        journals)."""
        return self._service.snapshot(key, sync=False)

    # ------------------------------------------------------------- promotion

    def promote(
        self,
        *,
        checkpoint: bool = True,
        checkpoint_every: Optional[int] = None,
        durability: Optional[str] = None,
        drain_attempts: int = 32,
    ) -> ReservoirService:
        """Epoch-fenced failover: make this replica the live primary.

        1. **Fence** — bump the epoch persisted in the checkpoint dir
           (fsynced).  From this instant the old primary's next flush or
           checkpoint raises :class:`~reservoir_tpu_torch.errors.FencedError`
           without mutating the journal — split-brain cannot corrupt the
           durable state.
        2. **Drain** — poll until a clean pass finds nothing left (the
           fenced primary can no longer append; a torn final frame is an
           element batch that was never durable, exactly the crash
           contract).  Injected/real ship failures are retried up to
           ``drain_attempts`` polls; if the tail still cannot be read,
           promote raises and the standby stays a standby (re-callable).
        3. **Flip** — adopt the journal (append mode, no seq-0 anchor) at
           the new epoch, reopen the session journal, and (by default)
           take a handoff checkpoint so the journal rotates and a new
           standby can re-follow from a short tail.

        Returns the promoted, now-journaling
        :class:`~reservoir_tpu_torch.serve.service.ReservoirService`.
        """
        if self._promoted:
            raise RuntimeError("this replica was already promoted")
        reg = _obs.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        with trace_span("reservoir_promote"):
            service = self._promote_steps(
                checkpoint=checkpoint,
                checkpoint_every=checkpoint_every,
                durability=durability,
                drain_attempts=drain_attempts,
            )
        if reg is not None:
            reg.histogram("ha.promote_s").observe(time.perf_counter() - t0)
        _obs.emit(
            "ha.promoted",
            site="ha.promote",
            epoch=self._bridge.epoch,
            flush_seq=self._applied_seq,
        )
        self._write_status()
        return service

    def _promote_steps(
        self,
        *,
        checkpoint: bool,
        checkpoint_every: Optional[int],
        durability: Optional[str],
        drain_attempts: int,
    ) -> ReservoirService:
        """The fence/drain/flip sequence (traced as ``reservoir_promote``)."""
        epoch = advance_epoch(self._dir)
        for _ in range(max(1, drain_attempts)):
            errs = self._metrics.ship_errors + self._metrics.apply_errors
            n = self.poll()
            clean = (
                self._metrics.ship_errors + self._metrics.apply_errors
                == errs
            )
            if n == 0 and clean and not self._pending_ops:
                break
        else:
            raise RuntimeError(
                f"promote: journal tail not drained after {drain_attempts} "
                f"polls (lag={self._metrics.lag_seq}); last error: "
                f"{self._last_error!r}"
            )
        info = self._bridge_info
        self._bridge._attach_journal(
            self._dir,
            checkpoint_every=(
                int(info.get("checkpoint_every", 64))
                if checkpoint_every is None
                else checkpoint_every
            ),
            durability=(
                info.get("durability", "buffered")
                if durability is None
                else durability
            ),
            epoch=epoch,
        )
        self._service._journal_fh = open(
            os.path.join(self._dir, _JOURNAL_NAME), "a", encoding="utf-8"
        )
        if checkpoint:
            # the durable handoff: a fresh checkpoint at the applied
            # watermark rotates the journal, so the fenced primary's tail
            # is settled and a re-following standby bootstraps instantly
            self._bridge._save_snapshot()
        self._promoted = True
        self._metrics.promotions += 1
        return self._service
