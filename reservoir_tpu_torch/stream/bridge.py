"""Host-to-device stream bridge: per-stream buffers, tile-granular flushes
(the port of the JAX package's ``stream/bridge.py``).

S logical streams buffer on the host into an ``[S, B]`` tile, which is
dispatched to a :class:`~reservoir_tpu_torch.engine.ReservoirEngine`
whenever any stream's row fills (ragged ``valid`` counts keep partly filled
rows exact).  The demux (:class:`~reservoir_tpu_torch.native.NativeStaging`)
scatters straight into the tile that is flushed.  On the card that tile is
pinned host memory, so a flush is the fill counts, one ``non_blocking``
copy to the card and the kernel's launch: no host copy of the tile.  The
tile is handed back to the demux only once its copy's CUDA event has
completed; nothing waits for the kernel.

With ``gated=True`` (duplicates mode, int32 counters) the skip gate of
:mod:`~reservoir_tpu_torch.stream.gate` decides, from a host replica of
every row's Algorithm-L chain, which elements can still win: only those
ship, coalesced into a small ``[S, gate_tile]`` candidate tile that
:meth:`~reservoir_tpu_torch.engine.ReservoirEngine.sample_gated` applies
with one ``algl_update_gated`` launch.  A row-contiguous :meth:`push` chunk
is gated before staging, so an elided element costs no demux, copy or
kernel lane; a staged (interleaved) tile is gated at its flush, and a tile
whose candidates overflow the gate tile (the fill phase) ships whole.
Reservoirs are bit-identical to the ungated bridge's.

The completion protocol: :meth:`DeviceStreamBridge.complete` (the future
succeeds with the per-stream samples), :meth:`~DeviceStreamBridge.fail`
(the future fails with the cause), and a drop-without-completion backstop
failing it with :class:`~reservoir_tpu_torch.errors.AbruptStreamTermination`.

Recovery: the flush worker retries
:class:`~reservoir_tpu_torch.errors.TransientDeviceError` under a
:class:`~reservoir_tpu_torch.errors.RetryPolicy`; ``flush_timeout_s`` arms a
per-attempt watchdog that fails the future with
:class:`~reservoir_tpu_torch.errors.FlushTimeout`; ``checkpoint_dir``
checkpoints the engine every ``checkpoint_every`` flushes and journals
every flushed tile and every row adoption
(:meth:`DeviceStreamBridge.adopt_rows`), and
:meth:`DeviceStreamBridge.recover` rebuilds the bridge bit-identically.
The journal (``journal.bin``), the checkpoint
(``engine.npz`` with its ``"bridge"`` metadata) and the epoch file are the
JAX package's formats, byte for byte: a checkpoint directory written by
either package's bridge recovers in the other.

One writer: wrap pushes in your own queue for multi-producer feeds.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import queue
import struct
import threading
import time
import weakref
import zlib
from concurrent.futures import Future
from typing import Any, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SamplerConfig
from ..engine import ReservoirEngine
from ..errors import (
    AbruptStreamTermination,
    CheckpointMismatch,
    FencedError,
    FlushTimeout,
    RetryPolicy,
    SamplerClosedError,
)
from ..native import NativeStaging
from ..obs import flight as _flight
from ..obs import registry as _obs
from ..obs import trace as _ctrace
from ..ops import autotune as _autotune
from ..utils import faults as _faults
from ..utils.checkpoint import load_engine, pack_rows, read_epoch, save_engine, unpack_rows
from ..utils.log import warn_once
from ..utils.metrics import BridgeMetrics
from ..utils.tracing import trace_span
from .gate import SkipGate, gate_ineligible_reason

__all__ = ["DeviceStreamBridge", "DeviceSampler"]

#: Every pipeline whose worker may still run: the interpreter's exit waits
#: for them (weakly held: a worker's own reference keeps its pipeline here
#: while it runs, and a collected pipeline has no worker left).
_LIVE_PIPELINES: "weakref.WeakSet[_FlushPipeline]" = weakref.WeakSet()


@atexit.register
def _join_pipelines_at_exit() -> None:
    """Let every flush worker finish before the interpreter finalizes.

    A worker is a daemon thread.  One that is still inside a flush's torch
    or C++ frames when the interpreter tears down is unwound by the
    runtime's forced thread exit, which aborts the process ("terminate
    called without an active exception") after its last line ran.  The
    hook runs before that teardown: it ends each worker's loop after the
    work already queued and joins it, bounded as :meth:`_FlushPipeline.close`
    is.  It settles no future: a stream that was not completed stays
    unfinished, and its bridge's backstop still fails it if collected.
    """
    for pipe in list(_LIVE_PIPELINES):
        pipe._stop()


class _FlushPipeline:
    """Depth-1 dispatch pipeline: one worker thread runs the device flushes
    while the caller demuxes the next tile.

    ``reserve`` blocks while the flush in flight still holds its host tile
    (one permit: the bridge demuxes into one tile while the worker has the
    other, the natural backpressure);
    ``join`` waits for the flushes in flight and re-raises a worker's
    exception on the caller's thread.  One producer, one worker: the engine
    keeps its single-writer contract because only the worker touches it
    between ``join`` barriers.  The worker releases a reservation only after
    its flush is done with the host tile, so the caller never demuxes into
    a tile that is still being read.

    The worker retries *transient* failures under ``retry_policy`` before
    surfacing them; ``watchdog_s`` arms a per-attempt timer that fails the
    owner's future with :class:`FlushTimeout` when a flush hangs (the
    pipeline then marks itself wedged and every later ``reserve``, ``join``
    and ``close`` raises instead of blocking); any terminal worker error is
    also routed to ``fail_cb`` at once, so the stream fails with its cause
    even if the producer never calls again.
    """

    def __init__(
        self,
        fn,
        retry_policy: Optional[RetryPolicy] = None,
        watchdog_s: Optional[float] = None,
        fail_cb=None,
        metrics: Optional[BridgeMetrics] = None,
    ) -> None:
        # weak methods: the worker must not keep the bridge alive, or the
        # abrupt-termination backstop in its __del__ could never fire
        self._fn = weakref.WeakMethod(fn)
        self._fail_cb = weakref.WeakMethod(fail_cb) if fail_cb is not None else None
        self._retry = retry_policy
        self._watchdog_s = watchdog_s
        self._metrics = metrics
        self._q: "queue.Queue" = queue.Queue()
        self._free = threading.Semaphore(1)
        self._error: Optional[BaseException] = None
        self._wedged = False
        self._inflight = False
        # completion counters instead of Queue.join, so the watchdog can
        # wake joiners that a hung worker would block forever
        self._cv = threading.Condition()
        self._submitted = 0
        self._done = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        _LIVE_PIPELINES.add(self)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._mark_done()
                return
            try:
                fn = self._fn()
                if fn is None:  # owner collected: discard remaining work
                    return
                with self._cv:
                    healthy = self._error is None and not self._wedged
                if healthy:
                    self._run_one(fn, item)
            except BaseException as e:  # surfaced at the next reserve/join...
                with self._cv:
                    if self._error is None:
                        self._error = e
                self._fatal(e)  # ...and on the future, now
            finally:
                # no strong reference to the owner may outlive the flush, or
                # a bridge dropped after a flush is never collected
                fn = None
                self._free.release()  # the host tile is free to demux into
                self._mark_done()

    def _run_one(self, fn, item) -> None:
        """One flush: watchdog-armed, transient failures retried."""
        attempt = 0
        while True:
            timer: Optional[threading.Timer] = None
            if self._watchdog_s is not None:
                timer = threading.Timer(self._watchdog_s, self._trip_watchdog)
                timer.daemon = True
            with self._cv:
                self._inflight = True
            if timer is not None:
                timer.start()
            try:
                fn(*item)
                return
            except BaseException as e:
                policy = self._retry
                with self._cv:
                    wedged = self._wedged
                if (
                    policy is not None
                    and not wedged
                    and policy.retryable(e)
                    and attempt < policy.max_retries
                ):
                    attempt += 1
                    if self._metrics is not None:
                        self._metrics.retries += 1
                    time.sleep(policy.backoff_s(attempt))
                    continue
                raise
            finally:
                with self._cv:
                    self._inflight = False
                if timer is not None:
                    timer.cancel()

    def _trip_watchdog(self) -> None:
        """Timer thread: the flush in flight blew its budget.  Fail fast on
        behalf of the (presumed wedged) worker."""
        with self._cv:
            if not self._inflight:
                return  # the flush completed in the arm/cancel gap
            exc = FlushTimeout(
                f"device flush exceeded the watchdog budget "
                f"({self._watchdog_s:g}s); worker presumed wedged"
            )
            self._wedged = True
            if self._error is None:
                self._error = exc
            if self._metrics is not None:
                self._metrics.watchdog_trips += 1
            self._cv.notify_all()
        self._fatal(exc)
        tr = _ctrace.get()
        if tr is not None:
            tr.point("bridge.watchdog_trip", budget_s=self._watchdog_s)
        fl = _flight.get()
        if fl is not None:
            fl.trigger("watchdog", budget_s=self._watchdog_s)

    def _fatal(self, exc: BaseException) -> None:
        """Terminal failure: fail the owner's future with the cause."""
        cb = self._fail_cb() if self._fail_cb is not None else None
        if cb is not None:
            cb(exc)

    def _mark_done(self) -> None:
        with self._cv:
            self._done += 1
            self._cv.notify_all()

    def _check(self) -> None:
        with self._cv:
            err, self._error = self._error, None
            wedged = self._wedged
        if err is not None:
            raise err
        if wedged:
            # the first caller got the original FlushTimeout above; the
            # pipeline stays unusable (its worker is stuck in the runtime)
            raise FlushTimeout("flush pipeline wedged past its watchdog")

    def reserve(self) -> None:
        """Block until a host tile is free to demux into.  Polls, so a
        watchdog trip unblocks a producer waiting on a permit the wedged
        worker will never release."""
        self._check()
        while not self._free.acquire(timeout=0.1):
            self._check()

    def would_block(self) -> bool:
        """True when a ``reserve()`` now would block; never blocks."""
        if self._free.acquire(blocking=False):
            self._free.release()
            return False
        return True

    def submit(self, *args) -> None:
        with self._cv:
            self._submitted += 1
        self._q.put(args)

    def join(self) -> None:
        with self._cv:
            while (
                self._done < self._submitted
                and self._error is None
                and not self._wedged
            ):
                self._cv.wait()
        self._check()

    def _stop(self) -> None:
        """End the worker's loop after the work queued so far and join it."""
        if self._thread.is_alive():
            self._q.put(None)
            with self._cv:
                self._submitted += 1  # the sentinel is counted when drained
                wedged = self._wedged
            # a wedged worker may never reach the sentinel; and the owner's
            # last reference may drop on the worker itself (its __del__
            # then closes from there): the sentinel ends the loop, and a
            # thread cannot join itself
            if threading.current_thread() is not self._thread:
                self._thread.join(timeout=1.0 if wedged else 30)
        if not self._thread.is_alive():
            _LIVE_PIPELINES.discard(self)

    def close(self) -> None:
        self._stop()
        # a completion barrier: an error of the final flush is re-raised
        # here (the bridge's __del__ routes it through fail() instead)
        self._check()


class _FlushJournal:
    """Append-only spill of the tiles flushed since the last checkpoint.

    Each record frames one flush: ``MAGIC | seq:u64 | payload_len:u32 |
    payload | crc32(payload):u32`` (``<4sQI`` header), the payload being the
    ``valid`` int32[S] counts, the ``[S, B]`` tile bytes and, for weighted
    bridges, the float32 weight tile.  Appends are flushed to the OS per
    record, so a process crash loses nothing journaled; an OS crash may
    cost the tail record, which :meth:`read_records` detects (short read or
    CRC mismatch, necessarily the last record) and ignores.  The journal is
    truncated after every checkpoint; ``seq`` lets recovery skip records a
    checkpoint already covers (a crash between the checkpoint's write and
    the truncation).

    A gated bridge writes gated frames (``RTJG``: candidate counts,
    per-row advance, a compacted ``[S, Bg]`` tile), which recovery
    replays through ``sample_gated``.  A row adoption writes an adopt
    frame (``RTJA``: the rows and their sub-state as an npz blob,
    :func:`_pack_adopt_payload`), which recovery replays through
    ``adopt_rows`` at its place between the flushes.

    ``fsync=True`` also fsyncs every frame (and the file and directory on
    truncation), closing the OS-crash window, at one fsync a flush counted
    through ``sync_cb``.
    """

    _MAGIC = b"RTJL"
    _MAGIC_GATED = b"RTJG"
    _MAGIC_ADOPT = b"RTJA"
    _HEADER = struct.Struct("<4sQI")

    #: yielded in the ``advance`` slot of :meth:`read_records` for an adopt
    #: frame (whose raw payload is then in the ``tile`` slot)
    ADOPT = "adopt"

    def __init__(
        self,
        path: str,
        num_streams: int,
        tile_width: int,
        dtype,
        weighted: bool,
        fsync: bool = False,
        sync_cb=None,
    ) -> None:
        self._path = path
        self._S = int(num_streams)
        self._B = int(tile_width)
        self._dtype = np.dtype(dtype)
        self._weighted = weighted
        self._fsync = bool(fsync)
        self._sync_cb = sync_cb
        self._fh = open(path, "ab")

    def _sync(self) -> None:
        reg = _obs.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        os.fsync(self._fh.fileno())
        if reg is not None:
            reg.histogram("bridge.journal_fsync_s").observe(time.perf_counter() - t0)
        if self._sync_cb is not None:
            self._sync_cb()

    def append(
        self,
        seq: int,
        tile: np.ndarray,
        valid: np.ndarray,
        wtile: Optional[np.ndarray],
    ) -> None:
        parts = [valid, tile] + ([wtile] if wtile is not None else [])
        self._append_frame(self._MAGIC, seq, [np.ascontiguousarray(p) for p in parts])

    def append_gated(
        self,
        seq: int,
        tile: np.ndarray,
        nvalid: np.ndarray,
        advance: np.ndarray,
    ) -> None:
        """One gated frame: candidate counts, per-row logical advance and
        the compacted ``[S, Bg]`` candidate tile."""
        parts = [nvalid, advance, tile]
        self._append_frame(self._MAGIC_GATED, seq, [np.ascontiguousarray(p) for p in parts])

    def append_adopt(self, seq: int, payload: bytes) -> None:
        """One adopt frame: the packed row adoption of
        :func:`_pack_adopt_payload`."""
        self._append_frame(self._MAGIC_ADOPT, seq, [np.frombuffer(payload, np.uint8)])

    def _append_frame(self, magic: bytes, seq: int, parts: List[np.ndarray]) -> None:
        """One frame, its payload written part by part from the arrays'
        own memory (no joined copy); the bytes are those of the payload
        joined."""
        crc = 0
        for p in parts:
            crc = zlib.crc32(p, crc)
        self._fh.write(self._HEADER.pack(magic, seq, sum(p.nbytes for p in parts)))
        for p in parts:
            self._fh.write(p)
        self._fh.write(struct.pack("<I", crc))
        self._fh.flush()
        if self._fsync:
            self._sync()

    def rotate(self) -> None:
        """Drop every record (a fresh checkpoint now covers them)."""
        self._fh.seek(0)
        self._fh.truncate()
        self._fh.flush()
        if self._fsync:
            self._sync()
            # the directory too: the truncation must not resurrect stale
            # records after a power crash once the checkpoint replaced them
            dir_fd = os.open(os.path.dirname(self._path) or ".", os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
            if self._sync_cb is not None:
                self._sync_cb()

    def close(self) -> None:
        self._fh.close()

    @classmethod
    def read_records(
        cls,
        path: str,
        num_streams: int,
        tile_width: int,
        dtype,
        weighted: bool,
        offset: int = 0,
    ) -> Iterator[Tuple[int, int, Any, Any, Optional[np.ndarray], Any]]:
        """Yield ``(end_offset, seq, tile, valid, wtile, advance)`` for
        every intact record from byte ``offset``, stopping at the first
        truncated or corrupt frame.  ``advance`` is None for a plain frame;
        for a gated frame it is the per-row int32 advance (``valid`` the
        candidate counts, ``tile`` the ``[S, Bg]`` candidates); for an adopt
        frame it is :data:`ADOPT` and ``tile`` holds the raw payload."""
        dtype = np.dtype(dtype)
        S, B = int(num_streams), int(tile_width)
        n_valid = S * 4
        n_tile = S * B * dtype.itemsize
        expect = n_valid + n_tile + (S * B * 4 if weighted else 0)
        try:
            fh = open(path, "rb")
        except FileNotFoundError:
            return
        with fh:
            fh.seek(offset)
            while True:
                head = fh.read(cls._HEADER.size)
                if len(head) < cls._HEADER.size:
                    return
                magic, seq, plen = cls._HEADER.unpack(head)
                if magic == cls._MAGIC:
                    if plen != expect:
                        return
                elif magic == cls._MAGIC_GATED:
                    # gated frames carry their own width: Bg from plen
                    rem = plen - 2 * n_valid
                    if rem < 0 or rem % (S * dtype.itemsize):
                        return
                elif magic != cls._MAGIC_ADOPT:
                    return
                payload = fh.read(plen)
                crc = fh.read(4)
                if len(payload) < plen or len(crc) < 4:
                    return
                if zlib.crc32(payload) != struct.unpack("<I", crc)[0]:
                    return
                if magic == cls._MAGIC_ADOPT:
                    yield fh.tell(), int(seq), payload, None, None, cls.ADOPT
                    continue
                if magic == cls._MAGIC_GATED:
                    bg = (plen - 2 * n_valid) // (S * dtype.itemsize)
                    nvalid = np.frombuffer(payload, np.int32, S).copy()
                    advance = np.frombuffer(payload, np.int32, S, n_valid).copy()
                    gtile = np.frombuffer(payload, dtype, S * bg, 2 * n_valid).reshape(S, bg).copy()
                    yield fh.tell(), int(seq), gtile, nvalid, None, advance
                    continue
                valid = np.frombuffer(payload, np.int32, S).copy()
                tile = np.frombuffer(payload, dtype, S * B, n_valid).reshape(S, B).copy()
                wtile = (
                    np.frombuffer(payload, np.float32, S * B, n_valid + n_tile).reshape(S, B).copy()
                    if weighted
                    else None
                )
                yield fh.tell(), int(seq), tile, valid, wtile, None

    @classmethod
    def replay(
        cls, path: str, num_streams: int, tile_width: int, dtype, weighted: bool
    ) -> Iterator[Tuple[int, Any, Any, Optional[np.ndarray], Any]]:
        """Yield ``(seq, tile, valid, wtile, advance)`` for every intact
        record, stopping at the first truncated or corrupt one."""
        for _, seq, tile, valid, wtile, advance in cls.read_records(
            path, num_streams, tile_width, dtype, weighted
        ):
            yield seq, tile, valid, wtile, advance


def _pack_adopt_payload(rows: Any, sub_state: Any) -> bytes:
    """One row adoption (the row indices and the packed sub-state) as the
    self-describing npz blob of an ``RTJA`` frame, in the JAX package's
    form: its reader unpacks what the port writes, and the other way
    round."""
    arrays, manifest = pack_rows(sub_state)
    bio = io.BytesIO()
    np.savez(
        bio,
        __rows__=np.ascontiguousarray(rows, np.int32),
        __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
        **arrays,
    )
    return bio.getvalue()


def _unpack_adopt_payload(payload: bytes) -> Tuple[np.ndarray, Any]:
    """Inverse of :func:`_pack_adopt_payload`: ``(rows, sub_state)``, the
    sub-state on the CPU."""
    with np.load(io.BytesIO(payload)) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        rows = np.ascontiguousarray(data["__rows__"], np.int32)
        arrays = {k: data[k] for k in data.files if k not in ("__rows__", "__manifest__")}
    return rows, unpack_rows(arrays, manifest)


class DeviceStreamBridge:
    """S independent logical streams feeding S reservoirs in lockstep.

    Stream ``s`` owns reservoir row ``s``; elements pushed for it buffer
    into row ``s`` of a host ``[S, B]`` staging tile.  When any row reaches
    the tile width, the whole tile flushes with per-row ``valid`` counts.
    State between flushes lives only on the engine's device.

    Args:
      config: engine config; ``num_reservoirs`` is the stream count.
      key: seed or key words of the engine.
      map_fn / hash_fn: the engine's hooks (elementwise functions on torch
        tensors, :mod:`~reservoir_tpu_torch.ops.hooks`), forwarded to it,
        gated or not; pushed elements are of the config's element dtype.
      reusable: reusable bridges allow :meth:`complete` followed by more
        pushes (snapshot semantics).
      mesh: with ``config.mesh_axis``, the ranks the engine's reservoirs
        shard over (:class:`~reservoir_tpu_torch.parallel.sharded.Mesh`;
        default every visible card); each flush snapshots the host tile
        once and copies each rank's rows to its card.  The staging tiles
        are then numpy arrays, and ``gated=True`` is inert.  Not with
        ``device``; a mesh that spans processes raises
        ``NotImplementedError`` naming L4.
      pipelined: overlap the host demux with the flush — the demux fills
        one tile while the other's copy and dispatch run on a worker thread
        (default on).  ``False`` flushes synchronously from one tile.
      retry_policy: backoff for *transient* flush failures on the pipelined
        worker; defaults to ``RetryPolicy()``.
      flush_timeout_s: per-flush watchdog budget (pipelined bridges);
        ``None`` (default) disables the watchdog.
      checkpoint_dir: directory for crash recovery: the engine is
        checkpointed there every ``checkpoint_every`` flushes
        (``engine.npz``) and every flushed tile is journaled
        (``journal.bin``); :meth:`recover` rebuilds the bridge.
      checkpoint_every: auto-checkpoint cadence in flushes (default 64).
      durability: ``"buffered"`` (default: each frame flushed to the OS) or
        ``"fsync"`` (each frame fsynced; counted in
        ``metrics.journal_syncs``).
      faults: a :class:`~reservoir_tpu_torch.utils.faults.FaultPlane` for
        the ``bridge.*`` sites of this bridge and the ``engine.update`` site
        of its engine; ``None`` defers to the globally installed plane.
      gated: the ingest-side skip gate (default off).  A host replica of
        every row's Algorithm-L chain (:mod:`~reservoir_tpu_torch.stream.gate`)
        names the elements of each chunk that can still win; only those
        (fill prefixes and acceptances) are compacted into a small
        ``[S, gate_tile]`` tile, journaled and dispatched, with reservoirs
        bit-identical to the ungated path.  Active in duplicates mode with
        int32 counters; in weighted and distinct mode the flag is inert
        (same results, no elision; :attr:`gate_inert_reason` says why).
        A chunk whose candidates overflow ``gate_tile`` (the fill phase,
        mostly) ships ungated, still bit-exact.
      gate_tile: the candidate tile's width ``Bg`` (default 64): a row
        ships at most this many candidates a gated dispatch; candidates
        coalesce across flushes until a row's buffer fills or a barrier
        (:meth:`flush`, :meth:`complete`) forces the dispatch.  ``0``
        takes the autotune cache's ``gate`` entry for this shape and card
        (:mod:`~reservoir_tpu_torch.ops.autotune`), else 64, as the
        reference does.
      gate_push_chunk: the slice width of the pre-staging push path
        (default 1 Mi elements; ``0`` reads the cache as above, else 1 Mi): a
        row-contiguous :meth:`push` chunk is gated in slices of this many
        elements, one replica evaluation a slice, its candidates gathered
        straight from the producer's array; a slice whose candidates
        exceed ``gate_tile`` goes through the staged path.
      device: the engine's device; ``None`` means ``"cuda"`` and raises
        without a card.  On the card the staging tiles are pinned host
        memory; with ``"cpu"`` they are numpy arrays and the plain versions
        run.
      native: ``True`` (default) demuxes in the C++ staging library and
        runs the skip gate's replica in its C++ library, each built with
        ``g++`` at first use and raising if it cannot be; ``False`` demuxes
        in numpy and runs the replica as the plain torch chain, with the
        same results.
    """

    def __init__(
        self,
        config: SamplerConfig,
        key: Union[int, Any, None] = None,
        map_fn: Optional[Any] = None,
        hash_fn: Optional[Any] = None,
        reusable: bool = False,
        mesh: Optional[Any] = None,
        pipelined: bool = True,
        *,
        retry_policy: Optional[RetryPolicy] = None,
        flush_timeout_s: Optional[float] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 64,
        durability: str = "buffered",
        faults: Optional[Any] = None,
        gated: bool = False,
        gate_tile: int = 64,
        gate_push_chunk: int = 1 << 20,
        device: Optional[Any] = None,
        native: bool = True,
        _engine: Optional[ReservoirEngine] = None,
    ) -> None:
        if durability not in ("buffered", "fsync"):
            raise ValueError(f"durability must be 'buffered' or 'fsync', got {durability!r}")
        if mesh is not None and mesh.multiprocess:
            from ..parallel.sharded import not_ported

            raise not_ported("the stream bridge")
        self._config = config
        self._faults = faults
        self._engine = _engine if _engine is not None else ReservoirEngine(
            config, key=key, reusable=reusable, device=device, mesh=mesh, map_fn=map_fn,
            hash_fn=hash_fn, faults=faults,
        )
        self._reusable = reusable
        S, B = config.num_reservoirs, config.tile_size
        dtype = np.dtype(config.element_dtype)
        self._staging = NativeStaging(S, B, dtype, weighted=config.weighted, native=native)
        n_bufs = 2 if pipelined else 1
        dev = self._engine.device
        # a meshed engine (no one device) takes host tiles, which it
        # snapshots and ships to each rank's card itself
        self._cuda = dev is not None and dev.type == "cuda"
        # every engine call of the bridge runs on the stream current at
        # construction, from whichever thread makes it, so the worker's
        # kernels, push_tile's and the result's reads stay in order
        self._stream = torch.cuda.current_stream(dev) if self._cuda else None
        if self._cuda:
            # pinned host tiles: a flush is one non_blocking copy of the
            # tile the demux filled (the bytes, viewed as the element dtype
            # on either side, so every dtype takes the same path)
            self._pinned = [
                torch.zeros(S * B * dtype.itemsize, dtype=torch.uint8, pin_memory=True)
                for _ in range(n_bufs)
            ]
            self._tiles = [p.numpy().view(dtype).reshape(S, B) for p in self._pinned]
            self._wpinned = (
                [torch.ones((S, B), dtype=torch.float32, pin_memory=True) for _ in range(n_bufs)]
                if config.weighted
                else None
            )
            self._wtiles = [w.numpy() for w in self._wpinned] if config.weighted else None
        else:
            self._tiles = [np.zeros((S, B), dtype) for _ in range(n_bufs)]
            # numpy's large zeros are mapped lazily: write one byte a page
            # now, or the first demux page-faults its way through the tile
            # (np.ones writes every weight already)
            for t in self._tiles:
                t.reshape(-1).view(np.uint8)[::4096] = 0
            self._wtiles = (
                [np.ones((S, B), np.float32) for _ in range(n_bufs)]
                if config.weighted
                else None
            )
        self._valids = [np.zeros(S, np.int32) for _ in range(n_bufs)]
        self._buf = 0
        # the demux scatters straight into the active flush tile: a flush
        # reads the fill counts and swaps the demux onto the other tile
        self._staging.attach(self._tiles[0], self._wtiles[0] if self._wtiles is not None else None)
        # the skip gate: built only when asked for and eligible.  0 reads
        # the autotune cache's gate entry for this shape, with the untuned
        # defaults as fallback, as the reference does
        if gate_tile == 0 or gate_push_chunk == 0:
            geo = self._gate_geometry(B, dtype)
            if gate_tile == 0:
                gate_tile = geo.gate_tile if geo is not None and geo.gate_tile else 64
            if gate_push_chunk == 0:
                gate_push_chunk = geo.gate_push_chunk if geo is not None and geo.gate_push_chunk else 1 << 20
        self._gate: Optional[SkipGate] = None
        self._gate_reason: Optional[str] = None
        if gated:
            self._gate_reason = gate_ineligible_reason(config)
            if self._gate_reason is None:
                self._gate = SkipGate(S, config.max_sample_size, B, dtype, cap=gate_tile,
                                      native=native)
        self._gate_tile = int(gate_tile)
        self._gate_push_chunk = max(1, int(gate_push_chunk))
        self._gated_requested = bool(gated)
        self._future: Future = Future()
        self._metrics = BridgeMetrics()
        self._metrics.demux_threads = self._staging.threads()
        self._retry_policy = retry_policy if retry_policy is not None else RetryPolicy()
        # reserve() guarantees the tile attached next is no longer read by
        # the worker
        self._pipeline = (
            _FlushPipeline(
                self._dispatch_flush,
                retry_policy=self._retry_policy,
                watchdog_s=flush_timeout_s,
                fail_cb=self.fail,
                metrics=self._metrics,
            )
            if pipelined
            else None
        )
        # ------------------------------------------- crash recovery plane
        self._flush_seq = 0  # flushes journaled/checkpointed so far
        self._journal: Optional[_FlushJournal] = None
        self._ckpt_failed_logged = False
        # fencing: the bridge is admitted at the epoch persisted in the
        # checkpoint dir at construction; a later bump (a promotion
        # elsewhere) fences every later flush and checkpoint
        self._fence_cache: Tuple[Optional[Tuple[int, int]], int] = (None, 0)
        if checkpoint_dir is not None:
            self._attach_journal(checkpoint_dir, checkpoint_every=checkpoint_every,
                                 durability=durability)
            if _engine is None:
                # seq-0 anchor: recovery is possible from the first flush,
                # even if every later checkpoint write fails
                self._save_snapshot()
        else:
            self._ckpt_dir: Optional[str] = None
            self._ckpt_every = max(1, int(checkpoint_every))
            self._durability = durability
            self._epoch = 0

    def _gate_geometry(self, width: int, dtype) -> Optional[Any]:
        """The tuned gate geometry for this shape from the autotune cache
        (``kernel="gate"``, which ``tools/block_sweep.py --kernel gate``
        records), keyed on the engine's device, or ``None``: the bridge then
        keeps the untuned defaults."""
        return _autotune.lookup(_autotune.device_kind(self._engine._ranks[0]), self._config.num_reservoirs,
                                self._config.max_sample_size, width, dtype, kernel="gate")

    # ------------------------------------------------------------ properties

    @property
    def num_streams(self) -> int:
        return self._config.num_reservoirs

    @property
    def engine(self) -> ReservoirEngine:
        """The bridge's engine.  Readers share the bridge's single-writer
        contract: call :meth:`drain_barrier` before touching engine state
        while a pipelined flush may be in flight."""
        return self._engine

    @property
    def device(self) -> torch.device:
        """The engine's device."""
        return self._engine.device

    @property
    def sample(self) -> Future:
        """Future of the per-stream samples (a list of ``S`` arrays),
        completed by the tri-state protocol."""
        return self._future

    @property
    def metrics(self) -> BridgeMetrics:
        return self._metrics

    @property
    def gate_active(self) -> bool:
        """Whether the skip gate is live (``gated=True`` and the config is
        eligible; see :attr:`gate_inert_reason`)."""
        return self._gate is not None

    @property
    def gate_inert_reason(self) -> Optional[str]:
        """Why a requested gate is inert (None when active or never
        requested): weighted and distinct configs take the ungated path
        with the same results."""
        return self._gate_reason

    @property
    def gate_push_chunk(self) -> int:
        """Live slice width of the gated push path (see
        :meth:`set_gate_push_chunk`)."""
        return self._gate_push_chunk

    def set_gate_push_chunk(self, n: int) -> None:
        """Retune the gated push slice width of a live bridge, from the
        next push; a field of every bridge, used by gated ones."""
        self._gate_push_chunk = max(1, int(n))

    @property
    def checkpoint_every(self) -> int:
        """Live auto-checkpoint cadence in flushes."""
        return self._ckpt_every

    def set_checkpoint_every(self, n: int) -> None:
        """Retune the auto-checkpoint cadence of a live bridge, from the
        next flush.  Every flush is journaled regardless; the cadence sets
        how far recovery replays."""
        self._ckpt_every = max(1, int(n))

    @property
    def is_open(self) -> bool:
        return self._engine.is_open and not self._future.done()

    def _check_open(self) -> None:
        if self._future.done():
            raise SamplerClosedError("this bridge has completed or failed")
        self._engine._check_open()

    # --------------------------------------------------------------- pushing

    def push(self, stream: int, elements: Any, weights: Optional[Any] = None) -> None:
        """Buffer one element or a 1-D chunk for logical stream ``stream``;
        flushes whenever the stream's row fills.  Errors name the stream."""
        self._check_open()
        _faults.fire("bridge.demux", self._faults)
        self._metrics.start()
        if not 0 <= int(stream) < self.num_streams:
            raise ValueError(f"stream {int(stream)} out of range [0, {self.num_streams})")
        try:
            arr = np.atleast_1d(np.asarray(elements, self._tiles[0].dtype))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"stream {int(stream)}: elements not convertible to {self._tiles[0].dtype}: {e}"
            ) from None
        warr = self._check_weights(arr, weights, stream=int(stream))
        n = arr.shape[0]
        if self._gate is not None and warr is None:
            # the pre-staging path: a row-contiguous chunk is gated before
            # any staging copy, so an elided element costs no demux byte
            self._gate_push(int(stream), arr)
            self._metrics.elements += n
            return
        off = 0
        while off < n:
            t0 = time.perf_counter()
            took = self._staging.push_chunk(
                stream, arr[off:], warr[off:] if warr is not None else None
            )
            self._metrics.demux_s += time.perf_counter() - t0
            off += took
            if off < n or self._staging.row_full(stream):
                # an internal row-full flush: a gated bridge may coalesce it
                # into the candidate buffer; flush() and complete() force
                # the dispatch
                self._flush_staging()
        self._metrics.elements += n

    def push_interleaved(self, streams: Any, elements: Any, weights: Optional[Any] = None) -> None:
        """Demux an interleaved feed of ``(stream_id, element)`` pairs,
        flushing whenever a row fills mid-batch."""
        self._check_open()
        _faults.fire("bridge.demux", self._faults)
        self._metrics.start()
        # converted up front so the resume loop's slices stay views; shape
        # and range checks belong to NativeStaging
        streams = np.ascontiguousarray(streams, np.int32)
        arr = np.ascontiguousarray(elements, self._tiles[0].dtype)
        warr = self._check_weights(arr, weights)
        off = 0
        n = arr.shape[0]
        while off < n:
            t0 = time.perf_counter()
            # a named range, so a profile shows the demux beside the copies
            with trace_span("reservoir_bridge_demux"):
                took = self._staging.push_interleaved(
                    streams[off:], arr[off:], warr[off:] if warr is not None else None
                )
            self._metrics.demux_s += time.perf_counter() - t0
            off += took
            if off < n:
                self._flush_staging()
        self._metrics.elements += n

    def _check_weights(self, arr, weights, stream: Optional[int] = None):
        where = "" if stream is None else f"stream {stream}: "
        if self._wtiles is not None:
            if weights is None:
                raise ValueError(f"{where}weighted bridge requires weights")
            warr = np.atleast_1d(np.ascontiguousarray(weights, np.float32))
            if warr.shape != arr.shape:
                raise ValueError(
                    f"{where}weights must match elements shape {arr.shape}, got {warr.shape}"
                )
            if not np.all(warr >= 0):
                bad = int(np.argmax(~(warr >= 0)))
                raise ValueError(f"{where}weights must be nonnegative (weights[{bad}] = {warr[bad]})")
            return warr
        if weights is not None:
            raise ValueError(f"{where}weights are only meaningful with weighted=True")
        return None

    def push_tile(self, tile: Any, valid: Optional[Any] = None, weights: Optional[Any] = None) -> None:
        """Dispatch a caller-owned ``[S, B]`` host tile straight to the
        engine, bypassing the staging (the engine snapshots it, so the
        caller may reuse its array at once)."""
        self._check_open()
        self._check_fence()
        self._metrics.start()
        if self._gate is not None:
            # a tile of the caller's bypasses the gate: ship the coalesced
            # candidates first (stream order), then mark the replica stale;
            # it pulls the engine's state before the next gated eval
            self._dispatch_gated_pending()
            self._gate.mark_dirty()
        self._join()  # the engine is single-writer: wait out the worker
        tile = np.asarray(tile)
        if self._journal is not None:
            # replay re-applies the exact bytes: a dtype the staging tiles
            # do not carry could not round-trip
            if tile.dtype != self._tiles[0].dtype:
                raise ValueError(
                    f"an auto-checkpointing bridge requires push_tile tiles of the "
                    f"configured element dtype {self._tiles[0].dtype}, got {tile.dtype}"
                )
            valid_arr = (
                np.full(tile.shape[0], tile.shape[1], np.int32)
                if valid is None
                else np.ascontiguousarray(valid, np.int32)
            )
            wtile_arr = np.ascontiguousarray(weights, np.float32) if self._wtiles is not None else None
            self._flush_seq += 1
            self._journal_append(self._flush_seq, np.ascontiguousarray(tile), valid_arr, wtile_arr)
            # the live call takes the journaled form (explicit valid
            # counts), so replay runs the same engine path
            valid = valid_arr
        with trace_span("reservoir_bridge_flush"), self._on_stream():
            self._engine.sample(tile, valid=valid, weights=weights)
        n = int(tile.shape[1]) * tile.shape[0] if valid is None else int(np.sum(np.asarray(valid)))
        self._metrics.elements += n
        self._metrics.flushed_elements += n
        self._metrics.flushes += 1
        self._maybe_checkpoint()

    def adopt_rows(self, rows: Any, sub_state: Any) -> None:
        """Adopt exported rows into this bridge's engine: the destination
        half of a live migration.

        ``sub_state`` is what a source engine's
        :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.export_rows`
        returned, on any device.  The adopt is fence-checked, runs in the
        single-writer slot (a gated bridge's buffered candidates dispatch
        first, the flush in flight drains), takes one flush sequence number
        and, on a journaling bridge, is journaled as one ``RTJA`` frame
        before the engine is touched, so :meth:`recover` replays it at its
        place between the flushes.  Rows and the sub-state's shape are
        checked before any of that, so a refused adopt leaves no frame (the
        JAX package journals first and fails at the engine).
        """
        self._check_open()
        self._engine._validate_adopt(rows, sub_state)
        self._check_fence()
        if self._gate is not None:
            # stream order: the gate's buffered candidates precede the
            # adopt, and its replica re-pulls the adopted rows
            self._dispatch_gated_pending()
            self._gate.mark_dirty()
        self.drain_barrier()
        self._flush_seq += 1
        if self._journal is not None:
            reg = _obs.get()
            t0 = time.perf_counter() if reg is not None else 0.0
            with trace_span("reservoir_journal_append"):
                self._journal.append_adopt(self._flush_seq, _pack_adopt_payload(rows, sub_state))
            if reg is not None:
                reg.histogram("bridge.journal_append_s").observe(time.perf_counter() - t0)
        with trace_span("reservoir_bridge_adopt"), self._on_stream():
            self._engine.adopt_rows(rows, sub_state)
        self._metrics.flushes += 1
        self._maybe_checkpoint()

    def _dispatch_flush(self, i: Optional[int], gated: Optional[tuple] = None) -> None:
        """The device half of the flush of host tile ``i`` (the worker
        thread when pipelined), or with ``gated = (tile, nvalid, advance)``
        of the gate's candidate tile, through
        :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.sample_gated`
        (which snapshots it into a pinned buffer of its own).

        The ``bridge.dispatch`` fault site fires before the engine update:
        a transient failure is retried by the worker and, since engine
        state advances only on a successful update, the stream completes
        bit-identical to a clean run.

        On the card the pinned tile is copied with ``non_blocking`` and the
        kernel queued behind it on the engine's stream; this returns (and
        the host tile goes back to the demux) once the copy's event has
        completed, whatever the kernel is doing.
        """
        _faults.fire("bridge.dispatch", self._faults)
        t0 = time.perf_counter()
        tr = _ctrace.get()
        cm = (
            tr.span("bridge.dispatch", key=self._flush_seq, flush_seq=self._flush_seq,
                    gated=gated is not None)
            if tr is not None
            else contextlib.nullcontext()
        )
        if gated is not None:
            nbytes = gated[0].nbytes
        else:
            valid = self._valids[i]
            nbytes = self._tiles[i].nbytes + (self._wtiles[i].nbytes if self._wtiles is not None else 0)
        with cm, trace_span("reservoir_bridge_flush"):
            if gated is not None:
                with self._on_stream():
                    self._engine.sample_gated(*gated)
            elif self._cuda:
                self._copy_and_sample(i, valid)
            else:
                # slots past each row's valid count hold stale elements and
                # (nonnegative) weights; valid keeps them out of sampling
                self._engine.sample(
                    self._tiles[i], valid=valid,
                    weights=self._wtiles[i] if self._wtiles is not None else None,
                )
        dt = time.perf_counter() - t0
        self._metrics.dispatch_s += dt
        reg = _obs.get()
        if reg is not None:
            reg.histogram("bridge.flush_s").observe(dt)
            reg.histogram("bridge.flush_bytes", lo=1.0, hi=1e12).observe(nbytes)

    def _copy_and_sample(self, i: int, valid: np.ndarray) -> None:
        dev = self._engine.device
        S, B = self._tiles[i].shape
        stream = self._stream
        with torch.cuda.stream(stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            copied = False
            try:
                # the demux's bytes are elements: a map may give the
                # samples another dtype
                tile = self._pinned[i].to(dev, non_blocking=True).view(self._engine._elem_dtype).view(S, B)
                weights = (
                    self._wpinned[i].to(dev, non_blocking=True)
                    if self._wpinned is not None
                    else None
                )
                done.record(stream)
                copied = True
                self._engine.sample(tile, valid=valid, weights=weights)
            finally:
                # the demux may write the host tile again only once the
                # copy has read it: wait on the copy, never on the kernel
                # (and on the whole stream if a copy failed part way)
                if copied:
                    done.synchronize()
                else:
                    stream.synchronize()
            self._metrics.copy_s += start.elapsed_time(done) / 1e3

    def flush(self) -> None:
        """Dispatch the buffered elements (a ragged tile): the public
        visibility barrier.  After it (and :meth:`drain_barrier`) every
        pushed element has been applied, a gated bridge's coalesced
        candidates included."""
        self._flush_staging()
        if self._gate is not None:
            self._dispatch_gated_pending()

    def _flush_staging(self) -> None:
        # fence before the fill counts are taken or the journal appended:
        # a fenced primary fails with nothing mutated
        self._check_fence()
        i = self._buf
        valid = self._valids[i]
        t0 = time.perf_counter()
        total = self._staging.take(valid)
        self._metrics.drain_s += time.perf_counter() - t0
        if total == 0:
            return
        if self._gate is not None and self._gate_flush(self._tiles[i], valid):
            # the gate took the tile's candidates (and may have dispatched):
            # the gather consumed the tile, so the demux goes on into it
            return
        # journal before handing the tile to the worker: the producer still
        # owns it, and a dispatch that later fails was still journaled, so
        # recover() replays it
        self._flush_seq += 1
        if self._journal is not None:
            self._journal_append(
                self._flush_seq, self._tiles[i], valid,
                self._wtiles[i] if self._wtiles is not None else None,
            )
        if self._pipeline is not None:
            # wait until the other tile's flight has released it, then
            # swap the demux onto it
            tr = _ctrace.get()
            qcm = (
                tr.span("bridge.queue", key=self._flush_seq, flush_seq=self._flush_seq)
                if tr is not None
                else contextlib.nullcontext()
            )
            t0 = time.perf_counter()
            with qcm:
                self._pipeline.reserve()
            self._metrics.reserve_s += time.perf_counter() - t0
            self._pipeline.submit(i)
            self._buf = 1 - i
            self._staging.attach(
                self._tiles[self._buf],
                self._wtiles[self._buf] if self._wtiles is not None else None,
            )
        else:
            self._dispatch_flush(i)
        self._metrics.flushes += 1
        self._metrics.flushed_elements += total
        self._maybe_checkpoint()

    # ------------------------------------------------------- skip-ahead gate

    def _gate_push(self, stream: int, arr: np.ndarray) -> None:
        """Gate a row-contiguous pushed chunk before staging.

        The chunk is evaluated in ``gate_push_chunk``-element slices: one
        replica evaluation of the row decides each slice's candidates,
        which are gathered straight from the producer's array into the
        coalescing buffer; elided elements are never demuxed, staged,
        journaled or copied.  A slice with more candidates than the gate
        tile (the fill phase, early in a stream) goes through the staged
        path, whose flushes evaluate again tile by tile; the row stays in
        order because the fast path runs only while its staging is empty."""
        gate = self._gate
        if gate.stale(self._engine):
            self.drain_barrier()
            gate.resync(self._engine)
        m = self._metrics
        n = int(arr.shape[0])
        off = 0
        while off < n:
            if self._staging.fill(stream):
                # staged residue (a fallback slice's partial row): keep
                # this slice on the staged path so the row stays ordered
                off += self._push_staged(stream, arr[off:])
                continue
            self._check_fence()
            take = min(n - off, self._gate_push_chunk)
            chunk = arr[off : off + take]
            reg = _obs.get()
            tr = _ctrace.get()
            gcm = tr.span("gate.eval", stream=stream) if tr is not None else contextlib.nullcontext()
            t0 = time.perf_counter()
            with gcm, trace_span("reservoir_gate_eval"):
                ev = gate.evaluate_row(stream, take)
            dt = time.perf_counter() - t0
            m.gate_eval_s += dt
            if reg is not None:
                reg.histogram("gate.eval_s").observe(dt)
            if ev.fallback:
                # candidate-dense slice, not committed: the staged flushes
                # walk the chain again in tile pieces and commit
                off += self._push_staged(stream, chunk)
                continue
            if not gate.fits_row(stream, ev):
                self._dispatch_gated_pending()
            gate.commit(ev)
            elided = gate.append_row(stream, chunk, ev)
            m.gate_buffered_flushes += 1
            m.gate_bytes_elided += elided * arr.itemsize
            if reg is not None:
                reg.counter("gate.bytes_elided").inc(elided * arr.itemsize)
            if gate.advance_high():
                self._dispatch_gated_pending()
            off += take

    def _push_staged(self, stream: int, arr: np.ndarray) -> int:
        """One staged step of a single-row push: stage what fits, flush on
        a full row; returns the elements consumed."""
        t0 = time.perf_counter()
        took = self._staging.push_chunk(stream, arr, None)
        self._metrics.demux_s += time.perf_counter() - t0
        if took < arr.shape[0] or self._staging.row_full(stream):
            self._flush_staging()
        return took

    def _gate_flush(self, tile: np.ndarray, valid: np.ndarray) -> bool:
        """Gate one staged tile.  True when the gate took it whole
        (candidates buffered, perhaps a gated dispatch); False when the
        caller must ship this tile ungated (its candidates overflow the
        gate tile: the fill phase, mostly).  Either way the replica has
        advanced over it, so a fallback tile stays bit-consistent."""
        gate = self._gate
        if gate.stale(self._engine):
            # the engine changed outside the gated path (recovery replay,
            # push_tile): pull the replica under the single-writer slot.
            # Every such path dispatches the pending buffer first, so
            # resync() refusing a pending buffer marks a contract breach
            self.drain_barrier()
            gate.resync(self._engine)
        m = self._metrics
        reg = _obs.get()
        tr = _ctrace.get()
        gcm = tr.span("gate.eval") if tr is not None else contextlib.nullcontext()
        t0 = time.perf_counter()
        with gcm, trace_span("reservoir_gate_eval"):
            ev = gate.evaluate(valid)
        dt = time.perf_counter() - t0
        m.gate_eval_s += dt
        if reg is not None:
            reg.histogram("gate.eval_s").observe(dt)
        # both branches consume the tile at this granularity (buffered
        # gated or shipped whole), so the replica advances either way
        gate.commit(ev)
        if ev.fallback:
            # ship the tile whole, but dispatch the buffered advance first
            # (stream order)
            self._dispatch_gated_pending()
            shipped = int(np.asarray(valid).sum()) * tile.itemsize
            m.gate_bytes_shipped += shipped
            if reg is not None:
                reg.counter("gate.bytes_shipped").inc(shipped)
                self._observe_skip_frac(reg)
            return False
        if not gate.fits(ev):
            self._dispatch_gated_pending()
        elided = gate.append(tile, valid, ev)
        m.gate_buffered_flushes += 1
        m.gate_bytes_elided += elided * tile.itemsize
        if reg is not None:
            reg.counter("gate.bytes_elided").inc(elided * tile.itemsize)
        if gate.advance_high():
            self._dispatch_gated_pending()
        return True

    def _dispatch_gated_pending(self) -> None:
        """Dispatch the gate's coalesced candidates as one gated flush
        (journaled like any other flush; replay goes through
        ``sample_gated``).  Nothing when the buffer is empty."""
        gate = self._gate
        if gate is None or not gate.pending():
            return
        self._check_fence()
        gtile, nvalid, advance, total_adv = gate.take()
        self._flush_seq += 1
        tr = _ctrace.get()
        if self._journal is not None:
            reg = _obs.get()
            t0 = time.perf_counter() if reg is not None else 0.0
            jcm = (tr.span("bridge.journal", key=self._flush_seq, flush_seq=self._flush_seq)
                   if tr is not None else contextlib.nullcontext())
            with jcm, trace_span("reservoir_journal_append"):
                self._journal.append_gated(self._flush_seq, gtile, nvalid, advance)
            if reg is not None:
                reg.histogram("bridge.journal_append_s").observe(time.perf_counter() - t0)
        if self._pipeline is not None:
            qcm = (tr.span("bridge.queue", key=self._flush_seq, flush_seq=self._flush_seq)
                   if tr is not None else contextlib.nullcontext())
            t0 = time.perf_counter()
            with qcm:
                self._pipeline.reserve()
            self._metrics.reserve_s += time.perf_counter() - t0
            self._pipeline.submit(None, (gtile, nvalid, advance))
        else:
            self._dispatch_flush(None, (gtile, nvalid, advance))
        m = self._metrics
        m.flushes += 1
        m.gated_dispatches += 1
        # the folded advance is durable from here (the journal, when on,
        # covers these elements), so they count as flushed
        m.flushed_elements += total_adv
        shipped = gtile.nbytes + nvalid.nbytes + advance.nbytes
        m.gate_bytes_shipped += shipped
        reg = _obs.get()
        if reg is not None:
            reg.counter("gate.bytes_shipped").inc(shipped)
            self._observe_skip_frac(reg)
        self._maybe_checkpoint()

    def _observe_skip_frac(self, reg) -> None:
        m = self._metrics
        denom = m.gate_bytes_shipped + m.gate_bytes_elided
        if denom:
            reg.gauge("gate.skip_frac").set(m.gate_bytes_elided / denom)

    def _journal_append(self, seq, tile, valid, wtile) -> None:
        """Journal one flushed tile, traced and, with telemetry on, timed
        into ``bridge.journal_append_s``."""
        reg = _obs.get()
        tr = _ctrace.get()
        t0 = time.perf_counter() if reg is not None else 0.0
        jcm = tr.span("bridge.journal", key=seq, flush_seq=seq) if tr is not None else contextlib.nullcontext()
        with jcm, trace_span("reservoir_journal_append"):
            self._journal.append(seq, tile, valid, wtile)
        if reg is not None:
            reg.histogram("bridge.journal_append_s").observe(time.perf_counter() - t0)

    def _join(self) -> None:
        if self._pipeline is not None:
            self._pipeline.join()

    def _on_stream(self):
        """The bridge's stream as the current one (on the card)."""
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def drain_barrier(self) -> None:
        """Wait for the flush in flight (re-raising its error) and, on the
        card, for the bridge's stream (a meshed engine's: each card's): the
        state is then final."""
        self._join()
        if self._cuda:
            self._stream.synchronize()
        else:
            self._engine._synchronize()

    def flush_would_block(self) -> bool:
        """True when a :meth:`flush` now would wait for the pipeline (no
        free host tile); never blocks.  Always False when not pipelined."""
        return self._pipeline is not None and self._pipeline.would_block()

    # -------------------------------------------------------- crash recovery

    @property
    def flushed_seq(self) -> int:
        """Durable flush watermark: every flush numbered ``<= flushed_seq``
        is covered by the checkpoint and journal and survives a crash.
        Producers resume pushing from here after :meth:`recover`."""
        return self._flush_seq

    @property
    def epoch(self) -> int:
        """The primary epoch this bridge was admitted at (0 when it does not
        checkpoint)."""
        return self._epoch

    def _count_journal_sync(self) -> None:
        self._metrics.journal_syncs += 1

    def _current_epoch(self) -> int:
        """The persisted epoch, stat-cached: one stat a flush when nothing
        changed."""
        path = os.path.join(self._ckpt_dir, "epoch.json")
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return 0
        key = (st.st_mtime_ns, st.st_size)
        if self._fence_cache[0] != key:
            self._fence_cache = (key, read_epoch(self._ckpt_dir))
        return self._fence_cache[1]

    def _check_fence(self) -> None:
        """Refuse durable writes once a newer primary epoch is persisted,
        before any journal or staging mutation."""
        if self._journal is None:
            return
        current = self._current_epoch()
        if current > self._epoch:
            self._metrics.fenced_writes += 1
            _obs.emit(
                "bridge.fenced", site="bridge.flush", epoch=current,
                own_epoch=self._epoch, flush_seq=self._flush_seq,
            )
            tr = _ctrace.get()
            if tr is not None:
                tr.point("bridge.fenced", epoch=current, own_epoch=self._epoch,
                         flush_seq=self._flush_seq)
            fl = _flight.get()
            if fl is not None:
                fl.trigger("fenced", epoch=current, own_epoch=self._epoch,
                           flush_seq=self._flush_seq, checkpoint_dir=self._ckpt_dir)
            raise FencedError(
                f"bridge fenced: checkpoint dir {self._ckpt_dir!r} is at "
                f"primary epoch {current}, this bridge was admitted at "
                f"{self._epoch} — a standby was promoted; stop writing",
                observed_epoch=current,
                own_epoch=self._epoch,
            )

    def _attach_journal(
        self,
        checkpoint_dir: str,
        *,
        checkpoint_every: int = 64,
        durability: str = "buffered",
        epoch: Optional[int] = None,
    ) -> None:
        """Adopt ``checkpoint_dir`` as this bridge's durability plane (a
        standby's promotion, :meth:`StandbyReplica.promote`): open the
        journal for append without a fresh bridge's seq-0 anchor (the
        checkpoint and journal there already cover ``flushed_seq``) and
        admit the bridge at ``epoch`` (default: the persisted one)."""
        if self._journal is not None:
            raise ValueError("this bridge already journals")
        os.makedirs(checkpoint_dir, exist_ok=True)
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = max(1, int(checkpoint_every))
        self._durability = durability
        self._epoch = read_epoch(checkpoint_dir) if epoch is None else epoch
        self._fence_cache = (None, 0)
        self._journal = _FlushJournal(
            os.path.join(checkpoint_dir, "journal.bin"),
            self._config.num_reservoirs,
            self._config.tile_size,
            np.dtype(self._config.element_dtype),
            self._config.weighted,
            fsync=durability == "fsync",
            sync_cb=self._count_journal_sync,
        )

    def _save_snapshot(self) -> None:
        """Checkpoint the engine, covering every flush ``<= _flush_seq``
        (atomic), then drop the journal records it covers."""
        self._check_fence()
        save_engine(
            os.path.join(self._ckpt_dir, "engine.npz"),
            self._engine,
            metadata={
                "bridge": {
                    "seq": self._flush_seq,
                    "epoch": self._epoch,
                    "reusable": self._reusable,
                    "pipelined": self._pipeline is not None,
                    "checkpoint_every": self._ckpt_every,
                    "durability": self._durability,
                    "elements": self._metrics.elements,
                    "flushed_elements": self._metrics.flushed_elements,
                    "gated": self._gated_requested,
                    "gate_tile": self._gate_tile,
                }
            },
        )
        self._journal.rotate()
        self._metrics.checkpoints += 1
        _obs.emit("bridge.checkpoint", site="checkpoint.write",
                  flush_seq=self._flush_seq, epoch=self._epoch)

    def _maybe_checkpoint(self) -> None:
        if self._journal is None or self._flush_seq % self._ckpt_every:
            return
        # outside the guard: a worker error it re-raises is a stream
        # failure, not a checkpoint failure
        self.drain_barrier()
        try:
            self._save_snapshot()
        except FencedError:
            raise  # this primary must stop
        except Exception as e:
            # degraded durability, not lost availability: the previous
            # checkpoint is intact and the journal keeps growing from it
            warn_once(
                self,
                "_ckpt_failed_logged",
                "auto-checkpoint failed (%s: %s); sampling continues, "
                "recovery will replay the longer journal (logged once "
                "per bridge)",
                type(e).__name__,
                e,
                logger=__name__,
                site="checkpoint.write",
            )

    @classmethod
    def recover(
        cls,
        checkpoint_dir: str,
        map_fn: Optional[Any] = None,
        hash_fn: Optional[Any] = None,
        pipelined: Optional[bool] = None,
        retry_policy: Optional[RetryPolicy] = None,
        flush_timeout_s: Optional[float] = None,
        checkpoint_every: Optional[int] = None,
        faults: Optional[Any] = None,
        *,
        durability: Optional[str] = None,
        gated: Optional[bool] = None,
        gate_tile: Optional[int] = None,
        replay_hook: Optional[Any] = None,
        device: Optional[Any] = None,
        mesh: Optional[Any] = None,
        native: bool = True,
    ) -> "DeviceStreamBridge":
        """Rebuild a crashed auto-checkpointing bridge (of either package)
        from ``checkpoint_dir`` and replay the journaled tail.

        The reservoirs are bit-identical to those of an uninterrupted run
        over the same flushes.  Resume pushing from :attr:`flushed_seq` /
        ``metrics.flushed_elements``.  ``pipelined``/``checkpoint_every``
        default to the crashed bridge's settings, ``gated`` and
        ``gate_tile`` too.  A gated frame (``RTJG``) replays through
        :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.sample_gated`,
        as the live path applied it, and a row adoption's frame (``RTJA``)
        through :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.adopt_rows`.

        ``replay_hook(bridge, watermark)`` is called once when the state
        reaches the checkpoint's watermark and again after each replayed
        tile with its sequence number.  ``map_fn``/``hash_fn`` are code, not
        data: pass again those the crashed bridge ran with (a mismatch with
        the checkpoint raises the reference's ``ValueError``).  A meshed
        bridge's engine is restored onto ``mesh`` (default every visible
        card), where its rows must divide.
        """
        engine_path = os.path.join(checkpoint_dir, "engine.npz")
        engine, metadata = load_engine(engine_path, device=device, mesh=mesh, with_metadata=True,
                                       map_fn=map_fn, hash_fn=hash_fn)
        info = (metadata or {}).get("bridge")
        if info is None:
            raise ValueError(
                f"{engine_path!r} was not written by an auto-checkpointing "
                "bridge (no bridge metadata); use ReservoirEngine.restore()"
            )
        # a newer persisted epoch than the lineage's means a standby was
        # promoted past it: recovering would put a second writer on rows
        # the promoted primary owns
        persisted = read_epoch(checkpoint_dir)
        recorded = int(info.get("epoch", persisted))
        if persisted > recorded:
            raise CheckpointMismatch(
                f"{checkpoint_dir!r}: checkpoint lineage was admitted at "
                f"primary epoch {recorded}, but the persisted fence is at "
                f"epoch {persisted} — a standby was promoted past this "
                "lineage; recover from the promoted primary's checkpoint "
                "(its post-promotion handoff checkpoint) instead"
            )
        engine._faults = faults
        bridge = cls(
            engine.config,
            reusable=bool(info["reusable"]),
            pipelined=bool(info["pipelined"]) if pipelined is None else pipelined,
            retry_policy=retry_policy,
            flush_timeout_s=flush_timeout_s,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=(
                int(info["checkpoint_every"]) if checkpoint_every is None else checkpoint_every
            ),
            durability=info.get("durability", "buffered") if durability is None else durability,
            faults=faults,
            gated=bool(info.get("gated", False)) if gated is None else gated,
            gate_tile=int(info.get("gate_tile", 64)) if gate_tile is None else gate_tile,
            native=native,
            _engine=engine,
        )
        covered = int(info["seq"])
        bridge._flush_seq = covered
        m = bridge._metrics
        m.elements = int(info.get("elements", 0))
        m.flushed_elements = int(info.get("flushed_elements", 0))
        m.flushes = covered
        # replay on this thread (the pipeline is idle), skipping records the
        # checkpoint covers
        config = engine.config
        if replay_hook is not None:
            replay_hook(bridge, covered)
        for seq, tile, valid, wtile, advance in _FlushJournal.replay(
            os.path.join(checkpoint_dir, "journal.bin"),
            config.num_reservoirs,
            config.tile_size,
            np.dtype(config.element_dtype),
            config.weighted,
        ):
            if seq <= covered:
                continue
            with bridge._on_stream():
                if advance is _FlushJournal.ADOPT:
                    # the rows migrated in at this place between flushes;
                    # ``tile`` holds the frame's payload
                    engine.adopt_rows(*_unpack_adopt_payload(tile))
                    total = 0
                elif advance is not None:
                    # a gated frame: candidates and per-row advance, through
                    # the gated apply the live path used
                    engine.sample_gated(tile, valid, advance)
                    total = int(advance.sum())
                else:
                    engine.sample(tile, valid=valid, weights=wtile)
                    total = int(valid.sum())
            bridge._flush_seq = seq
            m.flushes += 1
            m.elements += total
            m.flushed_elements += total
            if replay_hook is not None:
                replay_hook(bridge, seq)
        m.recoveries += 1
        _obs.emit(
            "bridge.recovered",
            site="bridge.recover",
            flush_seq=bridge._flush_seq,
            replayed=bridge._flush_seq - covered,
            epoch=bridge._epoch,
        )
        return bridge

    # ------------------------------------------------------------ completion

    def complete(self) -> List[np.ndarray]:
        """Upstream completion: flush remainders, fulfil the future with the
        per-stream samples and return them.  Reusable bridges may push on
        afterwards (a fresh future is armed)."""
        self._check_open()
        self.flush()
        self.drain_barrier()  # result() must see every dispatched tile
        with trace_span("reservoir_bridge_result"), self._on_stream():
            res = self._engine.result()
        self._metrics.completions += 1
        self._future.set_result(res)
        if self._reusable:
            self._future = Future()
        return res

    def fail(self, cause: BaseException) -> None:
        """Upstream failure: fail the future with ``cause``."""
        if not self._future.done():
            self._metrics.failures += 1
            self._future.set_exception(cause)

    def cancel(self, cause: Optional[BaseException] = None) -> None:
        """Downstream cancellation: graceful delivers the partial sample, a
        cause fails the future."""
        if self._future.done():
            return
        if cause is None:
            self.complete()
        else:
            self.fail(cause)

    def __del__(self) -> None:
        # the backstop of a bridge dropped without completing
        pipe = getattr(self, "_pipeline", None)
        fut = getattr(self, "_future", None)
        if pipe is not None:
            try:
                pipe.close()
            except BaseException as e:
                # close() re-raises an error of the final flush: route it
                # through the tri-state protocol, do not raise in teardown
                if fut is not None and not fut.done():
                    fut.set_exception(e)
        journal = getattr(self, "_journal", None)
        if journal is not None:
            journal.close()
        if fut is not None and not fut.done():
            fut.set_exception(AbruptStreamTermination("stream bridge dropped without completing"))


class DeviceSampler:
    """Single-stream sampler over the engine: per-element ``sample``
    buffers on the host, the device sees fixed-width tiles, and ``result``
    flushes the remainder and applies the single-use lifecycle."""

    def __init__(
        self,
        config: SamplerConfig,
        key: Union[int, Any, None] = None,
        reusable: bool = False,
        *,
        device: Optional[Any] = None,
    ) -> None:
        if config.num_reservoirs != 1:
            raise ValueError(
                "DeviceSampler is single-stream (num_reservoirs=1); use "
                "DeviceStreamBridge for many streams"
            )
        self._engine = ReservoirEngine(config, key=key, reusable=reusable, device=device)
        self._reusable = reusable
        self._open = True
        self._buf = np.zeros(config.tile_size, dtype=np.dtype(config.element_dtype))
        self._fill = 0

    @property
    def engine(self) -> ReservoirEngine:
        return self._engine

    @property
    def is_open(self) -> bool:
        return True if self._reusable else self._open

    def _check_open(self) -> None:
        if not self.is_open:
            raise SamplerClosedError("this sampler is single-use, and no longer open")

    def _flush(self) -> None:
        if self._fill:
            self._engine.sample(self._buf[None, :], valid=np.asarray([self._fill], np.int32))
            self._fill = 0

    def sample(self, element: Any) -> None:
        self._check_open()
        self._buf[self._fill] = element
        self._fill += 1
        if self._fill >= self._buf.shape[0]:
            self._flush()

    def sample_all(self, elements: Any) -> None:
        """Bulk path: an array flushes in whole tiles without the
        per-element loop; any other iterable goes element by element.  An
        error names the element range that failed to convert."""
        self._check_open()
        if not isinstance(elements, np.ndarray) and not hasattr(elements, "__len__"):
            for i, e in enumerate(elements):
                try:
                    self.sample(e)
                except (TypeError, ValueError) as e_:
                    raise ValueError(f"elements[{i}] not storable as {self._buf.dtype}: {e_}") from None
            return
        arr = np.asarray(elements) if not isinstance(elements, np.ndarray) else elements
        if arr.dtype == object or arr.ndim != 1:
            for i, e in enumerate(np.ravel(arr)):
                try:
                    self.sample(e)
                except (TypeError, ValueError) as e_:
                    raise ValueError(f"elements[{i}] not storable as {self._buf.dtype}: {e_}") from None
            return
        B = self._buf.shape[0]
        off = 0
        n = arr.shape[0]
        while off < n:
            take = min(B - self._fill, n - off)
            try:
                self._buf[self._fill : self._fill + take] = arr[off : off + take]
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"elements[{off}:{off + take}] (dtype {arr.dtype}) not "
                    f"storable as {self._buf.dtype}: {e}"
                ) from None
            self._fill += take
            off += take
            if self._fill >= B:
                self._flush()

    def result(self) -> np.ndarray:
        self._check_open()
        self._flush()
        res = self._engine.result()[0]
        if not self._reusable:
            self._open = False
            self._buf = None  # free
        return res
