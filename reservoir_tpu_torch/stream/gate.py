"""Ingest-side skip-ahead gate: ship only the elements that can win (the
port of the JAX package's ``stream/gate.py``).

Past the fill phase Algorithm L accepts a vanishing share of elements, yet
an ungated bridge copies every staged byte to the card.  The gate keeps a
host **replica** of each row's chain ``(count, nxt, log_w)`` and, for a
chunk of a row's stream, names its **candidates**: the fill prefix and
every acceptance.  Only those ship, coalesced into a small
``[S, gate_tile]`` tile with a per-row ``advance``, which
:meth:`~reservoir_tpu_torch.engine.ReservoirEngine.sample_gated` applies
(``ops/algorithm_l.py`` :func:`update_gated`, the ``algl_update_gated``
kernel on the card).  Everything else is elided: never staged, journaled
or copied.

The replica must walk exactly the card's chain: one ulp of a log flips a
floor and forks ``nxt``.  With ``native=True`` (the default) it is
``_native/skip_gate.cc``, which compiles the kernels' own chain header
(``csrc/algl_chain.cuh``) for the CPU, step for step the same IEEE
operations, so the replica equals the card by construction; it is built
with ``g++`` at first use and raises if it cannot be.  ``native=False``
runs the plain torch chain (``ops/algorithm_l.py``'s ``_advance_words``)
in a lockstep loop: the same bits, far slower, and only when asked for.
The JAX package evaluates the same chain in one jitted XLA-CPU call.

:func:`SkipGate.evaluate` walks every row over a chunk of ``valid[r]``
elements (rows split over threads); :func:`SkipGate.evaluate_row` walks one
row and costs that row's accepts only (the reference walks all S rows);
its verdict carries ``row``, and its arrays hold that one row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["SkipGate", "GateEval", "gate_ineligible_reason"]


def gate_ineligible_reason(config, staging=None) -> Optional[str]:
    """None when the skip gate can run for ``config``, else why not.

    The gate replicates the *duplicates-mode* Algorithm-L recursion with
    narrow int32 counters; weighted (A-ExpJ needs every weight to decide)
    and distinct (every element's hash competes) modes, WIDE/int64
    counters, and meshed engines stay on the ungated path.  A ``gated=True``
    bridge in those modes is simply inert — same results, no elision.
    """
    if config.weighted:
        return "weighted mode (A-ExpJ must see every weight)"
    if config.distinct:
        return "distinct mode (every element's hash competes)"
    if config.count_dtype == "wide":
        return "WIDE counters (gate replica is int32-narrow)"
    if np.dtype(config.count_dtype) != np.int32:
        return f"count_dtype {config.count_dtype!r} (gate replica is int32)"
    if config.mesh_axis is not None:
        return "meshed engine (gated dispatch is single-device)"
    return None


class GateEval(NamedTuple):
    """One chunk's verdict (host arrays a row).  It carries the post-chunk
    replica state uncommitted: the caller commits when it consumes the
    chunk at this granularity, or discards it when it sends the chunk to
    the staged path (whose flushes evaluate again, tile by tile).  A
    verdict of :meth:`SkipGate.evaluate_row` has ``row`` set and holds that
    row alone (index 0 of each array)."""

    pos: np.ndarray    #: [S, cap] int32 accept positions (first n_acc valid)
    fill: np.ndarray   #: [S] int32 fill-phase prefix lengths
    n_acc: np.ndarray  #: [S] int32 acceptance counts in the chunk
    n_cand: np.ndarray  #: [S] int32 fill + n_acc
    fallback: bool     #: some evaluated row's candidates overflow the tile
    state: tuple       #: (count, nxt, log_w) numpy arrays after the chunk
    row: Optional[int] = None  #: the one row evaluated, or None for all


def _eval_torch(k: int, cap: int, count, nxt, log_w, k1, k2, m):
    """The plain replica: every row over ``m[r]`` elements, the torch
    chain of ``ops/algorithm_l.py`` in a lockstep loop over the rows that
    still accept (numpy in, numpy out, as :func:`_build_eval` of the
    reference computes it)."""
    from ..ops.algorithm_l import _advance_words

    count_t = torch.from_numpy(count)
    m_t = torch.from_numpy(m)
    end = count_t + m_t  # int32 wraps, as XLA's does
    nxt_t = torch.from_numpy(nxt).clone()
    lw = torch.from_numpy(log_w).clone()
    k1_t = torch.from_numpy(k1.astype(np.int64))
    k2_t = torch.from_numpy(k2.astype(np.int64))
    S = count.shape[0]
    pos = torch.zeros((S, cap), dtype=torch.int32)
    n = torch.zeros(S, dtype=torch.int64)
    rows = torch.nonzero(nxt_t <= end).flatten()
    while rows.numel():
        cur = nxt_t[rows]
        pos[rows, torch.clamp(n[rows], max=cap - 1)] = cur - count_t[rows] - 1
        _, lw_n, nxt_n = _advance_words(lw[rows], cur, k1_t[rows], k2_t[rows], cur, k)
        nxt_t[rows] = nxt_n
        lw[rows] = lw_n
        n[rows] += 1
        rows = rows[nxt_n <= end[rows]]
    fill = torch.minimum(torch.clamp(k - count_t, min=0), m_t)
    return (pos.numpy(), fill.numpy(), n.to(torch.int32).numpy(), end.numpy(), nxt_t.numpy(),
            lw.numpy())


class SkipGate:
    """Host replica of the skip chain and the candidate coalescing buffer
    of one :class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge`.

    Single-writer like the bridge that owns it.  The replica is only a
    predictor: the card runs the same recursion over what ships, so a
    right replica elides only bytes the card would never have touched.
    :meth:`resync` pulls the replica from the engine's state; the bridge
    calls it whenever the engine changed behind the gate (construction,
    ``recover()``'s replay, ``push_tile``, row resets, which
    ``engine.reset_epochs`` counts).

    ``native`` chooses the replica: the C++ library (default; raises if it
    cannot be built) or, with ``False``, the plain torch chain.
    """

    def __init__(self, num_streams: int, k: int, tile_width: int, dtype,
                 cap: int = 64, native: bool = True) -> None:
        if cap <= 0:
            raise ValueError(f"gate_tile must be positive, got {cap}")
        self._S = int(num_streams)
        self._k = int(k)
        self._B = int(tile_width)
        self._cap = int(cap)
        self._dtype = np.dtype(dtype)
        self._dirty = True
        self._seen_resets = -1
        # candidate coalescing buffers: gtile rows fill left-to-right
        # across flushes; gadv counts every logical element consumed a row
        # since the last gated dispatch (int64 here; a dispatch is forced
        # long before the int32 wire format could wrap)
        self._gtile = np.zeros((self._S, self._cap), self._dtype)
        self._gcount = np.zeros(self._S, np.int64)
        self._gadv = np.zeros(self._S, np.int64)
        self._cols = np.arange(self._cap, dtype=np.int32)[None, :]
        self._rows = np.arange(self._S, dtype=np.int32)[:, None]
        # the replica, in place for its whole life: the native handle keeps
        # pointers to these arrays, resync and commit write into them
        self._count = np.zeros(self._S, np.int32)
        self._nxt = np.zeros(self._S, np.int32)
        self._logw = np.zeros(self._S, np.float32)
        self._k1 = np.zeros(self._S, np.uint32)
        self._k2 = np.zeros(self._S, np.uint32)
        self._lib = None
        self._handle = None
        if native:
            from ..native import load_gate_library

            lib = load_gate_library()
            ptr = lambda a: a.ctypes.data  # noqa: E731
            handle = lib.rsv_gate_create(
                self._S, self._k, self._cap, ptr(self._count), ptr(self._nxt), ptr(self._logw),
                ptr(self._k1), ptr(self._k2),
            )
            if not handle:
                raise MemoryError(f"rsv_gate_create failed for S={self._S}, k={self._k}")
            self._lib, self._handle = lib, handle

    # ------------------------------------------------------------ properties

    @property
    def cap(self) -> int:
        """Gate-tile width: the most candidates a row can buffer."""
        return self._cap

    @property
    def native(self) -> bool:
        """True when the replica is the C++ library."""
        return self._lib is not None

    def threads(self) -> int:
        """Threads a whole :meth:`evaluate` of many rows uses (the core
        count up to 16); 1 for the torch replica."""
        return int(self._lib.rsv_gate_threads()) if self._lib is not None else 1

    def pending(self) -> bool:
        """Whether any consumed-but-undispatched advance is buffered."""
        return bool(self._gadv.any())

    def advance_high(self) -> bool:
        """Buffered advance nearing the int32 wire format: force a dispatch
        (2^30 elements a row between dispatches)."""
        return bool(self._gadv.max(initial=0) >= (1 << 30))

    # --------------------------------------------------------------- replica

    def stale(self, engine) -> bool:
        """True when the replica no longer mirrors the engine (never
        synced, or rows were reset behind the gate's back)."""
        return self._dirty or engine.reset_epochs != self._seen_resets

    def mark_dirty(self) -> None:
        """The engine was changed outside the gated flush path
        (``push_tile``, recovery replay): pull again before the next eval."""
        self._dirty = True

    def resync(self, engine) -> None:
        """Pull ``(count, nxt, log_w, key)`` from the engine's state, on
        whatever device it lives.

        The caller must hold the engine's single-writer slot (the bridge
        drains its pipeline first) and must have dispatched any pending
        gated buffer: buffered candidates predate the state being pulled.
        """
        if self.pending():
            raise RuntimeError(
                "resync with a pending gated buffer would reorder the "
                "stream; dispatch it first"
            )
        state = engine._state
        np.copyto(self._count, state.count.cpu().numpy())
        np.copyto(self._nxt, state.nxt.cpu().numpy())
        np.copyto(self._logw, state.log_w.cpu().numpy())
        key = state.key.cpu().numpy()
        np.copyto(self._k1, key[:, 0].astype(np.uint32))
        np.copyto(self._k2, key[:, 1].astype(np.uint32))
        self._seen_resets = engine.reset_epochs
        self._dirty = False

    def evaluate(self, valid: np.ndarray) -> GateEval:
        """Walk the chain over a chunk of ``valid[r]`` elements in every row
        and return the verdict without committing it (pair it with
        :meth:`commit` on the path that consumes the chunk at this
        granularity).  Rows with ``valid[r] == 0`` are untouched."""
        m = np.ascontiguousarray(valid, np.int32)
        if m.shape != (self._S,):
            raise ValueError(f"valid must be [{self._S}], got {m.shape}")
        if self._lib is not None:
            pos = np.empty((self._S, self._cap), np.int32)
            fill, n_acc, count, nxt = (np.empty(self._S, np.int32) for _ in range(4))
            logw = np.empty(self._S, np.float32)
            p = lambda a: a.ctypes.data  # noqa: E731
            if self._lib.rsv_gate_eval(self._handle, p(m), p(pos), p(fill), p(n_acc), p(count),
                                       p(nxt), p(logw)) < 0:
                raise ValueError("valid entries must be nonnegative")
        else:
            if (m < 0).any():
                raise ValueError("valid entries must be nonnegative")
            pos, fill, n_acc, count, nxt, logw = _eval_torch(
                self._k, self._cap, self._count, self._nxt, self._logw, self._k1, self._k2, m
            )
        n_cand = fill + n_acc
        return GateEval(pos, fill, n_acc, n_cand, bool((n_cand > self._cap).any()),
                        (count, nxt, logw))

    def evaluate_row(self, row: int, m: int) -> GateEval:
        """:meth:`evaluate` of one row's contiguous chunk of ``m`` elements
        (the pre-staging push path: a row-major producer's chunk is gated
        before any demux or staging copy).  Costs that row's accepts; the
        verdict has ``row`` set and index 0 of each array is the row's."""
        row, m = int(row), int(m)
        if not 0 <= row < self._S or m < 0:
            raise ValueError(f"row {row} out of range [0, {self._S}) or negative chunk {m}")
        if self._lib is not None:
            out = np.empty(4 + self._cap, np.int32)
            logw = np.empty(1, np.float32)
            self._lib.rsv_gate_eval_row(self._handle, row, m, out.ctypes.data, logw.ctypes.data)
            fill, n_acc = out[0:1], out[1:2]
            state = (out[2:3], out[3:4], logw)
            pos = out[4:].reshape(1, self._cap)
        else:
            sl = slice(row, row + 1)
            pos, fill, n_acc, count, nxt, logw = _eval_torch(
                self._k, self._cap, self._count[sl], self._nxt[sl], self._logw[sl], self._k1[sl],
                self._k2[sl], np.asarray([m], np.int32),
            )
            state = (count, nxt, logw)
        n_cand = fill + n_acc
        return GateEval(pos, fill, n_acc, n_cand, bool(n_cand[0] > self._cap), state, row)

    def commit(self, ev: GateEval) -> None:
        """Adopt the post-chunk replica state: the evaluated chunk is now
        consumed (buffered gated, dispatched gated, or shipped whole as an
        ungated fallback: every path runs the same chain on the card)."""
        count, nxt, logw = ev.state
        if ev.row is None:
            np.copyto(self._count, count)
            np.copyto(self._nxt, nxt)
            np.copyto(self._logw, logw)
        else:
            self._count[ev.row] = count[0]
            self._nxt[ev.row] = nxt[0]
            self._logw[ev.row] = logw[0]

    # --------------------------------------------------------------- buffers

    def fits(self, ev: GateEval) -> bool:
        """Whether this eval's candidates fit the remaining buffer room."""
        return bool(((self._gcount + ev.n_cand) <= self._cap).all())

    def fits_row(self, row: int, ev: GateEval) -> bool:
        i = 0 if ev.row is not None else row
        return bool(self._gcount[row] + ev.n_cand[i] <= self._cap)

    def append_row(self, row: int, chunk: np.ndarray, ev: GateEval) -> int:
        """Gather one row-chunk's candidates straight from the producer's
        array (no staging copy); returns the elided element count.
        Caller guarantees ``fits_row`` and ``ev.n_cand <= cap`` for the row."""
        i = 0 if ev.row is not None else row
        f = int(ev.fill[i])
        na = int(ev.n_acc[i])
        nc = f + na
        if nc:
            idx = np.concatenate(
                [np.arange(f, dtype=np.int64), ev.pos[i, :na]]
            ) if f else ev.pos[i, :na]
            at = int(self._gcount[row])
            self._gtile[row, at:at + nc] = chunk[idx]
            self._gcount[row] += nc
        self._gadv[row] += chunk.size
        return int(chunk.size) - nc

    def append(self, tile: np.ndarray, valid: np.ndarray, ev: GateEval) -> int:
        """Gather the candidates of ``tile`` into the coalescing buffer;
        returns the number of elided elements (staged minus candidates).
        Caller guarantees ``fits(ev)`` and ``not ev.fallback``."""
        n_cand = ev.n_cand
        total_cand = int(n_cand.sum())
        total = int(np.asarray(valid).sum())
        if total_cand:
            # gather index per (row, slot): fill prefix positions 0..f-1,
            # then the accept positions, in one vectorized gather
            f = ev.fill[:, None]
            acc_j = np.minimum(np.maximum(self._cols - f, 0), self._cap - 1)
            gidx = np.where(self._cols < f, self._cols, ev.pos[self._rows, acc_j])
            mask = self._cols < n_cand[:, None]
            vals = np.take_along_axis(tile, np.clip(gidx, 0, self._B - 1), axis=1)
            rsel, csel = np.nonzero(mask)
            self._gtile[rsel, self._gcount[rsel] + csel] = vals[rsel, csel]
            self._gcount += n_cand
        self._gadv += np.asarray(valid, np.int64)
        return total - total_cand

    def take(self):
        """Snapshot and reset the coalescing buffer for dispatch: returns
        ``(gtile, nvalid, advance, total_advance)`` as fresh arrays (safe
        to hand to the flush pipeline and the journal)."""
        gtile = self._gtile.copy()
        nvalid = self._gcount.astype(np.int32)
        advance = self._gadv.astype(np.int32)
        total_adv = int(self._gadv.sum())
        self._gcount[:] = 0
        self._gadv[:] = 0
        return gtile, nvalid, advance, total_adv

    def __del__(self) -> None:
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.rsv_gate_destroy(handle)
