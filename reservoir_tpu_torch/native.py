"""The stream bridge's host staging: the C++ demux of
``_native/staging_buffer.cc`` (a copy of the JAX package's), loaded with
``ctypes``, and a numpy staging with the same semantics.

The bridge's costly host step is the demux: an interleaved feed of
``(stream_id, element)`` pairs is scattered into per-stream rows of an
``[S, B]`` staging tile.  The C++ demux does it in a pointer walk, split
over a pool of threads by row range once a batch is large.  In the bridge's
zero-copy mode (:meth:`NativeStaging.attach`) it scatters straight into the
tile that is flushed, which on the card is pinned host memory.

The library is built with ``g++`` at first use into
``reservoir_tpu_torch/_build/`` (:func:`reservoir_tpu_torch._build.build_host`).
There is no silent fallback: :class:`NativeStaging` raises if the library
fails to build or load, and uses the numpy staging only when the caller
passes ``native=False``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from .utils import faults as _faults

__all__ = ["NativeStaging", "load_library"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native", "staging_buffer.cc")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_VP = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def load_library() -> ctypes.CDLL:
    """The staging library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from ._build import build_host

            lib = ctypes.CDLL(build_host(_SOURCE))
            lib.rsv_staging_create.restype = _VP
            lib.rsv_staging_create.argtypes = [_I32] * 4
            lib.rsv_staging_destroy.restype = None
            lib.rsv_staging_destroy.argtypes = [_VP]
            lib.rsv_staging_push_chunk.restype = _I64
            lib.rsv_staging_push_chunk.argtypes = [_VP, _I32, _VP, _VP, _I64]
            lib.rsv_staging_push_interleaved.restype = _I64
            lib.rsv_staging_push_interleaved.argtypes = [_VP, _VP, _VP, _VP, _I64]
            lib.rsv_staging_fill.restype = _I32
            lib.rsv_staging_fill.argtypes = [_VP, _I32]
            lib.rsv_staging_attach.restype = _I32
            lib.rsv_staging_attach.argtypes = [_VP, _VP, _VP]
            lib.rsv_staging_take.restype = _I64
            lib.rsv_staging_take.argtypes = [_VP, _VP]
            lib.rsv_staging_threads.restype = _I32
            lib.rsv_staging_threads.argtypes = []
            _lib = lib
        return _lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(_VP)


class NativeStaging:
    """``[S, B]`` staging of S streams: the C++ demux (``native=True``) or
    the numpy one (``native=False``), with the same results.  Pushes
    scatter into the tiles given to :meth:`attach`; :meth:`take` reads and
    resets the per-row fill counts.  Single producer, single consumer (the
    bridge's contract)."""

    def __init__(self, num_streams: int, tile_width: int, dtype,
                 weighted: bool = False, native: bool = True) -> None:
        self._S = int(num_streams)
        self._B = int(tile_width)
        self._dtype = np.dtype(dtype)
        self._weighted = weighted
        self._lib: Optional[ctypes.CDLL] = None
        self._handle = None
        if weighted and self._dtype.itemsize != 4:
            raise ValueError("weighted staging requires a 4-byte element dtype")
        self._tile: Optional[np.ndarray] = None
        self._wtile: Optional[np.ndarray] = None
        if native:
            lib = load_library()
            self._handle = lib.rsv_staging_create(
                self._S, self._B, self._dtype.itemsize, 2 if weighted else 1
            )
            if not self._handle:
                raise MemoryError(f"rsv_staging_create failed for [{self._S}, {self._B}]")
            self._lib = lib
        else:
            self._fill = np.zeros(self._S, np.int32)

    def available(self) -> bool:
        """True when the C++ demux is in use."""
        return self._lib is not None

    def threads(self) -> int:
        """Demux threads the C++ pool uses (``RESERVOIR_STAGING_THREADS``,
        else the core count up to 16; 1 = serial).  1 for numpy."""
        return int(self._lib.rsv_staging_threads()) if self._lib is not None else 1

    def attach(self, tile: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        """Scatter future pushes into ``tile`` (``[S, B]`` of the staging
        dtype, C-contiguous) and, iff weighted, ``weights`` (float32).  The
        arrays must outlive the attachment and must not be read while
        pushes run."""
        if tile.shape != (self._S, self._B) or tile.dtype != self._dtype:
            raise ValueError(f"tile must be [{self._S}, {self._B}] {self._dtype}")
        if not tile.flags["C_CONTIGUOUS"]:
            raise ValueError("attached tile must be C-contiguous")
        if self._weighted != (weights is not None):
            raise ValueError("weights tile required iff staging is weighted")
        if weights is not None and not (
            weights.flags["C_CONTIGUOUS"]
            and weights.shape == (self._S, self._B)
            and weights.dtype == np.float32
        ):
            raise ValueError(f"weights must be C-contiguous [{self._S}, {self._B}] float32")
        if self._lib is not None:
            if self._lib.rsv_staging_attach(self._handle, _ptr(tile), _ptr(weights)) != 0:
                raise ValueError("invalid attach arguments")
        # held alive while the C side keeps raw pointers into them
        self._tile, self._wtile = tile, weights

    def take(self, out_valid: np.ndarray) -> int:
        """Copy the per-row fill counts into ``out_valid`` (``[S]`` int32)
        and reset them; returns the total.  The data is already in the
        attached tiles."""
        _faults.fire("native.staging")
        if out_valid.shape != (self._S,) or out_valid.dtype != np.int32:
            raise ValueError(f"out_valid must be [{self._S}] int32")
        if not out_valid.flags["C_CONTIGUOUS"]:
            raise ValueError("out_valid must be C-contiguous")
        if self._lib is not None:
            total = self._lib.rsv_staging_take(self._handle, _ptr(out_valid))
            if total < 0:
                raise ValueError("invalid take arguments")
            return int(total)
        out_valid[...] = self._fill
        total = int(self._fill.sum())
        self._fill[:] = 0
        return total

    def _check_attached(self) -> None:
        if self._tile is None:
            raise RuntimeError("attach a tile before pushing")

    def push_chunk(self, stream: int, elems: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> int:
        """Append a contiguous chunk to one row; returns the elements taken
        (fewer than ``len(elems)`` when the row filled: flush and resume)."""
        _faults.fire("native.staging")
        self._check_attached()
        elems = np.ascontiguousarray(elems, self._dtype)
        if self._weighted != (weights is not None):
            raise ValueError("weights required iff staging is weighted")
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32)
            if weights.shape != elems.shape:
                raise ValueError("weights must match elements shape")
        if not 0 <= int(stream) < self._S:
            raise ValueError(f"stream {int(stream)} out of range [0, {self._S})")
        if self._lib is not None:
            took = self._lib.rsv_staging_push_chunk(
                self._handle, int(stream), _ptr(elems), _ptr(weights), elems.size
            )
            if took < 0:
                raise ValueError("invalid push_chunk arguments")
            return int(took)
        fill = int(self._fill[stream])
        take = min(self._B - fill, elems.size)
        self._tile[stream, fill : fill + take] = elems[:take]
        if weights is not None:
            self._wtile[stream, fill : fill + take] = weights[:take]
        self._fill[stream] += take
        return take

    def push_interleaved(self, streams: np.ndarray, elems: np.ndarray,
                         weights: Optional[np.ndarray] = None) -> int:
        """Demux ``(stream_id, element)`` pairs in order; returns the pairs
        taken (fewer than ``len(streams)`` when a target row was full:
        flush and resume).  Raises on a stream id out of range, naming it."""
        _faults.fire("native.staging")
        self._check_attached()
        streams = np.ascontiguousarray(streams, np.int32)
        elems = np.ascontiguousarray(elems, self._dtype)
        if streams.shape != elems.shape or streams.ndim != 1:
            raise ValueError("streams and elems must be equal-length 1-D")
        if self._weighted != (weights is not None):
            raise ValueError("weights required iff staging is weighted")
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32)
            if weights.shape != elems.shape:
                raise ValueError("weights must match elements shape")
        if streams.size and (int(streams.min()) < 0 or int(streams.max()) >= self._S):
            bad = int(np.argmax((streams < 0) | (streams >= self._S)))
            raise ValueError(
                f"stream id {int(streams[bad])} out of range [0, {self._S}) "
                f"at position {bad} of the interleaved batch"
            )
        if self._lib is not None:
            took = self._lib.rsv_staging_push_interleaved(
                self._handle, _ptr(streams), _ptr(elems), _ptr(weights), streams.size
            )
            if took < 0:
                raise ValueError("invalid push_interleaved arguments")
            return int(took)
        return self._numpy_interleaved(streams, elems, weights)

    def _numpy_interleaved(self, streams, elems, weights) -> int:
        """The numpy demux: the longest prefix in which no row passes B
        (the C++ contract), scattered with one stable sort by stream."""
        n = streams.size
        if n == 0:
            return 0
        # each pair's slot in its row: the row's fill plus its rank among
        # the earlier pairs of the same stream
        order = np.argsort(streams, kind="stable")
        s_sorted = streams[order]
        starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
        run = np.repeat(starts, np.diff(np.r_[starts, n]))
        slot = np.empty(n, np.int64)
        slot[order] = np.arange(n) - run + self._fill[s_sorted].astype(np.int64)
        over = np.flatnonzero(slot >= self._B)
        took = int(over[0]) if over.size else n
        s, at = streams[:took], slot[:took]
        self._tile[s, at] = elems[:took]
        if weights is not None:
            self._wtile[s, at] = weights[:took]
        np.add.at(self._fill, s, 1)
        return took

    def row_full(self, stream: int) -> bool:
        """True when row ``stream`` holds B elements."""
        return self.fill(stream) >= self._B

    def fill(self, stream: int) -> int:
        """Elements staged in row ``stream``."""
        if self._lib is not None:
            return int(self._lib.rsv_staging_fill(self._handle, int(stream)))
        return int(self._fill[stream])

    def __del__(self) -> None:
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.rsv_staging_destroy(handle)
