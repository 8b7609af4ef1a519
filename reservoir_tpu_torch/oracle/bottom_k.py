"""CPU semantic oracle for distinct-value sampling (salted bottom-k hashing).

The port's copy of the JAX package's ``oracle/bottom_k.py``: the same salts
from one seed, the same scramble (:mod:`reservoir_tpu_torch.ops.hashing`)
and the same default hash, so both packages keep the same sample.  It
re-derives the reference's ``RandomValues`` engine
(``Sampler.scala:383-412``): keep the ``k`` *distinct* values whose salted
64-bit scrambled hashes are smallest.  Every distinct value then has uniform
inclusion probability k/D (D = number of distinct values), because the
scramble induces an independent uniform random order on values
(``Sampler.scala:16-17`` doc contract; bias only from 64-bit collisions).

Structure mirrors the reference hot path (``Sampler.scala:394-408``):

- a max-heap of (hash, value) keyed on hash — the current bottom-k, with the
  *largest* retained hash on top;
- a membership set of values for O(1) dedup;
- a cached ``max_hash`` threshold so the common case (hash above threshold) is
  one compare + one set lookup.

Unlike duplicates mode, ``map`` is applied to *every* element (it feeds the
hash; ``Sampler.scala:155, 395``).  The scramble is the device kernel's, so
this oracle is bit-compatible with the distinct engine.

An integer array with the default map and hash takes the C scan
(``_native/bottom_k.cc``, built with g++ at first use; a build that fails
raises), or with ``native=False`` the chunked numpy route; both keep the
same sample as per-element calls.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..config import validate_max_sample_size
from ..ops.hashing import draw_salts, scramble64_array, scramble64_int

__all__ = ["BottomKOracle"]

_U64 = (1 << 64) - 1


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv(data: bytes, h: int = _FNV_OFFSET) -> int:
    """FNV-1a 64-bit over ``data``, continuing from state ``h``."""
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _default_hash(value: Any) -> int:
    """Default user hash as a stable 64-bit pattern.

    The reference's default is ``_.hashCode().toLong`` — defined for EVERY
    object (``Sampler.scala:75``).  This mirrors that contract for every
    *stable* Python hashable: identity embedding for
    ints (device-kernel parity), canonical-serialization FNV-1a for the
    rest, recursing through containers.  Deliberately *not* Python's
    builtin ``hash()``, which is salted per process and would break
    cross-process reproducibility.

    Consistency with equality (the membership set dedups by ``==``):
    numerically equal ints/bools/floats hash identically (``True == 1 ==
    1.0`` all take the integer embedding), and equal tuples/frozensets
    hash identically by recursion.  Only types with no canonical stable
    serialization (arbitrary objects, whose ``hash()`` is id-based or
    process-salted) are refused — pass ``hash_fn=`` for those.
    """
    # bool is an int subclass, and np.bool_ is neither np.integer nor
    # np.floating — all must share the int embedding (True == 1 == 1.0
    # == np.True_ and == values must hash equal)
    if isinstance(value, (int, np.integer, np.bool_)):
        return int(value) & _U64
    if isinstance(value, (float, np.floating)):
        f = float(value)
        if f.is_integer():
            return int(f) & _U64  # 1.0 == 1: same embedding as the int
        import struct

        return _fnv(b"f" + struct.pack(">d", f))
    if value is None:
        return _fnv(b"N")
    if isinstance(value, str):
        # domain-separated from bytes: 'a' != b'a' must not collide,
        # matching the b"f"/b"N"/b"T"/b"S" prefixes
        return _fnv(b"s" + value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return _fnv(b"b" + bytes(value))
    if isinstance(value, tuple):
        h = _fnv(b"T")
        for item in value:
            h = _fnv(_default_hash(item).to_bytes(8, "big"), h)
        return h
    if isinstance(value, frozenset):
        # order-independent canonical form: sort the element hashes
        h = _fnv(b"S")
        for eh in sorted(_default_hash(item) for item in value):
            h = _fnv(eh.to_bytes(8, "big"), h)
        return h
    raise TypeError(
        f"no stable default hash for {type(value).__name__} (its hash() is "
        "process-salted or id-based, which would break reproducibility); "
        "pass hash_fn="
    )


class BottomKOracle:
    """Single-stream distinct-value sampler (bottom-k min-hashing).

    ``native=False`` takes the numpy route where the C scan would run (same
    results)."""

    def __init__(
        self,
        k: int,
        rng: np.random.Generator,
        map_fn: Optional[Callable[[Any], Any]] = None,
        hash_fn: Optional[Callable[[Any], int]] = None,
        salts: Optional[Tuple[int, int]] = None,
        native: bool = True,
    ) -> None:
        self._k = validate_max_sample_size(int(k))
        self._native = native
        self._mapped = map_fn is not None  # gates the vectorized bulk path
        self._map = map_fn if map_fn is not None else lambda x: x
        self._hash = hash_fn if hash_fn is not None else _default_hash
        # Per-instance salts drawn once (Sampler.scala:385-388); injectable
        # for determinism tests (no reflection needed).
        self._salts = salts if salts is not None else draw_salts(rng)
        # Max-heap via negated hash (heapq is a min-heap).
        self._heap: List[Tuple[int, int, Any]] = []  # (-hash, tiebreak, value)
        self._members: Set[Any] = set()
        self._max_hash: int = -1  # threshold; -1 while not full
        self._tie = 0  # monotonic tiebreaker so values never get compared
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    def _scrambled(self, element: Any) -> Tuple[Any, int]:
        value = self._map(element)  # applied to EVERY element (Sampler.scala:395)
        return value, scramble64_int(self._hash(value), self._salts)

    def sample(self, element: Any) -> None:
        """Per-element hot path (``Sampler.scala:394-408``)."""
        self._count += 1
        value, h = self._scrambled(element)
        self._insert(value, h)

    def sample_all(self, elements: Iterable[Any]) -> None:
        """Bulk path.  Integer arrays with the default map/hash take a
        vectorized route (the ``sampleAll`` fast-path analog,
        ``Sampler.scala:261-287``): hashes are scrambled array-at-once and
        the Python loop touches only fill-phase and below-threshold
        candidates — identical results to per-element calls by construction
        (same hashes, same arrival order)."""
        if (
            # exact type: ndarray subclasses (MaskedArray) keep the loop
            type(elements) is np.ndarray
            and elements.ndim == 1
            and elements.dtype.kind in "iu"
            and elements.dtype.itemsize <= 8
            and self._hash is _default_hash
            and not self._mapped
            # mixed-type streams (per-element str calls interleaved with int
            # arrays) can't round-trip members through a numpy array
            and all(
                isinstance(v, (int, np.integer)) for v in self._members
            )
        ):
            self._sample_all_fast(elements)
        else:
            for element in elements:
                self.sample(element)

    def _as_bits64(self, arr: np.ndarray) -> np.ndarray:
        """The stream as int64 bit patterns — sign-extended for signed
        dtypes, zero-extended for unsigned (the ``int(v) & 2^64-1``
        embedding of :func:`_default_hash`)."""
        if arr.dtype == np.uint64:
            return arr.view(np.int64)
        return arr.astype(np.int64, copy=False)

    def _native_scan(self, arr: np.ndarray) -> bool:
        """Full-stream scan in the C helper (scramble + threshold compare
        per element, binary-search insert on the rare accepts).  Returns
        False when a member does not fit the array's bit view — the caller
        then takes the numpy path.  Selection is identical to per-element
        processing (dedup by (hash, value-bits)); only hash-tie ordering
        between distinct values (~2^-64 per pair) can differ."""
        import ctypes

        from ..native import load_bottomk_library

        lib = load_bottomk_library()
        member_dtype = np.uint64 if arr.dtype.kind == "u" else np.int64
        members = self._member_array(member_dtype)
        if members is None:
            return False  # some member doesn't fit this dtype's bit view
        # serialize (hash, value) sorted by hash ascending
        entries = sorted((-nh, v) for (nh, _t, v) in self._heap)
        entry_hash = np.full(self._k, np.iinfo(np.uint64).max, np.uint64)
        entry_val = np.zeros(self._k, np.int64)
        size = len(entries)
        for i, (h, v) in enumerate(entries):
            entry_hash[i] = h
            entry_val[i] = np.asarray(v, member_dtype).view(np.int64)
        bits = np.ascontiguousarray(self._as_bits64(arr))
        size_c = ctypes.c_int32(size)
        rc = lib.rsv_bottomk_scan(
            bits.ctypes.data_as(ctypes.c_void_p),
            bits.shape[0],
            ctypes.c_uint64(self._salts[0]),
            ctypes.c_uint64(self._salts[1]),
            entry_hash.ctypes.data_as(ctypes.c_void_p),
            entry_val.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(size_c),
            self._k,
        )
        if rc < 0:
            raise RuntimeError("rsv_bottomk_scan refused its arguments")
        self._count += int(bits.shape[0])
        new_size = int(size_c.value)
        vals = entry_val[:new_size].view(member_dtype)
        self._heap = []
        self._members = set()
        for i in range(new_size):
            v = int(vals[i])
            self._tie += 1
            self._heap.append((-int(entry_hash[i]), self._tie, v))
            self._members.add(v)
        heapq.heapify(self._heap)
        # sorted ascending: the last entry is the max retained hash
        self._max_hash = int(entry_hash[new_size - 1]) if new_size else -1
        return True

    def _sample_all_fast(self, arr: np.ndarray) -> None:
        """Chunked vectorized scan.  Exactness rests on two properties of
        bottom-k: the threshold only ever *tightens*, so a vectorized
        below-threshold prefilter against the chunk-entry threshold is a
        complete candidate superset; and the retained set is insertion-order
        independent (it is "the k smallest distinct scrambled hashes so
        far"), so candidates may be processed hash-ascending rather than in
        arrival order.  Each chunk: prefilter, dedup (a value determines its
        hash, so ``np.unique`` on values dedups hash-consistently), drop
        existing members, then insert hash-ascending with an early break at
        the live threshold.  Chunks grow geometrically: as the threshold
        tightens, ever-larger spans are disposed of by one array compare.

        The C scan subsumes this whole routine at pointer-walk speed; it is
        tried first unless ``native=False``."""
        if self._native and self._native_scan(arr):
            return
        hashes = scramble64_array(arr, self._salts)
        n = arr.shape[0]
        off = 0
        # fill phase: per-element until the heap holds k distinct values
        while len(self._heap) < self._k and off < n:
            self._count += 1
            self._insert(int(arr[off]), int(hashes[off]))
            off += 1
        chunk = 4 * self._k
        member_arr: Optional[np.ndarray] = None
        while off < n:
            end = min(off + chunk, n)
            self._count += end - off
            cand = np.nonzero(
                hashes[off:end] < np.uint64(self._max_hash)
            )[0]
            if cand.size:
                uvals, first = np.unique(arr[off:end][cand], return_index=True)
                uhash = hashes[off:end][cand][first]
                if member_arr is None:
                    member_arr = self._member_array(arr.dtype)
                    if member_arr is None:
                        # a member doesn't fit arr.dtype (e.g. a negative
                        # int sampled before a uint64 stream): finish this
                        # call on the exact per-element route
                        self._count -= end - off  # sample() re-counts
                        for j in range(off, n):
                            self.sample(int(arr[j]))
                        return
                fresh = ~np.isin(uvals, member_arr)
                uvals, uhash = uvals[fresh], uhash[fresh]
                order = np.argsort(uhash)
                changed = False
                for i in order:
                    h = int(uhash[i])
                    if h >= self._max_hash:
                        break  # hash-ascending: the rest can't be accepted
                    self._insert(int(uvals[i]), h)
                    changed = True
                if changed:
                    member_arr = self._member_array(arr.dtype)
            off = end
            chunk = min(chunk * 2, 1 << 20)

    def _member_array(self, dtype: np.dtype) -> Optional[np.ndarray]:
        """The membership set as a ``dtype`` array, or None when some member
        is not representable in ``dtype`` (caller must take the per-element
        route — ``np.isin`` against a lossy conversion would be wrong).

        Range-checks explicitly: ``np.fromiter`` raises for out-of-range
        Python ints but silently *wraps* numpy scalars (e.g. ``np.int64(-5)``
        into uint64), which would corrupt the dedup."""
        info = np.iinfo(dtype)
        out = np.empty(len(self._members), dtype=dtype)
        for i, v in enumerate(self._members):
            iv = int(v)
            if iv < info.min or iv > info.max:
                return None
            out[i] = iv
        return out

    def _insert(self, value: Any, h: int) -> None:
        """Heap/membership insert of a pre-scrambled (value, hash) pair —
        the tail of :meth:`sample` after the threshold compare."""
        if len(self._heap) < self._k:
            if value not in self._members:
                self._tie += 1
                heapq.heappush(self._heap, (-h, self._tie, value))
                self._members.add(value)
                self._max_hash = max(self._max_hash, h)
        elif h < self._max_hash and value not in self._members:
            _, _, evicted = heapq.heapreplace(
                self._heap, (-h, self._tie + 1, value)
            )
            self._tie += 1
            self._members.discard(evicted)
            self._members.add(value)
            self._max_hash = -self._heap[0][0]

    def result(self) -> List[Any]:
        """The sampled distinct values.  Order is not specified by the
        contract (``Sampler.scala:411``); we return them sorted by scrambled
        hash so the output is deterministic and directly comparable with the
        device kernel's sorted bottom-k."""
        return [v for (_nh, _t, v) in sorted(self._heap, key=lambda e: -e[0])]

    def threshold(self) -> int:
        """Current max retained hash (testing hook)."""
        return self._max_hash
