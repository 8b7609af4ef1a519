"""Session table: lease reservoir rows to opaque tenant session keys.

The port's copy of the JAX package's ``serve/sessions.py``.  The batched
engine runs tens of thousands of independent reservoirs; this table maps
dynamically arriving tenant sessions onto those rows.  It is host-only
bookkeeping, which the service (:mod:`reservoir_tpu_torch.serve.service`)
pairs with engine row resets.

- **free list and generation counters**: each row carries a generation,
  bumped whenever the row is freed.  A :class:`Session` handle is a
  ``(row, generation)`` lease; :meth:`SessionTable.check` refuses a handle
  whose generation moved on
  (:class:`~reservoir_tpu_torch.errors.StaleSessionError`), so a recycled
  row never serves another tenant's read.
- **TTL and LRU eviction**: sessions idle past ``ttl_s`` are evictable
  (:meth:`SessionTable.sweep`), and :meth:`SessionTable.open` on a full
  table evicts the least recently used session.  A sweep costs
  O(expired log n): every touch pushes an ``(expiry, seq, key)`` entry onto
  a lazy-deletion heap, and entries orphaned by a later touch, close or
  eviction are skipped as they are popped.
- **counter-keyed sub-keys**: :meth:`SessionTable.sub_key` folds ``(row,
  generation)`` into a table-level key, ``fold_in(fold_in(key(seed), row),
  generation)``, the JAX package's derivation word for word: the engine is
  never reseeded, yet every re-lease of a row draws afresh, and a recovery
  replay rebuilds the same draws.
"""

from __future__ import annotations

import heapq
import time
from collections import OrderedDict, deque
from typing import Callable, List, Optional, Tuple

import torch

from ..errors import StaleSessionError, UnknownSessionError
from ..ops.rng import key_from_seed
from ..ops.threefry import fold_in_words

__all__ = ["Session", "SessionTable"]


class Session:
    """One live lease: session ``key`` owns reservoir ``row`` at
    ``generation``.  ``elements`` counts ingested elements (the service
    maintains it); ``opened_at``/``last_used`` drive TTL/LRU."""

    __slots__ = (
        "key", "row", "generation", "opened_at", "last_used", "elements"
    )

    def __init__(
        self, key: str, row: int, generation: int, now: float
    ) -> None:
        self.key = key
        self.row = row
        self.generation = generation
        self.opened_at = now
        self.last_used = now
        self.elements = 0

    def __repr__(self) -> str:  # debugging aid, not API
        return (
            f"Session({self.key!r}, row={self.row}, "
            f"gen={self.generation}, elements={self.elements})"
        )


class SessionTable:
    """Lease ``num_rows`` reservoir rows to opaque session keys.

    Args:
      num_rows: rows available for lease (the engine's ``num_reservoirs``).
      ttl_s: idle time after which a session becomes evictable by
        :meth:`sweep` / lazily on :meth:`route` (``None`` disables TTL).
      seed: base seed of the per-lease sub-key schedule (:meth:`sub_key`).
      clock: monotonic time source (injectable for tests).

    Single-writer like the engine and bridge it fronts: wrap calls in your
    own lock for multi-producer use.  Keys must be strings — they are
    journaled as JSON by the service's crash-recovery plane.
    """

    def __init__(
        self,
        num_rows: int,
        *,
        ttl_s: Optional[float] = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if num_rows <= 0:
            raise ValueError("num_rows must be positive")
        self._rows = int(num_rows)
        self._ttl = ttl_s
        self._seed = int(seed)
        self._clock = clock
        self._free: deque = deque(range(self._rows))
        self._gen: List[int] = [0] * self._rows
        # insertion order == recency order (route() moves to end): the
        # front is always the LRU eviction candidate
        self._sessions: "OrderedDict[str, Session]" = OrderedDict()
        # lazy-deletion expiry heap: (last_used + ttl, push_seq, key).  A
        # touch pushes a fresh entry and orphans the old one; sweep skips
        # entries whose expiry no longer matches the session's live
        # last_used + ttl.  Bounded by periodic compaction (_push_expiry)
        self._expiry: List[Tuple[float, int, str]] = []
        self._eseq = 0
        self._base_key: Optional[torch.Tensor] = None  # key words, built lazily

    # ------------------------------------------------------------ introspection

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, key: str) -> bool:
        return key in self._sessions

    @property
    def capacity(self) -> int:
        return self._rows

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def ttl_s(self) -> Optional[float]:
        return self._ttl

    def sessions(self) -> List[Session]:
        """Live sessions in LRU order (least recently used first)."""
        return list(self._sessions.values())

    def generation_of(self, row: int) -> int:
        """Current generation of ``row`` (bumped each time it is freed)."""
        return self._gen[row]

    # ----------------------------------------------------------------- leasing

    def open(
        self, key: str, now: Optional[float] = None
    ) -> Tuple[Session, List[Session]]:
        """Lease a row to ``key``.  Returns ``(session, evicted)`` where
        ``evicted`` lists the LRU sessions removed to make room (at most
        one).  Raises ``ValueError`` for a key that is already open and
        :class:`UnknownSessionError` never — open is the entry point."""
        if not isinstance(key, str):
            raise TypeError(
                f"session keys must be str (journaled as JSON), got "
                f"{type(key).__name__}"
            )
        if key in self._sessions:
            raise ValueError(f"session {key!r} is already open")
        now = self._clock() if now is None else now
        evicted: List[Session] = []
        if not self._free:
            # TTL-expired sessions go first; otherwise the LRU one pays
            expired = self.sweep(now)
            evicted.extend(expired)
            if not self._free:
                lru_key = next(iter(self._sessions))
                evicted.append(self._remove(lru_key))
        row = self._free.popleft()
        sess = Session(key, row, self._gen[row], now)
        self._sessions[key] = sess
        self._push_expiry(sess)
        return sess, evicted

    def route(self, key: str, now: Optional[float] = None) -> Session:
        """Resolve ``key`` to its live session (refreshing LRU recency).

        TTL is a *lease* model, not a hard expiry: an idle session is
        evicted only under row pressure (:meth:`open`) or by an explicit
        :meth:`sweep` — never silently inside a lookup, because every
        eviction must be journalable by the service's crash-recovery
        plane.  Routing to an idle-but-unevicted session revives it."""
        sess = self._sessions.get(key)
        if sess is None:
            raise UnknownSessionError(
                f"session {key!r} is not open (never opened, closed, or "
                "evicted)"
            )
        sess.last_used = self._clock() if now is None else now
        self._sessions.move_to_end(key)
        self._push_expiry(sess)
        return sess

    def check(self, sess: Session) -> None:
        """Validate a held handle: the lease must still be current.  Raises
        :class:`StaleSessionError` when the row's generation moved past the
        handle (the row was freed, and possibly re-leased) — the guard that
        makes a recycled row unable to serve a stale read."""
        live = self._sessions.get(sess.key)
        if live is sess and self._gen[sess.row] == sess.generation:
            return
        raise StaleSessionError(
            f"session {sess.key!r} handle is stale: row {sess.row} is at "
            f"generation {self._gen[sess.row]}, handle holds "
            f"{sess.generation}"
        )

    def close(self, key: str) -> Session:
        """End the lease: the row returns to the free list with its
        generation bumped (any outstanding handle goes stale)."""
        if key not in self._sessions:
            raise UnknownSessionError(f"session {key!r} is not open")
        return self._remove(key)

    def sweep(self, now: Optional[float] = None) -> List[Session]:
        """Evict every TTL-expired session; returns them (empty when TTL is
        disabled).  The service journals each eviction.

        O(expired·log n): pops the expiry heap while its head is past
        ``now``, skipping entries orphaned by a later touch/close (the
        session's live ``last_used + ttl`` no longer matches the popped
        expiry).  Eviction order is expiry order, which for a
        recency-refreshed heap equals LRU order — the same order the old
        full-scan produced."""
        if self._ttl is None:
            return []
        now = self._clock() if now is None else now
        heap, ttl = self._expiry, self._ttl
        evicted: List[Session] = []
        while heap and heap[0][0] < now:
            expiry, _, key = heapq.heappop(heap)
            sess = self._sessions.get(key)
            # exact-float match: the live entry for this session is the one
            # pushed with its current last_used; any earlier push is stale
            if sess is not None and sess.last_used + ttl == expiry:
                evicted.append(self._remove(key))
        return evicted

    def _remove(self, key: str) -> Session:
        sess = self._sessions.pop(key)
        self._gen[sess.row] += 1  # stale handles can never read this row
        self._free.append(sess.row)
        return sess

    def _push_expiry(self, sess: Session) -> None:
        """Push this session's current expiry onto the lazy-deletion heap
        (no-op when TTL is disabled).  Earlier entries for the same key
        become orphans that sweep skips on pop; compaction keeps the heap
        from growing unboundedly under touch-heavy traffic."""
        if self._ttl is None:
            return
        self._eseq += 1
        heapq.heappush(
            self._expiry, (sess.last_used + self._ttl, self._eseq, sess.key)
        )
        # amortized O(1): rebuild from live sessions once orphans dominate
        if len(self._expiry) > max(1024, 8 * len(self._sessions)):
            ttl = self._ttl
            self._expiry = [
                (s.last_used + ttl, i, s.key)
                for i, s in enumerate(self._sessions.values())
            ]
            heapq.heapify(self._expiry)
            self._eseq = len(self._expiry)

    # ---------------------------------------------------------------- sub-keys

    def sub_key(self, row: int, generation: int) -> torch.Tensor:
        """The key words of lease ``(row, generation)``: those of
        ``jr.fold_in(jr.fold_in(jr.key(seed), row), generation)``, as a
        ``[2]`` int64 tensor of uint32 words (what
        :meth:`~reservoir_tpu_torch.engine.ReservoirEngine.reset_rows`
        takes).  Pure counter derivation, no mutable RNG state: a recovery
        replay that sees the same journaled ``(row, generation)`` pairs
        rebuilds the same fresh-row draws."""
        if self._base_key is None:
            self._base_key = key_from_seed(self._seed)
        k1, k2 = fold_in_words(self._base_key[0], self._base_key[1], int(row))
        k1, k2 = fold_in_words(k1, k2, int(generation))
        return torch.stack([k1, k2])
