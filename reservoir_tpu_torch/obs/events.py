"""Structured JSON-lines event log with correlation fields (the port's
copy of the JAX package's ``obs/events.py``).

Every record is one JSON object per line carrying ``ts``, ``event``, and
whatever correlation fields the site knows — ``flush_seq``, ``epoch``,
``site`` — so a causal chain (a fence refusal, a recovery, a failed
checkpoint) can be joined offline.

Write discipline: append + flush per record (a process crash loses
nothing already written; an OS crash may tear the final line, which
:func:`read_events` tolerates), a single ``write()`` call per record so
concurrent emitters interleave at line granularity.

Rate limiting is built in (token bucket, default 200 events/s with an
equal burst): a hot loop cannot turn the event log into the bottleneck it
is meant to observe.  Dropped records are counted per event name and a
``telemetry.dropped`` summary record is written when the storm passes, so
the tail of the log always says what it is missing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .registry import get as _registry_get

__all__ = ["EventLog", "read_events"]


class EventLog:
    """Append-only, rate-limited JSON-lines event writer (thread-safe)."""

    def __init__(
        self,
        path: str,
        *,
        rate_limit_hz: float = 200.0,
        burst: Optional[float] = None,
        clock=time.time,
    ) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self.path = path
        self._clock = clock
        self._rate = float(rate_limit_hz)
        self._burst = float(burst) if burst is not None else max(
            1.0, self._rate
        )
        self._tokens = self._burst
        self._last_refill = clock()
        self._dropped: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    @property
    def dropped(self) -> Dict[str, int]:
        """Per-event-name drop counts since the last summary record."""
        with self._lock:
            return dict(self._dropped)

    def _admit_locked(self, event: str, now: float) -> bool:
        """Token-bucket admission (caller holds the lock)."""
        if self._rate <= 0:
            return True
        self._tokens = min(
            self._burst, self._tokens + (now - self._last_refill) * self._rate
        )
        self._last_refill = now
        if self._tokens < 1.0:
            self._dropped[event] = self._dropped.get(event, 0) + 1
            # the live half of the drop accounting: the in-stream
            # telemetry.dropped summary only lands when the storm passes,
            # but a dashboard must see the log lying by omission WHILE it
            # lies — so every drop also increments a
            # registry counter (Counter holds its own lock and never takes
            # this one, so the ordering is cycle-free)
            reg = _registry_get()
            if reg is not None:
                reg.counter("telemetry.dropped").inc()
            return False
        self._tokens -= 1.0
        return True

    def emit(self, event: str, **fields) -> bool:
        """Write one record; returns False when rate-limited (the drop is
        counted and summarized on the next admitted record)."""
        now = self._clock()
        with self._lock:
            if self._fh.closed:
                return False
            if not self._admit_locked(event, now):
                return False
            lines = ""
            if self._dropped:
                lines += json.dumps(
                    {
                        "ts": now,
                        "event": "telemetry.dropped",
                        "counts": self._dropped,
                    },
                    sort_keys=True,
                ) + "\n"
                self._dropped = {}
            record = {"ts": now, "event": event}
            record.update(fields)
            lines += json.dumps(record, sort_keys=True, default=str) + "\n"
            self._fh.write(lines)
            self._fh.flush()
        return True

    def close(self) -> None:
        with self._lock:
            if self._fh.closed:
                return
            if self._dropped:
                # a storm that never subsided before shutdown would lose
                # its drop counts: flush the summary the next admitted
                # record would have carried
                self._fh.write(
                    json.dumps(
                        {
                            "ts": self._clock(),
                            "event": "telemetry.dropped",
                            "counts": self._dropped,
                        },
                        sort_keys=True,
                    )
                    + "\n"
                )
                self._dropped = {}
            self._fh.close()

    def __del__(self) -> None:
        fh = getattr(self, "_fh", None)
        if fh is not None and not fh.closed:
            try:
                fh.close()
            except OSError:
                pass


def read_events(path: str) -> List[dict]:
    """Parse an event log.  A torn FINAL line (crash mid-append) is
    dropped — the same tolerance the session journal extends to its tail;
    corruption anywhere earlier raises (the file did not get that way by
    crashing, and silently skipping records would hide it) naming the
    line number AND the byte offset of the bad record, so ``dd``/``tail
    -c`` can jump straight to it in a multi-gigabyte log."""
    with open(path, "rb") as fh:
        data = fh.read()
    raw_lines = data.split(b"\n")
    if raw_lines and raw_lines[-1] == b"":
        raw_lines.pop()  # the trailing newline of a clean final record
    records: List[dict] = []
    offset = 0
    for i, raw in enumerate(raw_lines):
        line_offset = offset
        offset += len(raw) + 1
        line = raw.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            if i == len(raw_lines) - 1:
                break  # torn tail: the event it described never landed
            raise ValueError(
                f"{path!r}: corrupt event log at line {i + 1} "
                f"(byte offset {line_offset}): {e}"
            ) from None
    return records
