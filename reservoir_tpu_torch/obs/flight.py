"""Flight recorder and atomic postmortem bundles (the port's copy of the
JAX package's ``obs/flight.py``).

A :class:`FlightRecorder` is a fixed-size ring of the most recent
structured events and notes — always on once installed, at bounded memory,
appended under the GIL's deque atomicity (no lock on the record path) —
plus :meth:`dump`: one atomic JSON **postmortem bundle** carrying the span
tree, the event tail, the registry's snapshot, the epoch of the checkpoint
directory in question, and the recorder's config.

Bundles are triggered by the failure paths that matter — in the port, the
bridge's flush-watchdog trip and its ``FencedError`` — through
:meth:`trigger`, which rate-limits per reason so a flapping failure cannot
fill the disk.

Installation follows the plane's discipline: a module-global
:func:`install`/:func:`uninstall` pair; every trigger site gates on
``get() is None``.  Installing also taps
:func:`reservoir_tpu_torch.obs.registry.emit` so every structured event lands
in the ring even when no event log is attached.  Recording is purely
observational: journals and snapshots are byte-identical with the recorder
installed or not.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from . import registry as _registry

__all__ = [
    "FlightRecorder",
    "install",
    "uninstall",
    "get",
    "recording",
    "read_bundle",
]

_BUNDLE_PREFIX = "postmortem-"


def _sanitize(reason: str) -> str:
    return "".join(
        c if (c.isalnum() or c in "-_") else "_" for c in reason
    )[:48] or "manual"


class FlightRecorder:
    """Bounded ring of recent events + postmortem bundle writer.

    Args:
      dir: where bundles land (created if missing).
      capacity: ring size (most recent events/notes retained).
      keep: bundles retained on disk — older ones are pruned after each
        dump, so a chaos soak cannot fill the volume.
      min_interval_s: per-reason trigger rate limit; a suppressed trigger
        is counted (:attr:`suppressed`), never an error.
      clock: wall-clock source (injectable for tests).
      config: deployment facts worth having in every bundle
        (``checkpoint_dir`` additionally lets :meth:`dump` read the
        fence epoch at dump time).
    """

    def __init__(
        self,
        dir: str,
        *,
        capacity: int = 2048,
        keep: int = 8,
        min_interval_s: float = 5.0,
        clock=time.time,
        config: Optional[dict] = None,
    ) -> None:
        os.makedirs(dir, exist_ok=True)
        self.dir = dir
        self._ring: deque = deque(maxlen=int(capacity))
        self._keep = max(1, int(keep))
        self._min_interval = float(min_interval_s)
        self._clock = clock
        self.config = dict(config or {})
        self._seq = itertools.count(1)
        self._last_trigger: Dict[str, float] = {}
        self._dump_lock = threading.Lock()
        self._dumping = False
        self.dumps = 0
        self.suppressed = 0

    # ------------------------------------------------------------ recording

    def record(self, kind: str, payload: dict) -> None:
        """Append one ring record (``deque.append`` is atomic — no lock)."""
        self._ring.append((self._clock(), kind, payload))

    def _tap_event(self, event: str, fields: dict) -> None:
        """The :func:`registry.emit` tap — every structured event, even
        ones the rate-limited event log drops, lands in the ring."""
        record = {"event": event}
        record.update(fields)
        self._ring.append((self._clock(), "event", record))

    def note(self, name: str, **fields: Any) -> None:
        """A free-form breadcrumb (instrument snapshots, chaos actions)."""
        record = {"note": name}
        record.update(fields)
        self._ring.append((self._clock(), "note", record))

    def tail(self) -> List[dict]:
        """The ring contents, oldest first, as JSON-able dicts."""
        return [
            {"ts": ts, "kind": kind, **payload}
            for ts, kind, payload in list(self._ring)
        ]

    # -------------------------------------------------------------- dumping

    def trigger(self, reason: str, **context: Any) -> Optional[str]:
        """Rate-limited auto-dump: at most one bundle per ``reason`` per
        ``min_interval_s``.  Returns the bundle path, or ``None`` when
        suppressed.  Never raises on the caller's (failure) path — a
        postmortem writer that can crash the patient is worse than none."""
        if self._dumping:
            # re-entrant trigger: assembling a bundle can itself evaluate
            # the SLO plane (json_snapshot), whose page transition must
            # not recurse into a second dump under the dump lock
            self.suppressed += 1
            return None
        now = self._clock()
        last = self._last_trigger.get(reason)
        if last is not None and (now - last) < self._min_interval:
            self.suppressed += 1
            return None
        self._last_trigger[reason] = now
        try:
            return self.dump(reason=reason, **context)
        except Exception:
            return None

    def dump(
        self,
        reason: str = "manual",
        path: Optional[str] = None,
        **context: Any,
    ) -> str:
        """Write one postmortem bundle atomically (temp file + rename);
        returns its path.  The bundle carries everything the viewer needs
        with no live process: span list (tree-reconstructable), event
        tail, telemetry snapshot + latency attribution, the epoch, and
        the recorder's config + context."""
        with self._dump_lock:
            self._dumping = True
            try:
                return self._dump_locked(reason, path, context)
            finally:
                self._dumping = False

    def _dump_locked(
        self, reason: str, path: Optional[str], context: dict
    ) -> str:
        seq = next(self._seq)
        bundle: dict = {
            "ts": self._clock(),
            "reason": reason,
            "seq": seq,
            "context": {k: v for k, v in context.items()},
            "config": dict(self.config),
            "events": self.tail(),
        }
        from . import trace as _trace

        tr = _trace.get()
        if tr is not None:
            bundle["tracer"] = tr.snapshot()
            bundle["spans"] = [s.to_dict() for s in tr.spans()]
            bundle["attribution"] = _trace.attribution(
                tr.spans(),
                root=str(self.config.get("root_span", "bridge.dispatch")),
            )
        reg = _registry.get()
        if reg is not None:
            bundle["telemetry"] = reg.snapshot()
        ckpt = context.get("checkpoint_dir") or self.config.get(
            "checkpoint_dir"
        )
        if ckpt:
            try:
                from ..utils.checkpoint import read_epoch

                bundle["epoch"] = read_epoch(str(ckpt))
            except Exception:
                pass
        if path is None:
            path = os.path.join(
                self.dir,
                f"{_BUNDLE_PREFIX}{seq:04d}-{_sanitize(reason)}.json",
            )
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp.pm")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, default=str)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.dumps += 1
        self._prune()
        _registry.emit("flight.dump", site="flight", reason=reason, path=path)
        return path

    def bundles(self) -> List[str]:
        """Bundle paths in this recorder's dir, oldest first."""
        try:
            names = sorted(
                n
                for n in os.listdir(self.dir)
                if n.startswith(_BUNDLE_PREFIX) and n.endswith(".json")
            )
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _prune(self) -> None:
        paths = self.bundles()
        for p in paths[: max(0, len(paths) - self._keep)]:
            with contextlib.suppress(OSError):
                os.unlink(p)


def read_bundle(path: str) -> dict:
    """Parse one postmortem bundle (plain JSON; the viewer's loader)."""
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


# ---------------------------------------------------------------- activation

_FLIGHT: Optional[FlightRecorder] = None


def get() -> Optional[FlightRecorder]:
    """The installed recorder, or ``None`` (the default).  Trigger sites
    gate on this: one global load, one ``is None`` test."""
    return _FLIGHT


def install(
    recorder: Optional[FlightRecorder] = None, *, dir: Optional[str] = None,
    **kwargs: Any,
) -> FlightRecorder:
    """Install a recorder process-wide (constructing one at ``dir`` when
    not given) and tap :func:`registry.emit` into its ring."""
    global _FLIGHT
    if recorder is None:
        if dir is None:
            raise ValueError("install() needs a recorder or a dir")
        recorder = FlightRecorder(dir, **kwargs)
    _FLIGHT = recorder
    _registry._set_event_tap(recorder._tap_event)
    return recorder


def uninstall() -> None:
    """Remove the recorder and its event tap: every trigger site reverts
    to the zero-overhead no-op path."""
    global _FLIGHT
    _FLIGHT = None
    _registry._set_event_tap(None)


@contextlib.contextmanager
def recording(
    recorder: Optional[FlightRecorder] = None, **kwargs: Any
) -> Iterator[FlightRecorder]:
    """``with flight.recording(dir=...) as fr: ...`` — scoped (tests)."""
    global _FLIGHT
    prev = _FLIGHT
    fr = install(recorder, **kwargs)
    try:
        yield fr
    finally:
        _FLIGHT = prev
        _registry._set_event_tap(
            prev._tap_event if prev is not None else None
        )
