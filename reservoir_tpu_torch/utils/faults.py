"""Deterministic fault-injection plane (the port's copy of the JAX
package's ``utils/faults.py``).

Named injection sites sit on the hot paths (:data:`SITES`), and a
:class:`FaultPlane` holds a seeded schedule of :class:`FaultRule` entries
saying which site fails, when (step predicate), how (exception type or a
delay simulating a hung device), and how often.

Activation is explicit and doubly scoped:

- **globally** via :func:`install` / the :func:`active` context manager /
  the ``RESERVOIR_FAULTS`` env spec (parsed once at import;
  :func:`install_from_env` re-reads it), reaching every site including
  ``checkpoint.write`` and ``native.staging``;
- **per bridge or engine** by passing a plane to
  :class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge` /
  :class:`~reservoir_tpu_torch.engine.ReservoirEngine` (``faults=``),
  reaching the ``bridge.*`` and ``engine.update`` sites of that instance
  only.

When nothing is installed, every site is a no-op: :func:`fire` is one
module-global load and an ``is None`` test — no allocation, no locking, no
counter traffic.

Env spec grammar (semicolon-separated rules; keys after the site are
comma-separated ``key=value`` pairs)::

    RESERVOIR_FAULTS="seed=7;bridge.dispatch:exc=TransientDeviceError,times=2;engine.update:exc=RuntimeError,after=10,every=5"

``exc`` names an exception from :mod:`reservoir_tpu_torch.errors`, a
builtin, or ``none`` for a delay-only rule (a simulated hang for the
watchdog).
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

__all__ = [
    "SITES",
    "InjectedFault",
    "FaultRule",
    "FaultPlane",
    "fire",
    "install",
    "uninstall",
    "active",
    "install_from_env",
    "from_spec",
]

#: The injection sites the port fires: ``bridge.demux`` on the stream
#: bridge's push paths (producer thread), ``bridge.dispatch`` before each
#: device flush (worker thread when pipelined), ``engine.update`` before
#: each engine tile update (the reference's ``engine.pallas``, its trigger
#: to demote a Pallas kernel to XLA, has no counterpart: the port never
#: falls back from its kernels), ``native.staging`` on the
#: staging buffer's push and take paths, ``checkpoint.write`` inside the
#: atomic checkpoint writer, and ``serve.ingest`` on the service's
#: per-session ingest.  The HA plane adds ``replica.ship`` (the journal
#: follower's read path), ``replica.apply`` (one shipped tile onto the
#: standby's engine; its state advances only on success, so the next poll
#: retries the same tile) and ``ha.heartbeat`` (the primary's beat and the
#: controller's read: a failing writer goes stale and is promoted past).
#: The sharded plane adds ``shard.route`` (a cluster's session-to-shard
#: resolution, surfaced as a typed per-call error) and ``shard.promote``
#: (a shard unit's promotion: a failure leaves the standby re-promotable).
#: A rule may name any site; one the port never fires simply never fires.
SITES: Tuple[str, ...] = (
    "bridge.dispatch",
    "bridge.demux",
    "engine.update",
    "checkpoint.write",
    "native.staging",
    "serve.ingest",
    "replica.ship",
    "replica.apply",
    "ha.heartbeat",
    "shard.route",
    "shard.promote",
)


class InjectedFault(RuntimeError):
    """Default exception raised by a rule that names no ``exc``."""


@dataclasses.dataclass
class FaultRule:
    """One scheduled failure at one site.

    Attributes:
      site: injection-site name (one of :data:`SITES`; unknown names are
        legal — they simply never fire — so specs survive site renames).
      exc: exception class (or factory taking the message) to raise, or
        ``None`` for a delay-only rule (simulated hang, nothing raised).
      after: 0-based hit index at which the rule becomes eligible.
      every: fire on every ``every``-th eligible hit (1 = each one).
      times: maximum number of fires (``None`` = unlimited).
      p: per-eligible-hit fire probability, drawn from the plane's seeded
        RNG — deterministic for a fixed plane seed and hit sequence.
      delay: seconds to sleep before raising (or before returning, when
        ``exc`` is None) — models slow/hung devices for the watchdog.
      message: override for the raised exception's message.
    """

    site: str
    exc: Optional[Union[type, Callable[[str], BaseException]]] = InjectedFault
    after: int = 0
    every: int = 1
    times: Optional[int] = None
    p: float = 1.0
    delay: float = 0.0
    message: str = ""
    fired: int = dataclasses.field(default=0, init=False)


class FaultPlane:
    """A seeded schedule of :class:`FaultRule` entries plus per-site hit
    counters.  Thread-safe: sites fire from the producer thread, the flush
    worker, and watchdog timers concurrently."""

    def __init__(self, rules: Optional[List[FaultRule]] = None, seed: int = 0) -> None:
        self._rules: Dict[str, List[FaultRule]] = {}
        for rule in rules or []:
            self._rules.setdefault(rule.site, []).append(rule)
        self._hits: Dict[str, int] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, rule: FaultRule) -> "FaultPlane":
        with self._lock:
            self._rules.setdefault(rule.site, []).append(rule)
        return self

    def hits(self) -> Dict[str, int]:
        """Per-site hit counts observed while this plane was active."""
        with self._lock:
            return dict(self._hits)

    def reset(self) -> None:
        with self._lock:
            self._hits.clear()
            for rules in self._rules.values():
                for rule in rules:
                    rule.fired = 0

    def fire(self, site: str) -> None:
        """Record a hit at ``site`` and raise/delay per the matching rules."""
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            due: Optional[FaultRule] = None
            for rule in self._rules.get(site, ()):
                if hit < rule.after:
                    continue
                if (hit - rule.after) % rule.every:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                due = rule
                break
        if due is None:
            return
        if due.delay:
            time.sleep(due.delay)
        if due.exc is not None:
            raise due.exc(
                due.message or f"injected fault at {site} (hit {hit})"
            )


_PLANE: Optional[FaultPlane] = None


def fire(site: str, plane: Optional[FaultPlane] = None) -> None:
    """Injection point.  ``plane`` is an instance-scoped plane (a bridge's or
    engine's own); when absent, the globally installed plane applies.  With
    neither, this is the zero-overhead no-op path: one global load, one
    ``is None`` test, return."""
    if plane is None:
        plane = _PLANE
        if plane is None:
            return
    plane.fire(site)


def install(plane: FaultPlane) -> FaultPlane:
    """Activate ``plane`` globally (every site in every component)."""
    global _PLANE
    _PLANE = plane
    return plane


def uninstall() -> None:
    global _PLANE
    _PLANE = None


@contextlib.contextmanager
def active(plane: FaultPlane):
    """``with faults.active(plane): ...`` — scoped global activation."""
    global _PLANE
    prev = _PLANE
    _PLANE = plane
    try:
        yield plane
    finally:
        _PLANE = prev


def _resolve_exc(name: str) -> Optional[type]:
    if name.lower() in ("none", "hang"):
        return None
    from .. import errors

    exc = getattr(errors, name, None) or getattr(builtins, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        raise ValueError(f"RESERVOIR_FAULTS: unknown exception type {name!r}")
    return exc


def from_spec(spec: str) -> FaultPlane:
    """Parse a ``RESERVOIR_FAULTS`` spec string into a plane (grammar in the
    module docstring)."""
    rules: List[FaultRule] = []
    seed = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        site, _, kvs = part.partition(":")
        kwargs: Dict[str, object] = {}
        for kv in filter(None, (s.strip() for s in kvs.split(","))):
            key, _, value = kv.partition("=")
            if key == "exc":
                kwargs["exc"] = _resolve_exc(value)
            elif key in ("after", "every", "times"):
                kwargs[key] = int(value)
            elif key in ("p", "delay"):
                kwargs[key] = float(value)
            elif key == "message":
                kwargs["message"] = value
            else:
                raise ValueError(f"RESERVOIR_FAULTS: unknown rule key {key!r}")
        rules.append(FaultRule(site.strip(), **kwargs))
    return FaultPlane(rules, seed=seed)


def install_from_env() -> Optional[FaultPlane]:
    """(Re-)read ``RESERVOIR_FAULTS`` and install the plane it describes;
    uninstalls when the variable is empty/unset.  Called once at import so a
    spec in the environment reaches child processes with no code change."""
    spec = os.environ.get("RESERVOIR_FAULTS")
    if not spec:
        uninstall()
        return None
    return install(from_spec(spec))


install_from_env()
