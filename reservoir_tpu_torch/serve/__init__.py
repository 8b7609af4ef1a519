"""The serving plane over the engine and the bridge (the port's copy of the
JAX package's ``serve``, its first third).

- :mod:`.sessions`: :class:`SessionTable` leases reservoir rows of the
  batched engine to opaque session keys (open, route, close, TTL and LRU
  eviction, generations, counter-keyed sub-keys);
- :mod:`.service`: :class:`ReservoirService`, per-session ingest coalesced
  into the bridge's interleaved path, admission control, live snapshots and
  crash recovery from a journaled session map;
- :mod:`.autotune`: the knob cache keyed by workload fingerprint and the
  :class:`ServiceTuner` that nudges the live knobs from SLO verdicts.

The JAX package's replica, HA, shard and cluster modules are not ported
yet (``ROADMAP.md``, A.2b and A.2c).
"""

from .autotune import (
    DEFAULT_KNOBS,
    KnobBounds,
    ServiceKnobs,
    ServiceTuner,
    TuneDecision,
    lookup_knobs,
    record_knobs,
)
from .service import ReservoirService
from .sessions import Session, SessionTable

__all__ = [
    "ReservoirService",
    "ServiceKnobs",
    "ServiceTuner",
    "TuneDecision",
    "KnobBounds",
    "DEFAULT_KNOBS",
    "lookup_knobs",
    "record_knobs",
    "Session",
    "SessionTable",
]
