"""The serving plane over the engine and the bridge (the port's copy of the
JAX package's ``serve``, all of it).

- :mod:`.sessions`: :class:`SessionTable` leases reservoir rows of the
  batched engine to opaque session keys (open, route, close, TTL and LRU
  eviction, generations, counter-keyed sub-keys);
- :mod:`.service`: :class:`ReservoirService`, per-session ingest coalesced
  into the bridge's interleaved path, admission control, live snapshots and
  crash recovery from a journaled session map;
- :mod:`.autotune`: the knob cache keyed by workload fingerprint and the
  :class:`ServiceTuner` that nudges the live knobs from SLO verdicts;
- :mod:`.replica`: :class:`JournalFollower` tails a primary's flush journal
  and :class:`StandbyReplica` keeps a warm copy of its service, applying
  each shipped tile with one launch of the mode's update kernel;
- :mod:`.ha`: :class:`HeartbeatWriter`, :func:`read_heartbeat`, and the
  :class:`FailoverController` that turns a stale heartbeat or a wedged
  pipeline into an epoch-fenced promotion (:class:`HealthReport`);
- :mod:`.shard`: :class:`ShardUnit`, one failure domain (a primary, its
  beacon, its standby and controller);
- :mod:`.cluster`: :class:`ShardedReservoirService`, N shard units behind
  the deterministic route :func:`shard_of`, with live migration, per-shard
  failover and merged snapshots across shards.
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
from .cluster import ShardedReservoirService, shard_of
from .ha import FailoverController, HealthReport, HeartbeatWriter, read_heartbeat
from .replica import JournalFollower, StandbyReplica
from .service import ReservoirService
from .sessions import Session, SessionTable
from .shard import ShardUnit

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
    "ShardUnit",
    "ShardedReservoirService",
    "shard_of",
    "StandbyReplica",
    "JournalFollower",
    "FailoverController",
    "HeartbeatWriter",
    "HealthReport",
    "read_heartbeat",
]
