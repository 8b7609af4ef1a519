"""The counter blocks of the stream bridge, the serving plane and its HA
plane (the port's copies of the JAX package's ``BridgeMetrics``,
``ServiceMetrics`` and ``HAMetrics``, with the same ``snapshot()`` keys).

The counters say whether the host feed or the device sets the pace:
elements consumed, flushes dispatched, wall-clock throughput, and the busy
time of each stage.  The port never demotes a kernel, so ``demotions``
stays 0.  The skip gate's counters count on a gated bridge: gated
dispatches, staged tiles and pushed slices it took (``gate_buffered_flushes``),
bytes shipped and elided, and the replica's evaluation time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from ..obs import registry as _obs

__all__ = ["BridgeMetrics", "HAMetrics", "ServiceMetrics"]


@dataclasses.dataclass
class BridgeMetrics:
    """Mutable counter block owned by one bridge (single-writer, like the
    bridge itself — not synchronized)."""

    elements: int = 0
    flushes: int = 0
    flushed_elements: int = 0
    completions: int = 0
    failures: int = 0
    # the robustness plane: transient flush retries run by the pipeline
    # worker, watchdog trips, recoveries, auto-checkpoints; the worker and
    # watchdog threads increment retries/watchdog_trips, a benign race with
    # snapshot reads (telemetry, not control flow)
    retries: int = dataclasses.field(default=0, init=False)
    watchdog_trips: int = dataclasses.field(default=0, init=False)
    recoveries: int = dataclasses.field(default=0, init=False)
    demotions: int = dataclasses.field(default=0, init=False)
    checkpoints: int = dataclasses.field(default=0, init=False)
    # durability: fsyncs of a durability="fsync" journal (zero when
    # buffered); flush/checkpoint attempts refused by the epoch fence
    journal_syncs: int = dataclasses.field(default=0, init=False)
    fenced_writes: int = dataclasses.field(default=0, init=False)
    # the skip gate's counters: gated dispatches; chunks the gate took
    # whole (staged tiles and pushed slices); bytes shipped (candidate
    # tiles with their counts, and tiles that overflowed the gate) and
    # elided; the replica's evaluation time
    gated_dispatches: int = dataclasses.field(default=0, init=False)
    gate_buffered_flushes: int = dataclasses.field(default=0, init=False)
    gate_bytes_shipped: int = dataclasses.field(default=0, init=False)
    gate_bytes_elided: int = dataclasses.field(default=0, init=False)
    gate_eval_s: float = dataclasses.field(default=0.0, init=False)
    # per-stage busy time: demux = host scatter into the staging tile;
    # drain = the fill-count read of a flush (``take``); dispatch = the
    # device half of a flush (copy to the card, kernel launch, the wait for
    # the copy), accumulated on the worker thread when pipelined
    demux_s: float = 0.0
    drain_s: float = 0.0
    dispatch_s: float = 0.0
    # demux worker count (native staging pool; 1 = serial or numpy)
    demux_threads: int = dataclasses.field(default=1, init=False)
    # beyond the JAX package's block (read as attributes, not in
    # snapshot()): the flush copies' card time from CUDA events, and the
    # producer's time blocked in the pipeline's reserve()
    copy_s: float = dataclasses.field(default=0.0, init=False)
    reserve_s: float = dataclasses.field(default=0.0, init=False)
    _t0: Optional[float] = None

    def __post_init__(self) -> None:
        _obs.register_block("bridge", self)

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time view, including elements/sec since first element
        and the per-stage decomposition (elem/s through each host stage)."""
        elapsed = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0

        def rate(busy_s: float, n: int) -> float:
            return (n / busy_s) if busy_s > 0 else 0.0

        return {
            "elements": self.elements,
            "flushes": self.flushes,
            "flushed_elements": self.flushed_elements,
            "completions": self.completions,
            "failures": self.failures,
            "retries": self.retries,
            "watchdog_trips": self.watchdog_trips,
            "recoveries": self.recoveries,
            "demotions": self.demotions,
            "checkpoints": self.checkpoints,
            "journal_syncs": self.journal_syncs,
            "fenced_writes": self.fenced_writes,
            "gated_dispatches": self.gated_dispatches,
            "gate_buffered_flushes": self.gate_buffered_flushes,
            "gate_bytes_shipped": self.gate_bytes_shipped,
            "gate_bytes_elided": self.gate_bytes_elided,
            "gate_eval_s": self.gate_eval_s,
            "gate_skip_frac": (
                self.gate_bytes_elided
                / (self.gate_bytes_shipped + self.gate_bytes_elided)
                if (self.gate_bytes_shipped + self.gate_bytes_elided)
                else 0.0
            ),
            "elapsed_s": elapsed,
            "elements_per_sec": (self.elements / elapsed) if elapsed > 0 else 0.0,
            "stages": {
                "demux_s": self.demux_s,
                "drain_s": self.drain_s,
                "dispatch_s": self.dispatch_s,
                "demux_threads": self.demux_threads,
                "demux_elem_per_s": rate(self.demux_s, self.elements),
                "drain_elem_per_s": rate(self.drain_s, self.flushed_elements),
                "dispatch_elem_per_s": rate(
                    self.dispatch_s, self.flushed_elements
                ),
            },
        }


@dataclasses.dataclass
class ServiceMetrics:
    """Counter block of one
    :class:`~reservoir_tpu_torch.serve.service.ReservoirService` (single
    writer; the bridge underneath keeps its own).

    ``sessions_open`` is the live lease count; ``evictions`` counts TTL/LRU
    removals (``closes`` are explicit); ``recycles`` counts rows re-leased
    to a new tenant (each one a row reset); ``snapshot_hits`` /
    ``snapshot_misses`` split snapshot reads by whether the
    ``flushed_seq``-keyed host cache served them; ``rejections`` counts
    admission control's :class:`~reservoir_tpu_torch.errors.ServiceSaturated`.
    """

    sessions_open: int = 0
    sessions_opened: int = 0
    closes: int = 0
    evictions: int = 0
    recycles: int = 0
    snapshot_hits: int = 0
    snapshot_misses: int = 0
    rejections: int = 0
    ingested_elements: int = 0
    recoveries: int = 0

    def __post_init__(self) -> None:
        _obs.register_block("serve", self)

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time dict view."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HAMetrics:
    """Counter block of the HA plane: one for a
    :class:`~reservoir_tpu_torch.serve.replica.StandbyReplica` and its
    :class:`~reservoir_tpu_torch.serve.ha.FailoverController`, which share
    it; the primary's ``HeartbeatWriter`` keeps its own.

    ``lag_seq``/``lag_s`` are the replication lag at the last poll: flush
    sequences the standby has not applied yet, and seconds since it was
    last provably caught up.  ``promotions`` counts failovers;
    ``fenced_writes`` writes refused because a newer epoch was persisted;
    ``ship_errors``/``apply_errors`` split replication failures into
    reading the journal and applying a tile (both retried on the next poll,
    so they mean lag, never a wrong state); ``bootstraps`` counts
    checkpoint-shipping bootstraps (1 at construction, one more whenever a
    journal rotation outran the tail).
    """

    lag_seq: int = 0
    lag_s: float = 0.0
    promotions: int = 0
    fenced_writes: int = 0
    ship_errors: int = 0
    apply_errors: int = 0
    applied_tiles: int = 0
    applied_ops: int = 0
    bootstraps: int = 0
    heartbeats: int = 0

    def __post_init__(self) -> None:
        _obs.register_block("ha", self)

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time dict view."""
        return dataclasses.asdict(self)
