"""The stream bridge's counter block (the port's copy of the JAX package's
``BridgeMetrics``, with the same ``snapshot()`` keys).

The counters say whether the host feed or the device sets the pace:
elements consumed, flushes dispatched, wall-clock throughput, and the busy
time of each stage.  The port never demotes a kernel, so ``demotions``
stays 0; the skip gate is not ported, so the ``gate_*`` counters stay 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from ..obs import registry as _obs

__all__ = ["BridgeMetrics"]


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
    # the skip gate's counters (not ported: always zero)
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
