"""Telemetry of the port (copies of the JAX package's ``obs`` modules that
the stream bridge writes to): the metrics registry with its latency
histograms (:mod:`.registry`), the structured event log (:mod:`.events`),
causal spans (:mod:`.trace`) and the flight recorder (:mod:`.flight`).

Telemetry is off by default: every instrumented hot path costs one
module-global load and an ``is None`` test until :func:`enable` is called::

    from reservoir_tpu_torch import obs

    reg = obs.enable(event_log_path="/tmp/events.jsonl")
    ...  # run traffic
    p50, p99, p999 = reg.histogram("bridge.flush_s").percentiles()
    obs.disable()
"""

from . import flight, trace
from .events import EventLog, read_events
from .flight import FlightRecorder, read_bundle
from .registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    active,
    blocks,
    disable,
    emit,
    enable,
    register_block,
)
from .registry import get as get_registry
from .trace import Span, Tracer, attribution

__all__ = [
    "Counter",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "Tracer",
    "active",
    "attribution",
    "blocks",
    "disable",
    "emit",
    "enable",
    "flight",
    "get_registry",
    "read_bundle",
    "read_events",
    "register_block",
    "trace",
]
