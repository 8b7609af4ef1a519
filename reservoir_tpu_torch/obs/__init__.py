"""Telemetry of the port (copies of the JAX package's ``obs`` modules): the
metrics registry with its latency histograms (:mod:`.registry`), the
structured event log (:mod:`.events`), causal spans (:mod:`.trace`), the
flight recorder (:mod:`.flight`), the Prometheus and JSON exporters
(:mod:`.export`), the burn-rate SLO plane (:mod:`.slo`) and the online
sample-quality auditor (:mod:`.audit`), whose ``audit.*`` instruments the
``sample_quality`` SLO judges.

Telemetry is off by default: every instrumented hot path costs one
module-global load and an ``is None`` test until :func:`enable` is called::

    from reservoir_tpu_torch import obs

    reg = obs.enable(event_log_path="/tmp/events.jsonl")
    ...  # run traffic
    p50, p99, p999 = reg.histogram("bridge.flush_s").percentiles()
    obs.disable()
"""

from . import flight, trace
from .audit import SampleQualityAuditor
from .events import EventLog, read_events
from .export import json_snapshot, prometheus_text, write_json_snapshot
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
from .slo import SLOPlane, SLOSpec, SLOVerdict, default_slos
from .trace import Span, Tracer, attribution

__all__ = [
    "Counter",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "SLOPlane",
    "SLOSpec",
    "SLOVerdict",
    "SampleQualityAuditor",
    "Span",
    "Tracer",
    "active",
    "attribution",
    "blocks",
    "default_slos",
    "disable",
    "emit",
    "enable",
    "flight",
    "get_registry",
    "json_snapshot",
    "prometheus_text",
    "read_bundle",
    "read_events",
    "register_block",
    "trace",
    "write_json_snapshot",
]
