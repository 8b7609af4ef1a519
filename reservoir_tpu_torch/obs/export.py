"""Exporters: Prometheus text format and a JSON snapshot (the port's copy
of the JAX package's ``obs/export.py``, the same output).

Two render targets over one :class:`~reservoir_tpu_torch.obs.registry.Registry`:

- :func:`prometheus_text`: the Prometheus exposition format (``# TYPE``
  headers, cumulative ``_bucket{le=...}`` lines for histograms, ``_sum``/
  ``_count``);
- :func:`json_snapshot` / :func:`write_json_snapshot`: one dict carrying
  the registry snapshot and every live registered metric block
  (``BridgeMetrics``/``ServiceMetrics``/``HAMetrics`` through
  :func:`~reservoir_tpu_torch.obs.registry.register_block`), which the
  heartbeat writer embeds into ``heartbeat.json`` and a standby's status
  file carries.

Only occupied histogram buckets are emitted (plus the mandatory ``+Inf``):
a 180-bucket latency histogram with three occupied buckets costs four
lines, not 181.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

from . import trace as _trace
from .registry import Counter, Gauge, Histogram, Registry, blocks, get

__all__ = ["prometheus_text", "json_snapshot", "write_json_snapshot"]


def _sanitize(name: str) -> str:
    return "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name
    )


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _flatten(prefix: str, d: dict, out: dict) -> None:
    for key, value in d.items():
        name = f"{prefix}_{key}" if prefix else str(key)
        if isinstance(value, dict):
            _flatten(name, value, out)
        elif isinstance(value, bool) or isinstance(value, (int, float)):
            out[name] = value


def prometheus_text(
    registry: Optional[Registry] = None,
    *,
    prefix: str = "reservoir",
    include_blocks: bool = True,
) -> str:
    """Render ``registry`` (default: the active one) in Prometheus text
    exposition format.  ``include_blocks`` additionally renders every live
    registered metric block's numeric ``snapshot()`` fields as gauges with
    an ``instance`` label."""
    if registry is None:
        registry = get()
    lines = []
    if registry is not None:
        for inst in registry.instruments():
            name = f"{prefix}_{_sanitize(inst.name)}"
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(inst.value)}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {name} histogram")
                bounds = inst.bounds()
                counts = inst.bucket_counts()
                cum = 0
                for i, c in enumerate(counts[:-1]):
                    cum += c
                    if c:
                        lines.append(
                            f'{name}_bucket{{le="{bounds[i]:g}"}} {cum}'
                        )
                cum += counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {_fmt(inst.sum)}")
                lines.append(f"{name}_count {inst.count}")
    plane = getattr(registry, "slo_plane", None) if registry else None
    if plane is not None:
        # burn-rate verdicts (obs/slo.py): one gauge triple per objective,
        # verdict encoded 0/1/2 (ok/warn/page) so alert rules are a simple
        # threshold over reservoir_slo_verdict
        severity = {"ok": 0, "warn": 1, "page": 2}
        slo = plane.snapshot()
        verdicts = slo.get("verdicts", {})
        if verdicts:
            for metric, value_of in (
                ("verdict", lambda v: severity.get(v["verdict"], 0)),
                ("burn_short", lambda v: v["burn_short"]),
                ("burn_long", lambda v: v["burn_long"]),
            ):
                name = f"{prefix}_slo_{metric}"
                lines.append(f"# TYPE {name} gauge")
                for key in sorted(verdicts):
                    lines.append(
                        f'{name}{{slo="{_sanitize(key)}"}} '
                        f"{_fmt(value_of(verdicts[key]))}"
                    )
    tracer = _trace.get()
    if tracer is not None:
        # causal-trace attribution: per-stage share of the
        # end-to-end ingest wait, rendered only while a tracer is active
        # (the base format is unchanged when tracing is off)
        report = _trace.attribution(tracer.spans())
        if report["traces"]:
            name = f"{prefix}_trace_stage_share"
            lines.append(f"# TYPE {name} gauge")
            for stage in sorted(report["stages"]):
                lines.append(
                    f'{name}{{stage="{_sanitize(stage)}"}} '
                    f'{_fmt(report["stages"][stage]["share"])}'
                )
            lines.append(
                f'{name}{{stage="other"}} {_fmt(report["other"]["share"])}'
            )
            for metric, value in (
                ("traces", report["traces"]),
                ("e2e_p50_s", report["e2e_s"]["p50"]),
                ("e2e_p99_s", report["e2e_s"]["p99"]),
            ):
                name = f"{prefix}_trace_{metric}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(value)}")
    if include_blocks:
        by_name: dict = {}
        for kind, idx, block in blocks():
            flat: dict = {}
            _flatten("", block.snapshot(), flat)
            for field, value in flat.items():
                name = f"{prefix}_{_sanitize(kind)}_{_sanitize(field)}"
                by_name.setdefault(name, []).append((idx, value))
        for name in sorted(by_name):
            lines.append(f"# TYPE {name} gauge")
            for idx, value in by_name[name]:
                lines.append(f'{name}{{instance="{idx}"}} {_fmt(value)}')
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(
    registry: Optional[Registry] = None,
    *,
    include_blocks: bool = True,
    clock=time.time,
) -> dict:
    """One JSON-able dict: registry instruments plus (by default) every
    live registered metric block, keyed by kind with instance ids —
    the payload the heartbeat embeds."""
    if registry is None:
        registry = get()
    out: dict = {"ts": float(clock())}
    out.update(
        registry.snapshot()
        if registry is not None
        else {"counters": {}, "gauges": {}, "histograms": {}}
    )
    if include_blocks:
        grouped: dict = {}
        for kind, idx, block in blocks():
            grouped.setdefault(kind, {})[str(idx)] = block.snapshot()
        out["blocks"] = grouped
    plane = getattr(registry, "slo_plane", None) if registry else None
    if plane is not None:
        # the verdict panel payload: rides heartbeat.json through the
        # HeartbeatWriter's embedded export
        out["slo"] = plane.snapshot()
    tracer = _trace.get()
    if tracer is not None:
        # the attribution panel payload: same conditional-key
        # pattern as "slo" — present only while a tracer is active, so
        # heartbeats pick it up with no new wiring
        out["trace"] = _trace.attribution(tracer.spans())
    return out


def write_json_atomic(path: str, payload, *, suffix: str = ".tmp") -> None:
    """Write ``payload`` as JSON to ``path`` through a temp file in the same
    directory and a rename, so a reader never sees a torn file."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, default=str)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_json_snapshot(
    path: str, registry: Optional[Registry] = None, **kwargs
) -> dict:
    """Atomically write :func:`json_snapshot` to ``path`` (temp file +
    rename: a reader tailing it never sees a torn export)."""
    snap = json_snapshot(registry, **kwargs)
    write_json_atomic(path, snap, suffix=".tmp.obs")
    return snap
