"""The traced window as the profiler saw it: device operations, each tied
to the benchmark span the host was in when it launched it, and the host's
spans.

Read from ``torch.profiler``'s Chrome trace: device events (``kernel``,
``gpu_memcpy``, ``gpu_memset``) carry the correlation id of the runtime
call that launched them, whose host timestamp places them in a span; the
benchmark's spans are its ``record_function`` ranges named
``cardbench.<span>``, and ``cardbench.window`` bounds the window.  Times are
in microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["DeviceOp", "Span", "Timeline", "load_chrome_trace", "short_name", "PREFIX"]

PREFIX = "cardbench."
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class Span:
    name: str
    ts: float
    dur: float


@dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str  # kernel, memcpy or memset
    ts: float
    dur: float
    span: Optional[str]  # the benchmark span that launched it, if any


@dataclass
class Timeline:
    window: Tuple[float, float]
    ops: List[DeviceOp] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    _starts: List[float] = field(default_factory=list, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window, as
        sorted disjoint intervals."""
        t0, t1 = self.window
        out: List[List[float]] = []
        for a, b in sorted((max(op.ts, t0), min(op.ts + op.dur, t1)) for op in self.ops):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which the device ran nothing, in
        percent; ``None`` for a trace with no device operation."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s) if self.ops else None

    def span_at(self, t: float) -> Optional[str]:
        """The benchmark span the host was in at time ``t`` (the spans are
        sorted by start and do not overlap)."""
        if len(self._starts) != len(self.spans):
            self._starts = [s.ts for s in self.spans]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.spans[i].ts + self.spans[i].dur:
            return self.spans[i].name
        return None

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every stretch of the window in which the device ran nothing,
        longest first, named by the span the host was in at its middle
        (``loop`` outside every span)."""
        edges = [self.window[0]]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        named = [(self.span_at((a + b) / 2) or "loop", (b - a) * 1e-6) for a, b in gaps]
        return sorted(named, key=lambda g: -g[1])

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds by operation name inside the window, largest
        first."""
        t0, t1 = self.window
        total: Dict[str, float] = {}
        for op in self.ops:
            d = min(op.ts + op.dur, t1) - max(op.ts, t0)
            if d > 0:
                total[op.name] = total.get(op.name, 0.0) + d * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def kernels(self, contains: str) -> List[DeviceOp]:
        """Kernels in the window whose name contains ``contains``."""
        t0, t1 = self.window
        return [op for op in self.ops
                if op.kind == "kernel" and contains in op.name and t0 <= op.ts <= t1]

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list (a copy's or
    a set's name as it is)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and "::" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:160]


def from_events(events: Iterable[dict]) -> Timeline:
    """A timeline from Chrome-trace events (``traceEvents``)."""
    events = list(events)
    launch_ts: Dict[int, float] = {}
    spans: List[Span] = []
    window: Optional[Tuple[float, float]] = None
    for e in events:
        cat = e.get("cat", "")
        if cat in _RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            name = e["name"][len(PREFIX):]
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if name == "window":
                window = (ts, ts + dur)
            else:
                spans.append(Span(name, ts, dur))
    if window is None:
        raise ValueError("the trace holds no cardbench.window range")
    spans.sort(key=lambda s: s.ts)
    tl = Timeline(window=window, spans=spans)
    names: Dict[str, str] = {}
    for e in events:
        kind = _DEVICE_CATS.get(e.get("cat", ""))
        if kind is None:
            continue
        host = launch_ts.get((e.get("args") or {}).get("correlation"))
        raw = str(e.get("name", ""))
        if raw not in names:
            names[raw] = short_name(raw)
        tl.ops.append(DeviceOp(names[raw], kind, float(e["ts"]),
                               float(e.get("dur", 0.0)), tl.span_at(host) if host is not None else None))
    tl.ops.sort(key=lambda op: op.ts)
    return tl


def load_chrome_trace(path: str) -> Timeline:
    with open(path) as f:
        data = json.load(f)
    return from_events(data["traceEvents"] if isinstance(data, dict) else data)
