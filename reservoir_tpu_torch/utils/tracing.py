"""Profiler ranges and a capture harness on ``torch.profiler``.

:func:`trace_span` is ``torch.profiler.record_function``: the bridge's
flushes (``reservoir_bridge_flush``), journal appends
(``reservoir_journal_append``), result gathers (``reservoir_bridge_result``)
and checkpoint writes (``reservoir_checkpoint_write``) show as named ranges
in a ``torch.profiler`` trace, beside the kernels and copies they issue.

Workflow::

    from reservoir_tpu_torch.utils.tracing import profile_capture

    with profile_capture("/tmp/reservoir-trace"):
        bridge.push_interleaved(streams, elements)
        bridge.complete()

    # open the trace.json under /tmp/reservoir-trace in ui.perfetto.dev
    # or chrome://tracing

``RESERVOIR_TPU_TRACE_DIR`` makes :func:`maybe_profile` capture without
code changes.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch

__all__ = ["trace_span", "profile_capture", "maybe_profile"]


def trace_span(name: str) -> ContextManager[object]:
    """A named range in a ``torch.profiler`` trace (near free when no
    profiler is running)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_capture(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host, and the card when there is one)
    and write a Chrome trace to ``log_dir/trace.json``.  Yields the
    profiler, whose ``key_averages()`` sum the region by name.  An
    exception inside the region still writes the trace: a failed run is
    exactly when the trace matters."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def maybe_profile(default: Optional[str] = None) -> ContextManager[object]:
    """:func:`profile_capture` gated on ``RESERVOIR_TPU_TRACE_DIR`` (or
    ``default``): no variable, no capture."""
    log_dir = os.environ.get("RESERVOIR_TPU_TRACE_DIR", default)
    if not log_dir:
        return contextlib.nullcontext()
    return profile_capture(log_dir)
