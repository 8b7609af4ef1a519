"""The card's liveness probe, in a throwaway child process.

The port's counterpart of the JAX package's ``utils/probe.py``.  A card
that has fallen off the bus, or a first CUDA context that never comes up,
can stall ``torch.cuda`` inside the caller's process, where nothing can
end it.  So liveness is always checked in a child with a hard timeout: a
hang costs ``timeout_s`` and is recorded, never inherited.
:mod:`.selftest` runs this probe before its own child.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

__all__ = ["PROBE_SNIPPET", "probe_backend_proc"]

#: the child: put a small tensor on the card, reduce it, synchronize, and
#: print the platform and the card's name
PROBE_SNIPPET = (
    "import sys, torch; "
    "assert torch.cuda.is_available(), 'no CUDA device'; "
    "x = torch.ones(8, device='cuda'); assert float(x.sum()) == 8.0; "
    "torch.cuda.synchronize(); "
    "sys.stdout.write('gpu ' + torch.cuda.get_device_name(0))"
)

#: the same child pinned to the CPU (for the tests)
_CPU_SNIPPET = (
    "import sys, torch; "
    "x = torch.ones(8); assert float(x.sum()) == 8.0; "
    "sys.stdout.write('cpu')"
)


def probe_backend_proc(timeout_s: float, device: Optional[str] = None) -> Optional[str]:
    """Probe the card in a throwaway child process.

    Returns the platform string (``"gpu"``; ``"cpu"`` with
    ``device="cpu"``), or ``None`` when the child hangs past ``timeout_s``,
    exits non-zero or finds no card.  ``device="cpu"`` pins the child to
    the CPU: it checks only that a child can import torch and compute."""
    if device not in (None, "cpu", "cuda"):
        raise ValueError(f"device must be None, 'cuda' or 'cpu', got {device!r}")
    snippet = _CPU_SNIPPET if device == "cpu" else PROBE_SNIPPET
    try:
        proc = subprocess.run(
            [sys.executable, "-c", snippet],
            capture_output=True,
            timeout=timeout_s,
            text=True,
        )
    except subprocess.TimeoutExpired:
        return None
    if proc.returncode != 0:
        return None
    words = proc.stdout.split()
    return words[0] if words else None
