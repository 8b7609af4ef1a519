"""Exception types of the port (its own copies of the JAX package's)."""

from __future__ import annotations

__all__ = ["SamplerClosedError", "CheckpointCorrupt", "CheckpointMismatch"]


class SamplerClosedError(RuntimeError):
    """A single-use engine was used after ``result()``."""


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is truncated or corrupt (bad zip container, missing
    or unparseable manifest)."""


class CheckpointMismatch(CheckpointCorrupt):
    """A checkpoint is internally consistent but cannot be restored here:
    its state arrays disagree with its recorded config, or it records a
    mode this engine does not run."""
