"""Exception types of the port (its own copies of the JAX package's), and
the retry policy of the stream bridge.

A device or transfer failure is either *transient*
(:class:`TransientDeviceError`, worth retrying under a :class:`RetryPolicy`)
or *fatal* (everything else: it fails the stream through the bridge's
tri-state completion protocol).  :class:`FlushTimeout` is the watchdog's
verdict on a hung flush and is fatal: the flush worker may be wedged inside
the runtime, so a retry could never run.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Tuple, Type

__all__ = [
    "SamplerClosedError",
    "AbruptStreamTermination",
    "StreamCancelled",
    "TransientDeviceError",
    "FlushTimeout",
    "CheckpointCorrupt",
    "CheckpointMismatch",
    "FencedError",
    "RetryPolicy",
]


class SamplerClosedError(RuntimeError):
    """A single-use engine was used after ``result()``."""


class AbruptStreamTermination(RuntimeError):
    """A stream bridge was dropped without completing, failing or
    cancelling: its ``__del__`` backstop fails the materialized future with
    this."""


class StreamCancelled(RuntimeError):
    """Downstream cancelled with a real failure (non-graceful)."""


class TransientDeviceError(RuntimeError):
    """A device or transfer failure worth retrying.  The bridge's flush
    worker retries these under its :class:`RetryPolicy` before surfacing
    them; every other exception type is fatal on first occurrence."""


class FlushTimeout(RuntimeError):
    """A device flush exceeded the bridge's watchdog budget.

    Fatal, not a :class:`TransientDeviceError`: the flush worker is presumed
    wedged inside the runtime call, so the watchdog fails the materialized
    future instead of letting callers block forever."""


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is truncated or corrupt (bad zip container, missing
    or unparseable manifest)."""


class CheckpointMismatch(CheckpointCorrupt):
    """A checkpoint is internally consistent but cannot be restored here:
    its state arrays disagree with its recorded config, or it records a
    mode this engine does not run."""


class FencedError(RuntimeError):
    """A write was refused because a newer primary epoch is persisted in the
    checkpoint directory: this writer was fenced by a failover promotion and
    must not touch the durable state again.  ``observed_epoch`` is the
    persisted epoch, ``own_epoch`` the one this writer was admitted at."""

    def __init__(self, message: str, observed_epoch: int = 0,
                 own_epoch: int = 0) -> None:
        super().__init__(message)
        self.observed_epoch = observed_epoch
        self.own_epoch = own_epoch


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, jittered exponential backoff for *transient* flush failures.

    Deterministic: the jitter for attempt ``i`` is drawn from
    ``random.Random(f"{seed}:{i}")``, so two runs with the same policy see
    the same backoff schedule (the JAX package's schedule, to the bit).

    Attributes:
      max_retries: retry attempts after the first failure (0 disables).
      base_backoff_s: backoff before retry 1; doubles per attempt.
      max_backoff_s: hard cap on any single backoff.
      jitter: fraction of the backoff randomized (0 = fully deterministic
        delay, 0.5 = uniform in ``[0.75, 1.25] * backoff``).
      seed: jitter seed.
      retryable_types: exception types considered transient.
    """

    max_retries: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    retryable_types: Tuple[Type[BaseException], ...] = (TransientDeviceError,)

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable_types)

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered and capped."""
        base = min(
            self.base_backoff_s * (2.0 ** (attempt - 1)), self.max_backoff_s
        )
        if not self.jitter:
            return base
        u = random.Random(f"{self.seed}:{attempt}").random()
        return min(
            base * (1.0 + self.jitter * (u - 0.5)), self.max_backoff_s
        )
