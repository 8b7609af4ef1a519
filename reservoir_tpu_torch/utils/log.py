"""Once-only and rate-limited logging, mirrored into the event log (the
port's copy of the JAX package's ``utils/log.py``).

:func:`log_once` keeps a per-owner guard flag as an attribute on the owner,
so "logged once per bridge" survives object churn, and mirrors every
emitted line into the telemetry event log
(:func:`reservoir_tpu_torch.obs.registry.emit`) when telemetry is enabled —
one global load and an ``is None`` test otherwise.

:class:`RateLimited` covers the non-once case (a site that may fire per
tile but should log at human rate).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..obs import registry as _obs

__all__ = ["log_once", "warn_once", "info_once", "RateLimited"]


def log_once(
    owner: object,
    flag: str,
    level: int,
    message: str,
    *args,
    logger: Optional[str] = None,
    site: Optional[str] = None,
) -> bool:
    """Log ``message % args`` at ``level`` once per ``owner``: attribute
    ``flag`` on the owner is the guard (set here).  Returns whether this
    call logged.  When telemetry is enabled the same line is emitted as a
    structured ``log`` event with ``site`` as its correlation field."""
    if getattr(owner, flag, False):
        return False
    setattr(owner, flag, True)
    name = logger or type(owner).__module__
    logging.getLogger(name).log(level, message, *args)
    if _obs.get() is not None:
        _obs.emit(
            "log",
            level=logging.getLevelName(level).lower(),
            logger=name,
            site=site,
            message=(message % args) if args else message,
        )
    return True


def warn_once(
    owner: object,
    flag: str,
    message: str,
    *args,
    logger: Optional[str] = None,
    site: Optional[str] = None,
) -> bool:
    return log_once(
        owner, flag, logging.WARNING, message, *args, logger=logger, site=site
    )


def info_once(
    owner: object,
    flag: str,
    message: str,
    *args,
    logger: Optional[str] = None,
    site: Optional[str] = None,
) -> bool:
    return log_once(
        owner, flag, logging.INFO, message, *args, logger=logger, site=site
    )


class RateLimited:
    """Per-instance rate-limited logger: at most one line per
    ``min_interval_s``, with a suppressed-count suffix when lines were
    dropped in between (single-writer like the metric blocks)."""

    def __init__(
        self, logger: str, min_interval_s: float = 5.0, clock=time.monotonic
    ) -> None:
        self._logger = logging.getLogger(logger)
        self._name = logger
        self._interval = float(min_interval_s)
        self._clock = clock
        self._last = -float("inf")
        self._suppressed = 0

    def log(
        self, level: int, message: str, *args, site: Optional[str] = None
    ) -> bool:
        now = self._clock()
        if now - self._last < self._interval:
            self._suppressed += 1
            return False
        if self._suppressed:
            message = message + " (%d similar suppressed)"
            args = args + (self._suppressed,)
            self._suppressed = 0
        self._last = now
        self._logger.log(level, message, *args)
        if _obs.get() is not None:
            _obs.emit(
                "log",
                level=logging.getLevelName(level).lower(),
                logger=self._name,
                site=site,
                message=(message % args) if args else message,
            )
        return True

    def warning(self, message: str, *args, site: Optional[str] = None) -> bool:
        return self.log(logging.WARNING, message, *args, site=site)
