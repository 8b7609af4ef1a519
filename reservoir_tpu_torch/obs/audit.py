"""Online sample-quality auditing: the statistical invariant as telemetry
(the port's copy of the JAX package's ``obs/audit.py``, numpy only).

:class:`SampleQualityAuditor` hooks into the serving plane's ingest and
snapshot paths (``ReservoirService(..., auditor=SampleQualityAuditor())``)
and feeds the ``audit.*`` instruments that the ``sample_quality`` SLO of
:mod:`.slo` judges, so statistical drift pages as a latency regression
does.  Two detectors:

- **Rolling pooled KS**: sessions whose elements encode their stream
  position (canary traffic) give sample positions that must be uniform on
  ``[0, n)``; each snapshot's values are normalized by the session's own
  stream length (values outside ``[0, n)`` are opaque and left out) and
  pooled across sessions; once ``min_pool`` observations are pooled, one
  KS distance against U[0, 1) (``ks_one_sample_uniform`` with ``n=1``) is
  gated at ``max(KS_GATE, ks_crit / sqrt(pool))``.
- **Per-stratum inclusion rates**: every ingested and every sampled
  element is bucketed (default ``|value| % strata``) and counted; unbiased
  sampling includes every stratum at the same rate, so the largest
  relative deviation of a stratum's rate from the pooled one flags
  value-correlated bias.  The counters halve at each check, a rolling
  window.

Both hooks are no-ops while telemetry is disabled: one module-global load
and an ``is None`` test.  Single writer, like the service that owns it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

from . import registry as _obs

__all__ = ["SampleQualityAuditor"]


class SampleQualityAuditor:
    """Rolling KS + stratum inclusion monitor for a serving plane.

    Attach via ``ReservoirService(..., auditor=SampleQualityAuditor())``;
    the service calls :meth:`record_ingest` after each accepted ingest and
    :meth:`observe_snapshot` after each snapshot read.

    Args:
      min_pool: pooled (position-encoded) observations per KS check.
      ks_crit: finite-sample critical coefficient — the gate is
        ``max(KS_GATE, ks_crit / sqrt(pool))``.
      strata: number of value-hash buckets for the inclusion counters.
      stratum_of: optional ``array -> int array`` bucketing override
        (default ``|value| % strata``).
      min_stratum_count: minimum ingested elements per stratum before a
        stratum check can flag anything (deviation on ten elements is
        noise, not bias).
      stratum_gate: maximum relative deviation of a stratum's inclusion
        rate from the pooled mean before it counts as a breach.
      obs_scope: per-shard instrument label: when set, the
        ``audit.*`` instruments are recorded under scoped names
        (``audit.ks_checks@<scope>``) so each shard's auditor feeds its
        own ``sample_quality`` objective (``default_slos(scope=...)``).
    """

    def __init__(
        self,
        *,
        min_pool: int = 512,
        ks_crit: float = 1.95,
        strata: int = 8,
        stratum_of: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        min_stratum_count: int = 256,
        stratum_gate: float = 0.5,
        obs_scope: Optional[str] = None,
    ) -> None:
        if min_pool < 8:
            raise ValueError("min_pool must be at least 8")
        if strata < 2:
            raise ValueError("need at least 2 strata")
        self._min_pool = int(min_pool)
        self._ks_crit = float(ks_crit)
        self._strata = int(strata)
        self._stratum_of = stratum_of
        self._min_stratum = int(min_stratum_count)
        self._stratum_gate = float(stratum_gate)
        self._obs_scope = obs_scope
        self._pool: List[np.ndarray] = []
        self._pool_n = 0
        self._pool_sessions = 0
        self._ingested = np.zeros(strata, dtype=np.int64)
        self._included = np.zeros(strata, dtype=np.int64)
        self.last_ks: Optional[float] = None
        self.last_stratum_dev: Optional[float] = None

    # ----------------------------------------------------------- gated hooks

    def record_ingest(self, key: str, values) -> None:
        """Count one accepted ingest into the stratum ledger.  No-op (one
        global load, one ``is None`` test) while telemetry is disabled."""
        if _obs.get() is None:
            return
        self._record(key, values)

    def observe_snapshot(self, key: str, sample, n: int) -> None:
        """Feed one session snapshot (``n`` = that session's stream
        length so far).  No-op while telemetry is disabled."""
        if _obs.get() is None:
            return
        self._observe(key, sample, int(n))

    # -------------------------------------------------------------- internals

    def _buckets(self, arr: np.ndarray) -> np.ndarray:
        if self._stratum_of is not None:
            return np.asarray(self._stratum_of(arr), dtype=np.int64)
        return np.abs(arr.astype(np.int64, copy=False)) % self._strata

    def _record(self, key: str, values) -> None:
        arr = np.atleast_1d(np.asarray(values))
        if not arr.size:
            return
        self._ingested += np.bincount(
            self._buckets(arr), minlength=self._strata
        )[: self._strata]

    def _observe(self, key: str, sample, n: int) -> None:
        arr = np.atleast_1d(np.asarray(sample))
        if not arr.size or n <= 0:
            return
        self._included += np.bincount(
            self._buckets(arr), minlength=self._strata
        )[: self._strata]
        # position-encoded canary values: normalize by this session's own
        # stream length; anything outside [0, n) is an opaque value and
        # simply does not feed the KS pool
        u = arr.astype(np.float64, copy=False) / float(n)
        u = u[(u >= 0.0) & (u < 1.0)]
        if u.size:
            self._pool.append(u)
            self._pool_n += int(u.size)
            self._pool_sessions += 1
        if self._pool_n >= self._min_pool:
            self._check()

    def _check(self) -> None:
        reg = _obs.get()
        if reg is None:  # disabled mid-stream: drop the pending pool
            self._pool, self._pool_n, self._pool_sessions = [], 0, 0
            return
        from ..utils.stats import KS_GATE, ks_one_sample_uniform

        pooled = np.concatenate(self._pool)
        m = int(pooled.size)
        # n=1: the pool is already on the unit interval, so the shared CI
        # formula computes sup|ECDF - x| against U[0,1) directly
        ks = ks_one_sample_uniform(pooled, 1)
        gate = max(KS_GATE, self._ks_crit / math.sqrt(m))
        self.last_ks = ks
        reg.gauge(_obs.scoped("audit.ks_statistic", self._obs_scope)).set(ks)
        reg.gauge(_obs.scoped("audit.ks_gate", self._obs_scope)).set(gate)
        reg.gauge(_obs.scoped("audit.pool_size", self._obs_scope)).set(m)
        reg.counter(_obs.scoped("audit.ks_checks", self._obs_scope)).inc()
        if ks > gate:
            reg.counter(_obs.scoped("audit.ks_breaches", self._obs_scope)).inc()
            _obs.emit(
                "audit.ks_breach",
                site="obs.audit",
                ks=round(ks, 6),
                gate=round(gate, 6),
                pool=m,
                sessions=self._pool_sessions,
            )
        self._pool, self._pool_n, self._pool_sessions = [], 0, 0
        self._check_strata(reg)

    def _check_strata(self, reg) -> None:
        eligible = self._ingested >= self._min_stratum
        if eligible.sum() < 2 or self._included[eligible].sum() == 0:
            return
        rates = self._included[eligible] / self._ingested[eligible]
        mean = self._included[eligible].sum() / self._ingested[eligible].sum()
        dev = float(np.abs(rates / mean - 1.0).max())
        self.last_stratum_dev = dev
        reg.gauge(_obs.scoped("audit.stratum_dev", self._obs_scope)).set(dev)
        reg.counter(_obs.scoped("audit.stratum_checks", self._obs_scope)).inc()
        if dev > self._stratum_gate:
            worst = int(np.argmax(np.abs(rates / mean - 1.0)))
            reg.counter(_obs.scoped("audit.stratum_breaches", self._obs_scope)).inc()
            _obs.emit(
                "audit.stratum_breach",
                site="obs.audit",
                dev=round(dev, 4),
                gate=self._stratum_gate,
                stratum=int(np.flatnonzero(eligible)[worst]),
            )
        # decay: keep the ledger a rolling window, not an all-time average
        self._ingested //= 2
        self._included //= 2
