"""Open-loop traffic harness for the port's serving plane.

The port's counterpart of the JAX package's ``tools/loadgen.py``: it drives
a :class:`~reservoir_tpu_torch.serve.service.ReservoirService` the way real
tenant traffic would, and the way a closed-loop benchmark never does.  A
closed loop issues the next request when the previous one returns, so a
slow server quietly throttles its own load and the measured latency
flattens into a lie (*coordinated omission*).  This harness is
**open-loop**: the arrival schedule is drawn up front from the declared
process (Poisson, or bursty via on/off rate modulation), each arrival has
an *intended* start time, and when the service falls behind the next
arrival fires immediately with its lateness charged to the service: the
recorded ``loadgen.wait_s`` is ``completion - intended_start``, the
coordinated-omission-corrected wait a real caller would have seen.

Workload shape:

- **Zipf hot-key skew**: arrivals pick sessions from a bounded Zipf over a
  key universe larger than the table (``spec.sessions``), so a few keys are
  hot and the cold tail forces TTL/LRU **eviction pressure** and row
  recycling, as production churn does;
- **session churn**: a per-arrival close probability retires sessions so
  later arrivals re-lease (generation bumps, device row resets);
- **canary positions**: each session ingests its own stream positions
  ``0..n-1`` as values, which lets the online
  :class:`~reservoir_tpu_torch.obs.audit.SampleQualityAuditor` KS-check the
  snapshots against the uniform law;
- **periodic snapshots**: every ``snapshot_every`` completions reads the
  arriving session back (snapshot latency, staleness, and the auditor).

Everything lands in the telemetry registry (:mod:`reservoir_tpu_torch.obs`);
pair it with an :class:`~reservoir_tpu_torch.obs.slo.SLOPlane` and the run's
verdicts ride the result.  The service runs on the card unless
``--device cpu`` is given.

Usage::

    python -m reservoir_tpu_torch.tools.loadgen --rate 2000 --duration 5 \
        --sessions 10000 [--capacity 8192] [--arrivals bursty] [--churn 0.02] \
        [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["LoadSpec", "LoadResult", "build_schedule", "run_load", "main"]

#: Arrivals per vectorized session-key batch in :func:`run_load` — the
#: bound on the transient key working set (one numpy unicode array of
#: this many entries lives at a time, whatever ``spec.sessions`` is).
_KEY_BATCH = 4096


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One declarative traffic shape.

    Attributes:
      duration_s: schedule span (the run ends when the schedule drains,
        which is later than ``duration_s`` iff the service fell behind).
      rate: mean arrival rate (arrivals/second) of the whole schedule.
      arrivals: ``"poisson"`` (homogeneous) or ``"bursty"`` (on/off
        modulated Poisson via thinning: ``burst_factor`` x mean rate for
        ``burst_duty`` of every ``burst_period_s``, proportionally quiet
        otherwise — same mean rate, very different tails).
      sessions: session-key universe (the "simulated sessions"); choose
        it above the table capacity for eviction pressure.
      zipf_s: hot-key skew exponent (0 = uniform; ~1.1 = web-like).
      chunk: elements per arrival (each arrival is one ingest call).
      churn: per-arrival probability the session closes after ingest.
      snapshot_every: read the arriving session back every N completions
        (0 disables snapshots).
      max_arrivals: hard cap on schedule length (safety for huge
        rate*duration products).
      seed: schedule/Zipf/churn RNG seed — one seed, one schedule.
    """

    duration_s: float = 2.0
    rate: float = 2000.0
    arrivals: str = "poisson"
    burst_factor: float = 3.0
    burst_period_s: float = 0.5
    burst_duty: float = 0.25
    sessions: int = 1000
    zipf_s: float = 1.1
    chunk: int = 64
    churn: float = 0.0
    snapshot_every: int = 0
    max_arrivals: Optional[int] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.duration_s <= 0 or self.rate <= 0:
            raise ValueError("duration_s and rate must be positive")
        if self.arrivals not in ("poisson", "bursty"):
            raise ValueError(
                f"arrivals must be poisson|bursty, got {self.arrivals!r}"
            )
        if self.sessions < 1 or self.chunk < 1:
            raise ValueError("sessions and chunk must be positive")
        if not (0.0 <= self.churn <= 1.0):
            raise ValueError("churn must be in [0, 1]")
        if self.arrivals == "bursty":
            if not (0.0 < self.burst_duty < 1.0) or self.burst_factor < 1.0:
                raise ValueError(
                    "bursty arrivals need burst_duty in (0, 1) and "
                    "burst_factor >= 1"
                )
            if self.burst_factor * self.burst_duty >= 1.0:
                raise ValueError(
                    "bursty arrivals need burst_factor * burst_duty < 1 "
                    "(the off-phase rate would be negative)"
                )


@dataclasses.dataclass
class LoadResult:
    """One completed run: offered vs completed load, failure split, and
    the corrected-wait quantiles (zeros when telemetry was disabled)."""

    offered: int = 0
    completed: int = 0
    rejected: int = 0
    errors: int = 0
    opens: int = 0
    reopens: int = 0
    closes: int = 0
    snapshots: int = 0
    elements: int = 0
    wall_s: float = 0.0
    achieved_rate: float = 0.0
    max_behind_s: float = 0.0
    wait_p50_s: float = 0.0
    wait_p99_s: float = 0.0
    wait_p999_s: float = 0.0

    def snapshot(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def build_schedule(spec: LoadSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Draw the whole arrival process up front: ``(offsets_s, session_idx)``
    — sorted arrival offsets from t0, and the Zipf-ranked session index
    of each arrival.  Pure function of the spec (seeded)."""
    rng = np.random.default_rng(spec.seed)
    if spec.arrivals == "poisson":
        # homogeneous: exponential gaps at the mean rate
        n_draw = max(16, int(spec.rate * spec.duration_s * 1.5) + 64)
        offsets = np.cumsum(rng.exponential(1.0 / spec.rate, n_draw))
        offsets = offsets[offsets < spec.duration_s]
    else:
        # bursty: thin a max-rate Poisson by the on/off intensity profile
        on_rate = spec.rate * spec.burst_factor
        off_rate = spec.rate * (1.0 - spec.burst_factor * spec.burst_duty) / (
            1.0 - spec.burst_duty
        )
        n_draw = max(16, int(on_rate * spec.duration_s * 1.5) + 64)
        cand = np.cumsum(rng.exponential(1.0 / on_rate, n_draw))
        cand = cand[cand < spec.duration_s]
        phase = (cand % spec.burst_period_s) / spec.burst_period_s
        lam = np.where(phase < spec.burst_duty, on_rate, off_rate)
        offsets = cand[rng.random(cand.size) < lam / on_rate]
    if spec.max_arrivals is not None:
        offsets = offsets[: spec.max_arrivals]
    # bounded Zipf over the key universe: weight 1/rank^s, then a random
    # permutation of ranks -> session ids so the hot keys are scattered
    ranks = np.arange(1, spec.sessions + 1, dtype=np.float64)
    w = ranks ** (-spec.zipf_s) if spec.zipf_s > 0 else np.ones_like(ranks)
    cdf = np.cumsum(w / w.sum())
    picks = np.searchsorted(cdf, rng.random(offsets.size), side="right")
    perm = rng.permutation(spec.sessions)
    return offsets, perm[np.minimum(picks, spec.sessions - 1)]


def run_load(
    service,
    spec: LoadSpec,
    *,
    clock=time.perf_counter,
    sleep=time.sleep,
) -> LoadResult:
    """Drive ``service`` through one open-loop schedule; returns the
    :class:`LoadResult`.  Latency/wait distributions land in the active
    telemetry registry (``loadgen.wait_s`` is the corrected wait; the
    service's own ``serve.*`` instruments fire as usual)."""
    from .. import obs
    from ..errors import (
        ServiceSaturated,
        SessionIngestError,
        StaleSessionError,
        UnknownSessionError,
    )

    offsets, sess_idx = build_schedule(spec)
    rng = np.random.default_rng(spec.seed + 1)
    churn_draws = rng.random(offsets.size) if spec.churn else None
    res = LoadResult(offered=int(offsets.size))
    reg = obs.get_registry()
    # the per-session state is two flat numpy arrays indexed by Zipf rank
    # (next stream position and liveness), not a dict of Python keys, so a
    # sessions=10**6 universe costs ~9 MB flat instead of a million
    # resident str/int objects.  Key strings are made per _KEY_BATCH
    # arrivals as one vectorized numpy unicode batch and dropped after
    # use: the working set stays bounded whatever the universe size.
    positions = np.zeros(spec.sessions, dtype=np.int64)
    live = np.zeros(spec.sessions, dtype=np.bool_)
    t0 = clock()

    def _open(sid: int, key: str, fresh: bool) -> None:
        service.open_session(key)
        positions[sid] = 0
        live[sid] = True
        if fresh:
            res.opens += 1
        else:
            res.reopens += 1

    for base in range(0, offsets.size, _KEY_BATCH):
        idx_batch = sess_idx[base : base + _KEY_BATCH]
        key_batch = np.char.add("s", idx_batch.astype(np.str_))
        for j in range(idx_batch.size):
            i = base + j
            intended = t0 + float(offsets[i])
            now = clock()
            if now < intended:
                sleep(intended - now)
            else:
                res.max_behind_s = max(res.max_behind_s, now - intended)
            sid = int(idx_batch[j])
            key = str(key_batch[j])
            try:
                if not live[sid]:
                    _open(sid, key, fresh=True)
                pos = int(positions[sid])
                chunk = np.arange(pos, pos + spec.chunk, dtype=np.int32)
                try:
                    service.ingest(key, chunk)
                except (UnknownSessionError, StaleSessionError):
                    # the table evicted/recycled this lease under pressure
                    # — a real tenant re-opens and carries on (counted,
                    # and the new lease restarts its canary positions at
                    # zero)
                    _open(sid, key, fresh=False)
                    chunk = np.arange(spec.chunk, dtype=np.int32)
                    service.ingest(key, chunk)
                positions[sid] = int(chunk[-1]) + 1
                res.completed += 1
                res.elements += spec.chunk
                if spec.snapshot_every and (
                    res.completed % spec.snapshot_every == 0
                ):
                    # sync=True: the read-your-writes path — the one the
                    # auditor can judge (and the costlier latency
                    # population); the paired sync=False read feeds the
                    # LIVE snapshot latency + staleness histograms the
                    # SLOs watch
                    service.snapshot(key)
                    service.snapshot(key, sync=False)
                    res.snapshots += 1
                if churn_draws is not None and churn_draws[i] < spec.churn:
                    try:
                        service.close_session(key)
                        res.closes += 1
                    except (UnknownSessionError, StaleSessionError):
                        pass  # already evicted under row pressure
                    live[sid] = False
                    positions[sid] = 0
            except ServiceSaturated:
                res.rejected += 1
            except (
                SessionIngestError, StaleSessionError, UnknownSessionError
            ):
                res.errors += 1
            if reg is not None:
                # corrected wait: lateness a real open-loop caller sees
                reg.histogram("loadgen.wait_s").observe(clock() - intended)
    res.wall_s = clock() - t0
    res.achieved_rate = res.completed / res.wall_s if res.wall_s > 0 else 0.0
    if reg is not None:
        wait = reg.peek("loadgen.wait_s")
        if wait is not None and wait.count:
            res.wait_p50_s, res.wait_p99_s, res.wait_p999_s = (
                wait.percentiles()
            )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=2000.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--sessions", type=int, default=1000)
    ap.add_argument(
        "--capacity", type=int, default=0,
        help="session-table rows (default: 4/5 of --sessions, rounded up, "
        "so the universe overcommits the table and eviction pressure is real)",
    )
    ap.add_argument("--arrivals", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--snapshot-every", type=int, default=13)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the service's engine runs (default: the card)")
    args = ap.parse_args(argv)

    from .. import SamplerConfig, obs
    from ..serve import ReservoirService

    capacity = args.capacity or -(-args.sessions * 4 // 5)
    reg = obs.enable(obs.Registry())
    plane = obs.SLOPlane()
    svc = ReservoirService(
        SamplerConfig(
            max_sample_size=args.k,
            num_reservoirs=capacity,
            tile_size=args.tile,
        ),
        ttl_s=max(1.0, args.duration),
        auditor=obs.SampleQualityAuditor(),
        device=args.device,
    )
    spec = LoadSpec(
        duration_s=args.duration,
        rate=args.rate,
        arrivals=args.arrivals,
        sessions=args.sessions,
        zipf_s=args.zipf,
        chunk=args.chunk,
        churn=args.churn,
        snapshot_every=args.snapshot_every,
        seed=args.seed,
    )
    result = run_load(svc, spec)
    verdicts = plane.evaluate()
    report = {
        "spec": dataclasses.asdict(spec),
        "result": result.snapshot(),
        "serve": svc.metrics.snapshot(),
        "slo": {k: v.verdict for k, v in verdicts.items()},
    }
    svc.shutdown()
    obs.disable()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
