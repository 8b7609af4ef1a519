"""Offline serving-knob sweep for the port: score candidates under live
traffic, keep the SLO-clean winner.

The port's counterpart of the JAX package's ``tools/serve_knob_sweep.py``.
The serving knobs can only be judged end to end: coalesce threshold,
admission budget, checkpoint/sweep cadence and gate push chunk trade
throughput against tail latency *under a workload*, and the SLO verdicts
are the ground truth for "too far".  So each candidate knob vector gets a
fresh :class:`~reservoir_tpu_torch.serve.service.ReservoirService`, a fresh
telemetry registry and an :class:`~reservoir_tpu_torch.obs.slo.SLOPlane`,
and one identical open-loop
:func:`~reservoir_tpu_torch.tools.loadgen.run_load` schedule, and
candidates are ranked **lexicographically**:

    no SLO page  >  no SLO warn  >  max effective elem/s  >  min ingest p99

(a candidate that pages never beats one that does not, whatever its
throughput).  The winner is persisted under its workload fingerprint
(``serve|device|R|k|mode|gated|rate-band|zipf-band``) into the port's
atomic JSON knob store (:mod:`reservoir_tpu_torch.ops.autotune`), twice:
once under the swept rate/skew bands and once under the ``any`` bands (the
construction-time fallback), so an untargeted service still picks up the
overall winner.  The defaults ride every sweep as candidate zero.  The
services run on the card unless ``--device cpu`` is given.

Usage::

    python -m reservoir_tpu_torch.tools.serve_knob_sweep --rate 2000 \
        --duration 2 [--sessions 2000] [--capacity 1024] [--zipf 1.1] \
        [--gated] [--cache PATH] [--dry-run] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import obs
from ..serve.autotune import (
    DEFAULT_KNOBS,
    ServiceKnobs,
    record_knobs,
    service_fingerprint,
)
from .loadgen import LoadSpec, run_load

__all__ = ["candidate_grid", "score_candidate", "sweep_knobs", "main"]


def candidate_grid(gated: bool = False) -> List[ServiceKnobs]:
    """A curated knob grid: the defaults first (the floor every sweep can
    fall back to), then one-axis-at-a-time spreads around them — small on
    purpose, each candidate costs a full loadgen run."""
    cands = [DEFAULT_KNOBS]
    for coalesce in (1 << 14, 1 << 17, 1 << 18):
        cands.append(DEFAULT_KNOBS._replace(coalesce_bytes=coalesce))
    for ckpt in (32, 256):
        cands.append(DEFAULT_KNOBS._replace(checkpoint_every=ckpt))
    cands.append(
        DEFAULT_KNOBS._replace(max_inflight_bytes=1 << 22)
    )
    if gated:
        for chunk in (1 << 16, 1 << 19):
            cands.append(DEFAULT_KNOBS._replace(gate_push_chunk=chunk))
    out: List[ServiceKnobs] = []
    for c in cands:  # dedupe, order-preserving
        if c not in out:
            out.append(c)
    return out


def score_candidate(
    make_service: Callable[[ServiceKnobs], Any],
    knobs: ServiceKnobs,
    spec: LoadSpec,
    *,
    slo_factory: Optional[Callable[[], Any]] = None,
) -> Dict[str, Any]:
    """Run ONE candidate under a fresh service + registry + SLO plane and
    return its measurement row (including the lexicographic ``score``
    tuple).  The previously active registry is restored on exit, so the
    sweep composes with a caller's own telemetry."""
    prev = obs.get_registry()
    reg = obs.enable(obs.Registry())
    try:
        plane = (
            slo_factory() if slo_factory is not None
            else obs.SLOPlane(obs.default_slos())
        )
        service = make_service(knobs)
        try:
            result = run_load(service, spec)
            service.sync()
            verdicts = plane.evaluate()
            pages = sum(1 for v in verdicts.values() if v.verdict == "page")
            warns = sum(1 for v in verdicts.values() if v.verdict == "warn")
            elem_s = (
                result.elements / result.wall_s if result.wall_s > 0 else 0.0
            )
            ingest = reg.peek("serve.ingest_s")
            p99 = (
                float(ingest.percentiles()[1])
                if ingest is not None and ingest.count
                else 0.0
            )
        finally:
            shutdown = getattr(service, "shutdown", None)
            if shutdown is not None:
                shutdown()
    finally:
        if prev is not None:
            obs.enable(prev)
        else:
            obs.disable()
    return {
        "knobs": knobs._asdict(),
        "score": (pages, warns, -elem_s, p99),
        "pages": pages,
        "warns": warns,
        "elem_per_sec": elem_s,
        "ingest_p99_s": p99,
        "completed": result.completed,
        "rejected": result.rejected,
        "errors": result.errors,
        "slo": {k: v.verdict for k, v in verdicts.items()},
    }


def sweep_knobs(
    make_service: Callable[[ServiceKnobs], Any],
    spec: LoadSpec,
    candidates: Optional[Sequence[ServiceKnobs]] = None,
    *,
    gated: bool = False,
    slo_factory: Optional[Callable[[], Any]] = None,
    cache_path: Optional[str] = None,
    record: bool = True,
    source: str = "serve_knob_sweep",
) -> Dict[str, Any]:
    """Score every candidate under the same schedule, pick the
    lexicographic winner, and (by default) persist it under both the
    swept rate/skew bands and the ``any`` fallback bands.  Returns the
    sweep report: winner, per-candidate rows, and the recorded keys."""
    cands = list(candidates) if candidates is not None else candidate_grid(gated)
    if DEFAULT_KNOBS not in cands:
        cands.insert(0, DEFAULT_KNOBS)  # the floor is always in the race
    rows = [
        score_candidate(make_service, c, spec, slo_factory=slo_factory)
        for c in cands
    ]
    best_i = min(range(len(rows)), key=lambda i: rows[i]["score"])
    winner = cands[best_i]
    report: Dict[str, Any] = {
        "winner": winner._asdict(),
        "winner_index": best_i,
        "candidates": rows,
        "spec": dataclasses.asdict(spec),
        "recorded": [],
    }
    if record:
        # the fingerprint needs a live service; a throwaway one with the
        # winning knobs answers device/R/k/mode/gated
        probe = make_service(winner)
        try:
            device_kind, R, k, mode, is_gated = service_fingerprint(probe)
        finally:
            shutdown = getattr(probe, "shutdown", None)
            if shutdown is not None:
                shutdown()
        best = rows[best_i]
        for rate, zipf in ((spec.rate, spec.zipf_s), (None, None)):
            report["recorded"].append(
                record_knobs(
                    device_kind, R, k, mode, is_gated, winner,
                    rate=rate, zipf_s=zipf,
                    elem_per_sec=best["elem_per_sec"],
                    ingest_p99_s=best["ingest_p99_s"],
                    source=source, path=cache_path,
                )
            )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=2000.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--sessions", type=int, default=2000)
    ap.add_argument(
        "--capacity", type=int, default=0,
        help="session-table rows (default: 4/5 of --sessions, rounded up)",
    )
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--snapshot-every", type=int, default=13)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gated", action="store_true")
    ap.add_argument(
        "--cache", default=None,
        help="knob-cache path (default: the shared autotune store)",
    )
    ap.add_argument(
        "--dry-run", action="store_true",
        help="score candidates but record nothing",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the services' engines run (default: the card)")
    args = ap.parse_args(argv)

    from .. import SamplerConfig

    capacity = args.capacity or -(-args.sessions * 4 // 5)

    def make_service(knobs: ServiceKnobs) -> Any:
        from ..serve import ReservoirService

        return ReservoirService(
            SamplerConfig(
                max_sample_size=args.k,
                num_reservoirs=capacity,
                tile_size=args.tile,
            ),
            ttl_s=max(1.0, args.duration),
            auditor=obs.SampleQualityAuditor(),
            gated=args.gated,
            coalesce_bytes=knobs.coalesce_bytes,
            max_inflight_bytes=knobs.max_inflight_bytes,
            checkpoint_every=knobs.checkpoint_every,
            sweep_interval_s=knobs.sweep_interval_s or None,
            gate_push_chunk=knobs.gate_push_chunk,
            device=args.device,
        )

    spec = LoadSpec(
        duration_s=args.duration,
        rate=args.rate,
        sessions=args.sessions,
        zipf_s=args.zipf,
        chunk=args.chunk,
        churn=args.churn,
        snapshot_every=args.snapshot_every,
        seed=args.seed,
    )
    t0 = time.perf_counter()
    report = sweep_knobs(
        make_service,
        spec,
        gated=args.gated,
        cache_path=args.cache,
        record=not args.dry_run,
    )
    report["sweep_wall_s"] = time.perf_counter() - t0
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
