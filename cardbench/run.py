"""Run one cell of the benchmark once and print its result line.

    python -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The run builds (or loads) the program's kernels, makes its inputs on
the card from the seed, warms up, measures for ``--seconds``, then checks
what the timed path produced against the plain reference.  Its standard
output ends with one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones read from the profiler's trace of a window of at most
:data:`TRACE_SECONDS`), ``device``, with ``--trace 1`` a ``breakdown``, and last the ``checks``: each number compared with its
limit, which are also the last lines on standard error.

Without a CUDA card, with fewer than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

from __future__ import annotations

from cardbench.harness import process_start

T0 = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

from cardbench import harness  # noqa: E402

#: device operations and idle gaps a traced run's breakdown lists
BREAKDOWN = 10
#: a traced run's window, at most: the profiler keeps every host op, and
#: four seconds of the busiest cell keep its trace under 200 MB
TRACE_SECONDS = 4.0


def _set_cache_dirs() -> None:
    """Every build and kernel cache the program or torch might write, at a
    fixed path inside the checkout (the program's own ``nvcc`` libraries
    already go to ``reservoir_tpu_torch/_build``)."""
    base = harness.WORK / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def result_line(cell: harness.Cell, outcome: harness.Outcome, trace: bool, device_kind: str) -> dict:
    """The contract's result object for one run."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        kind = "layer_metrics" if trace else "e2e_metrics"
        v = harness.load_module(kind, m["name"]).value(outcome)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {
        "correct": all(c.ok for c in outcome.checks),
        "attempted": sum(c.answers for c in outcome.checks),
        "failed": sum(c.wrong for c in outcome.checks),
        "metrics": metrics,
        "device": device,
    }
    tl = outcome.timeline
    if trace and tl is not None:
        device["busy_s"] = tl.busy_s()
        device["window_s"] = tl.window_s
        line["breakdown"] = {"device_ops": [[n, s] for n, s in tl.by_name()[:BREAKDOWN]],
                             "idle_gaps": [[n, s] for n, s in tl.idle_gaps()[:BREAKDOWN]]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(harness.REPO / "BENCHMARK.json") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    _set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {cell.name} needs {cell.chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds
    ctx = harness.Context(cell, args.seed, seconds, bool(args.trace), device, T0)
    outcome = harness.load_module("loops", cell.traffic["loop"]).run(ctx)
    print(f"cardbench: {cell.name} seed {args.seed}: set-up {outcome.record['setup_s']:.3f} s, window "
          f"{outcome.record['window_s']:.3f} s, then {time.perf_counter() - T0 - outcome.record['setup_s'] - outcome.record['window_s']:.3f} s "
          "to the checks (the reference, the trace's reading)", file=sys.stderr)
    line = result_line(cell, outcome, bool(args.trace), torch.cuda.get_device_name(device))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"cardbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
