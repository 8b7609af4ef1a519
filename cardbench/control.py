"""The control: the reference, computed in the precision below the one the
configuration states, put in the program's place.  It has to come out not
correct, which shows that the comparison that decides ``correct`` can fail.

    python -m cardbench.control --workload <name> --seeds 11,12,13 --seconds <s>

runs, for each seed, the cell's loop on the card as a benchmark run does
(the program's window at the cell's own load, so the control compares as
many answers as a run), then replaces every answer the run read with the
control's and compares them with the reference.  One JSON line a seed:
its checks, each with its value and limit.  The benchmark's own runs never
run it.  The configurations' controls: weighted, the weights rounded to
bfloat16; distinct, its int32 keys cut to int16.
"""

from __future__ import annotations

from cardbench.harness import process_start

T0 = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from cardbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    with open(harness.REPO / "BENCHMARK.json") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("cardbench.control: no CUDA card", file=sys.stderr)
        return 2
    control = harness.load_module("modes", cell.config["mode"]).CONTROL
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False, torch.device("cuda", 0), T0, precision=control)
        outcome = harness.load_module("loops", cell.traffic["loop"]).run(ctx)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                          "correct": all(c.ok for c in outcome.checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit, "answers": c.answers,
                                              "wrong": c.wrong} for c in outcome.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
