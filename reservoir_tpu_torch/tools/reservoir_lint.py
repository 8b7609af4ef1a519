"""reservoir-lint over the port: the AST invariant pass over
``reservoir_tpu_torch/``.

Usage::

    python -m reservoir_tpu_torch.tools.reservoir_lint                 # human output
    python -m reservoir_tpu_torch.tools.reservoir_lint --json          # machine-readable report
    python -m reservoir_tpu_torch.tools.reservoir_lint --rules guarded-by,zero-overhead-gate
    python -m reservoir_tpu_torch.tools.reservoir_lint --list-rules

Exit codes: 0 = zero unsuppressed findings, 1 = findings, 2 = usage error.
It imports no torch, no jax and nothing of the JAX package (the standard
library only), so it can run before any device work.
"""

from __future__ import annotations

import argparse
import sys

from reservoir_tpu_torch.analysis import (
    all_rules,
    default_root,
    render_human,
    render_json,
    run_lint,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="reservoir-lint",
        description="AST invariant checker of the port (rule catalog in "
                    "reservoir_tpu_torch/analysis/__init__.py)",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report instead of human output")
    ap.add_argument("--root", default=None,
                    help="project root (default: the checkout this package lives in)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.id}\n    {rule.doc}")
        return 0
    if args.rules:
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        known = {r.id for r in rules}
        unknown = [w for w in wanted if w not in known]
        if unknown:
            print(f"reservoir-lint: unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    result = run_lint(root=args.root or default_root(), rules=rules)
    print(render_json(result) if args.json else render_human(result))
    return 0 if not result.unsuppressed else 1


if __name__ == "__main__":
    sys.exit(main())
