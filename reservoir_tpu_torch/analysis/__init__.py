"""reservoir-lint over the port: an AST invariant checker for the
disciplines its runtime tests can only trip-wire (the port's copy of the
JAX package's ``analysis/``, keyed to ``reservoir_tpu_torch/``).

The port's ~24k lines hold together by conventions that live in
docstrings: its plain versions compute transcendentals only through
``ops/fmath.py``, the kernels' bit-for-bit twin; every telemetry hot path
pays one global load and one ``is None`` test when telemetry is off; the
``faults.SITES`` registry names every injection site; and mutable state
shared across threads is taken under its lock.  Each is a property of the
code's shape, so this package checks it statically, with the standard
library only: no torch, no jax and nothing of the JAX package is imported,
and a pass takes well under a second.

Run it::

    python -m reservoir_tpu_torch.tools.reservoir_lint          # exit 1 on findings
    python -m reservoir_tpu_torch.tools.reservoir_lint --json   # machine-readable report

or in-process (the committed-tree contract of ``tests/test_torch_lint.py``)::

    from reservoir_tpu_torch.analysis import run_lint
    assert run_lint().unsuppressed == []

Rule catalog
============

``bitexact-no-numpy-transcendentals``
    numpy's ``log/exp/log1p/expm1/power`` and torch's
    ``log/exp/log1p/expm1/pow`` (Tensor methods and in-place forms
    included) are forbidden in device-path modules (``ops/``,
    ``stream/gate.py``) but ``ops/fmath.py``; host-only modules are
    allowlisted by path
    (:data:`~reservoir_tpu_torch.analysis.rules_numerics.HOST_ALLOWLIST`).

``zero-overhead-gate``
    A variable bound from ``obs.registry.get()`` / ``obs.trace.get()`` /
    ``obs.flight.get()`` may only be used at points dominated by its
    ``is None`` test; chained ``get().counter(...)`` and a direct
    ``plane.fire()`` on a held fault plane are flagged too.

``fault-site-registry``
    Every ``fire()``/``FaultRule`` site literal is a member of
    ``faults.SITES``; every entry has a call site in the package and
    appears in ``tests/test_torch_faults.py``, whose all-sites sweep
    imports :func:`site_inventory`.

``instrument-name-grammar``
    Instrument name literals match ``plane.metric``; the emitted names are
    cross-checked against what ``tools/reservoir_top.py`` renders and what
    ``BENCH.md``'s "Instrument name catalog" documents, both directions.

``guarded-by``
    In the threading-aware modules, an attribute written under
    ``with self._lock:`` in any method is never read or written outside
    the lock in that class, and a module global written under a module
    lock is never touched outside it in that module.

The reference's ``no-wallclock-in-traced`` has no counterpart: the port
traces nothing (see :mod:`~reservoir_tpu_torch.analysis.rules_numerics`).
Driver-level rules: ``parse-error`` and ``suppression-hygiene``; neither
is suppressible.

Suppression syntax
==================

Findings are silenced inline, and the reason is part of the syntax::

    self._hits[site] = hit + 1  # reservoir-lint: disable=guarded-by -- single-writer by protocol

- ``disable=`` takes a comma-separated list of rule ids;
- the ``-- <reason>`` tail is mandatory: a bare disable is itself a
  finding (``suppression-hygiene``);
- a comment-only line applies to the next source line;
- ``guarded-by`` also takes an attribute-level waiver on the attribute's
  ``__init__`` assignment (or a module global's top-level assignment),
  covering every access of it (still listed in the suppressed ledger).

The committed-tree contract (``tests/test_torch_lint.py``): zero
unsuppressed findings over ``reservoir_tpu_torch/``.
"""

from __future__ import annotations

from typing import List

from .core import (  # noqa: F401
    Finding,
    LintResult,
    Project,
    Rule,
    default_root,
    render_human,
    render_json,
    run_lint,
)
from .rules_faults import FaultSiteRegistryRule, site_inventory  # noqa: F401
from .rules_gating import ZeroOverheadGateRule
from .rules_locks import GuardedByRule
from .rules_names import InstrumentNameRule, emitted_instrument_names  # noqa: F401
from .rules_numerics import BitexactRule

__all__ = [
    "Finding",
    "LintResult",
    "Project",
    "Rule",
    "run_lint",
    "render_human",
    "render_json",
    "default_root",
    "all_rules",
    "site_inventory",
    "emitted_instrument_names",
]


def all_rules() -> List[Rule]:
    """One fresh instance of every rule, in catalog order."""
    return [
        BitexactRule(),
        ZeroOverheadGateRule(),
        FaultSiteRegistryRule(),
        InstrumentNameRule(),
        GuardedByRule(),
    ]
