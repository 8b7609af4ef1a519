"""``zero-overhead-gate``: the one-global-load + ``is None`` discipline
(the port's copy of the JAX package's ``analysis/rules_gating.py``, over
the port's ``obs/registry.py``, ``obs/trace.py``, ``obs/flight.py`` and
``utils/faults.py``).

Every hot path that emits telemetry follows one pattern::

    reg = _obs.get()          # one module-global load
    if reg is not None:       # one None test — the ENTIRE cost when off
        reg.counter("plane.metric").inc()

This rule makes that contract statically total: inside any function, a
variable bound from ``obs.registry.get()`` / ``obs.trace.get()`` /
``obs.flight.get()`` may only be *used* (attribute call — the instrument
traffic) at points dominated by an ``is None`` test of that variable.
The dominance analysis is a forward walk over the function body that
understands:

- ``if x is not None: ...`` (and the ``else`` of ``if x is None:``),
- early exits — ``if x is None: return/raise/continue/break`` guards the
  rest of the enclosing block,
- ``and``/``or`` short-circuit chains (``x is not None and x.f()``),
- conditional expressions (``x.span() if x is not None else nullcontext()``),
- ``assert x is not None``.

Chained ``_obs.get().counter(...)`` is always a finding: the lookup runs
even when telemetry is off.  The fault plane's discipline is the dual:
:func:`reservoir_tpu_torch.utils.faults.fire` carries the gate *inside*, so
hot code must call the module-level ``fire`` — a direct ``plane.fire()``
on a held :class:`FaultPlane` bypasses the disabled-path guarantee and
is flagged too.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .core import (
    Finding,
    Project,
    Rule,
    SourceFile,
    block_terminates,
    resolve_import_aliases,
)

__all__ = ["ZeroOverheadGateRule"]

#: The defining modules themselves are exempt (their internals *are* the
#: gate), as is the faults module for the direct-``fire`` check.
_EXEMPT = (
    "reservoir_tpu_torch/obs/registry.py",
    "reservoir_tpu_torch/obs/trace.py",
    "reservoir_tpu_torch/obs/flight.py",
)
_FAULTS_MODULE = "reservoir_tpu_torch/utils/faults.py"

_OBS_LEAVES = ("registry", "trace", "flight")


def _gate_call_kind(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """``"registry"``/``"trace"``/``"flight"`` when ``node`` is a call of
    that module's global accessor (``_obs.get()`` or a bare imported
    ``get()``), else ``None``."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        kind = aliases.get(fn.value.id)
        if kind in _OBS_LEAVES and fn.attr == "get":
            return kind
    elif isinstance(fn, ast.Name):
        kind = aliases.get(fn.id)
        if kind is not None and "." in kind:
            leaf, member = kind.split(".", 1)
            if leaf in _OBS_LEAVES and member == "get":
                return leaf
    return None


def _none_test(node: ast.AST) -> Optional[Tuple[str, bool]]:
    """``(varname, is_not_none)`` for ``x is None`` / ``x is not None``."""
    if (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.left, ast.Name)
            and isinstance(node.comparators[0], ast.Constant)
            and node.comparators[0].value is None):
        if isinstance(node.ops[0], ast.Is):
            return node.left.id, False
        if isinstance(node.ops[0], ast.IsNot):
            return node.left.id, True
    return None


class _FunctionChecker:
    """Forward dominance walk over one function body."""

    def __init__(self, rule: "ZeroOverheadGateRule", src: SourceFile,
                 aliases: Dict[str, str]) -> None:
        self.rule = rule
        self.src = src
        self.aliases = aliases
        self.tracked: Set[str] = set()
        self.findings: List[Finding] = []

    # -- guard extraction -------------------------------------------------

    def _guards_if_true(self, test: ast.AST) -> Set[str]:
        """Vars known non-None when ``test`` is truthy."""
        out: Set[str] = set()
        t = _none_test(test)
        if t is not None and t[1]:
            out.add(t[0])
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for v in test.values:
                out |= self._guards_if_true(v)
        return out

    def _guards_if_false(self, test: ast.AST) -> Set[str]:
        """Vars known non-None when ``test`` is falsy."""
        out: Set[str] = set()
        t = _none_test(test)
        if t is not None and not t[1]:
            out.add(t[0])
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
            for v in test.values:
                out |= self._guards_if_false(v)
        return out

    # -- expression scan --------------------------------------------------

    def _scan_expr(self, node: ast.AST, guarded: FrozenSet[str]) -> None:
        """Flag unguarded uses inside one expression, handling the
        short-circuit forms locally."""
        if isinstance(node, ast.IfExp):
            self._scan_expr(node.test, guarded)
            self._scan_expr(
                node.body, guarded | self._guards_if_true(node.test))
            self._scan_expr(
                node.orelse, guarded | self._guards_if_false(node.test))
            return
        if isinstance(node, ast.BoolOp):
            acc = set(guarded)
            for v in node.values:
                self._scan_expr(v, frozenset(acc))
                if isinstance(node.op, ast.And):
                    acc |= self._guards_if_true(v)
                else:
                    acc |= self._guards_if_false(v)
            return
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            var = node.value.id
            if var in self.tracked and var not in guarded:
                self._flag_use(node, var)
            return
        if (isinstance(node, ast.Attribute)
                and _gate_call_kind(node.value, self.aliases) is not None):
            self._flag_chain(node)
            # still scan the call's arguments
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # separate scope
        for child in ast.iter_child_nodes(node):
            self._scan_expr(child, guarded)

    def _flag_use(self, node: ast.AST, var: str) -> None:
        self.findings.append(Finding(
            self.rule.id, self.src.relpath, node.lineno, node.col_offset,
            f"instrument use of {var!r} (bound from a telemetry get()) is "
            f"not dominated by an `{var} is None` guard",
            hint=self.rule.hint,
        ))

    def _flag_chain(self, node: ast.AST) -> None:
        self.findings.append(Finding(
            self.rule.id, self.src.relpath, node.lineno, node.col_offset,
            "chained telemetry call on get() — the instrument lookup runs "
            "even when the plane is disabled",
            hint=self.rule.hint,
        ))

    # -- statement walk ---------------------------------------------------

    def run(self, body: List[ast.stmt]) -> List[Finding]:
        self._walk_block(body, frozenset())
        return self.findings

    def _track_assign(self, stmt: ast.stmt) -> Optional[str]:
        """Returns the var newly bound from a gate get(), handling plain
        single-target assignment; any other rebind untracks the name."""
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            var = stmt.targets[0].id
            if _gate_call_kind(stmt.value, self.aliases) is not None:
                return var
            self.tracked.discard(var)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            if stmt.value is not None and \
                    _gate_call_kind(stmt.value, self.aliases) is not None:
                return stmt.target.id
            self.tracked.discard(stmt.target.id)
        return None

    def _walk_block(self, stmts: List[ast.stmt],
                    guarded: FrozenSet[str]) -> None:
        g = set(guarded)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scope: analyzed on its own
            if isinstance(stmt, ast.If):
                self._scan_expr(stmt.test, frozenset(g))
                body_g = frozenset(g | self._guards_if_true(stmt.test))
                else_g = frozenset(g | self._guards_if_false(stmt.test))
                self._walk_block(stmt.body, body_g)
                self._walk_block(stmt.orelse, else_g)
                # early exit: `if x is None: return` guards the rest
                if block_terminates(stmt.body):
                    g |= self._guards_if_false(stmt.test)
                if stmt.orelse and block_terminates(stmt.orelse):
                    g |= self._guards_if_true(stmt.test)
                continue
            if isinstance(stmt, ast.Assert):
                self._scan_expr(stmt.test, frozenset(g))
                g |= self._guards_if_true(stmt.test)
                continue
            if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                if isinstance(stmt, ast.While):
                    self._scan_expr(stmt.test, frozenset(g))
                    inner = frozenset(g | self._guards_if_true(stmt.test))
                else:
                    self._scan_expr(stmt.iter, frozenset(g))
                    inner = frozenset(g)
                self._walk_block(stmt.body, inner)
                self._walk_block(stmt.orelse, frozenset(g))
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr(item.context_expr, frozenset(g))
                self._walk_block(stmt.body, frozenset(g))
                continue
            if isinstance(stmt, ast.Try):
                self._walk_block(stmt.body, frozenset(g))
                for handler in stmt.handlers:
                    self._walk_block(handler.body, frozenset(g))
                self._walk_block(stmt.orelse, frozenset(g))
                self._walk_block(stmt.finalbody, frozenset(g))
                continue
            # plain statement: scan expressions, then track new bindings
            # (the binding statement's own value was already scanned)
            new_var = self._track_assign(stmt)
            if new_var is not None:
                # scan any other expressions in the statement (arguments
                # of the get() call are alias loads, never tracked uses)
                self.tracked.add(new_var)
                g.discard(new_var)
                continue
            self._scan_expr(stmt, frozenset(g))


class ZeroOverheadGateRule(Rule):
    id = "zero-overhead-gate"
    doc = (
        "hot-path telemetry must follow `x = <obs>.get()` + `if x is not "
        "None:` — instrument calls not dominated by the None test (or "
        "chained straight off get()) defeat the zero-overhead-when-"
        "disabled contract"
    )
    hint = (
        "bind the accessor once (`reg = _obs.get()`) and guard every "
        "instrument call with `if reg is not None:` — the disabled path "
        "must cost one global load + one is-None test; for faults, call "
        "the module-level faults.fire(site, plane) which carries the gate "
        "inside"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for src in project.sources:
            if src.tree is None or src.relpath in _EXEMPT:
                continue
            aliases = resolve_import_aliases(src.tree, _OBS_LEAVES, "obs")
            if aliases:
                for node in ast.walk(src.tree):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        checker = _FunctionChecker(self, src, aliases)
                        yield from checker.run(node.body)
                # module level: chained get() calls outside any function
                checker = _FunctionChecker(self, src, aliases)
                yield from checker.run(
                    [s for s in src.tree.body
                     if not isinstance(s, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))])
            if src.relpath != _FAULTS_MODULE:
                yield from self._check_direct_fire(src)

    def _check_direct_fire(self, src: SourceFile) -> Iterable[Finding]:
        faults_aliases = resolve_import_aliases(
            src.tree, ("faults",), "utils")
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"):
                continue
            recv = node.func.value
            if isinstance(recv, ast.Name) and \
                    faults_aliases.get(recv.id) == "faults":
                continue  # module-level faults.fire — self-gating
            yield Finding(
                self.id, src.relpath, node.lineno, node.col_offset,
                "direct .fire() on a held FaultPlane bypasses the "
                "module-level gate (one global load + is-None when no "
                "plane is installed)",
                hint=self.hint,
            )
