"""``guarded-by``: a lightweight static race detector for lock-guarded
mutable state (the port's copy of the JAX package's
``analysis/rules_locks.py``, over the port's modules that take a lock).

In the threading-aware modules (the session table, the stream bridge's
flush pipeline, the instrument registry, the event log, the trace and the
flight recorder, the fault plane, the interop server, the native
libraries' and kernels' build and load caches, the kernels' launch
counts), an attribute that is ever *written* under ``with self._lock:``
(or ``with self._cv:``) in a non-``__init__`` method is treated as
guarded-by that lock: every other read or write of it in the class must
also happen under the lock.  ``__init__`` writes are construction
(single-threaded by contract) and neither establish nor violate the
guard.

Escape hatches, both deliberate and visible:

- a method whose name ends in ``_locked`` is a caller-holds-the-lock
  helper and is skipped (the call sites inside ``with`` blocks are
  checked instead);
- an intentionally benign race (e.g. a lock-free monotonic-counter read
  in a ``value`` property) is suppressed **per attribute**: put
  ``# reservoir-lint: disable=guarded-by -- <why>`` either on the
  offending access line, or on the attribute's ``__init__`` assignment
  to waive the attribute class-wide.  Attribute-level waivers still show
  up in the suppressed ledger of every lint run.

The port adds the module-level form of the same rule: a module-level name
that a function of the module writes (rebinds through ``global``, or
stores into by subscript) under ``with <module lock>:``, where the lock is
a module-level name bound to a ``Lock()``/``RLock()``/``Condition()`` or
imported under a name ending in ``LOCK``, must not be read or written
outside the lock by any function of that module.  The module's top-level
statements are its construction and are not checked.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set

from .core import Finding, Project, Rule, SourceFile, dotted

__all__ = ["GuardedByRule"]

#: The modules whose classes or module-level state are shared across
#: threads and taken under a lock (``serve/sessions.py`` as in the
#: reference's list, though the port's session table has no lock of its
#: own: its service serializes it).
THREADING_AWARE_MODULES = (
    "reservoir_tpu_torch/_build.py",
    "reservoir_tpu_torch/native.py",
    "reservoir_tpu_torch/obs/events.py",
    "reservoir_tpu_torch/obs/flight.py",
    "reservoir_tpu_torch/obs/registry.py",
    "reservoir_tpu_torch/obs/trace.py",
    "reservoir_tpu_torch/ops/_cuda_common.py",
    "reservoir_tpu_torch/ops/algorithm_l_cuda.py",
    "reservoir_tpu_torch/ops/distinct_cuda.py",
    "reservoir_tpu_torch/ops/merge_cuda.py",
    "reservoir_tpu_torch/ops/weighted_cuda.py",
    "reservoir_tpu_torch/serve/sessions.py",
    "reservoir_tpu_torch/stream/bridge.py",
    "reservoir_tpu_torch/stream/interop.py",
    "reservoir_tpu_torch/utils/faults.py",
)

_LOCK_FACTORIES = ("Lock", "RLock", "Condition")
_DEFAULT_LOCK_NAMES = ("_lock", "_cv")


def _is_lock_factory(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func) or ""
    return name.rsplit(".", 1)[-1] in _LOCK_FACTORIES


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Access:
    __slots__ = ("attr", "write", "line", "col", "under_lock", "method")

    def __init__(self, attr: str, write: bool, line: int, col: int,
                 under_lock: bool, method: str) -> None:
        self.attr = attr
        self.write = write
        self.line = line
        self.col = col
        self.under_lock = under_lock
        self.method = method


def _collect_accesses(
    method: ast.AST, lock_attrs: Set[str]
) -> List[_Access]:
    """Every ``self.X`` access in ``method`` with its lock context,
    walking lexically so nesting inside ``with self._lock:`` is
    tracked.  Nested function defs inherit the surrounding context
    (closures run where they are called, but in this codebase they are
    invoked in place — over-approximating keeps the walk simple and any
    false positive is one suppression away)."""
    out: List[_Access] = []
    name = getattr(method, "name", "<lambda>")

    def visit(node: ast.AST, under: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            takes_lock = under
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr in lock_attrs:
                    takes_lock = True
                visit(item.context_expr, under)
            for stmt in node.body:
                visit(stmt, takes_lock)
            return
        attr = _self_attr(node)
        if attr is not None and attr not in lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            out.append(_Access(attr, is_write, node.lineno,
                               node.col_offset, under, name))
        for child in ast.iter_child_nodes(node):
            visit(child, under)

    for stmt in method.body:
        visit(stmt, False)
    return out


def _collect_global_accesses(fn: ast.AST, locks: Set[str], names: Set[str],
                             declared: Set[str]) -> List[_Access]:
    """Every access in ``fn`` of a module-level name of ``names`` with its
    lock context: a rebinding (through ``global``) or a subscript store is
    a write, any other load a read.  A name the function binds locally
    without ``global`` is its own and is skipped."""
    local = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
             and isinstance(n.ctx, ast.Store)} - declared
    args = {a.arg for a in ast.walk(fn) if isinstance(a, ast.arg)}
    mine = names - ((local | args) - declared)
    out: List[_Access] = []
    name = getattr(fn, "name", "<lambda>")

    def visit(node: ast.AST, under: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            takes = under or any(isinstance(i.context_expr, ast.Name) and i.context_expr.id in locks
                                 for i in node.items)
            for item in node.items:
                visit(item.context_expr, under)
            for stmt in node.body:
                visit(stmt, takes)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and node is not fn:
            return  # a nested function is checked on its own
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id in mine and isinstance(node.ctx, (ast.Store, ast.Del)):
            out.append(_Access(node.value.id, True, node.lineno, node.col_offset, under, name))
            visit(node.slice, under)
            return
        if isinstance(node, ast.Name) and node.id in mine:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            out.append(_Access(node.id, write, node.lineno, node.col_offset, under, name))
        for child in ast.iter_child_nodes(node):
            visit(child, under)

    for stmt in fn.body:
        visit(stmt, False)
    return out


class GuardedByRule(Rule):
    id = "guarded-by"
    doc = (
        "attributes written under `with self._lock` in any method must "
        "never be read or written outside the lock in that class, nor "
        "module globals written under a module lock outside it "
        "(threading-aware modules; benign races need an attribute-level "
        "suppression)"
    )
    hint = (
        "take the lock around the access, move it into a `*_locked` "
        "helper called under the lock, or — for an intentionally benign "
        "race — suppress per attribute: `# reservoir-lint: "
        "disable=guarded-by -- <why the race is safe>` on the access or "
        "on the attribute's __init__ assignment"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        for relpath in THREADING_AWARE_MODULES:
            src = project.source(relpath)
            if src is None or src.tree is None:
                continue
            for node in src.tree.body if src.tree else ():
                if isinstance(node, ast.ClassDef):
                    yield from self._check_class(src, node)
            yield from self._check_module(src)

    def _check_module(self, src: SourceFile) -> Iterable[Finding]:
        """The module-level form: globals written under a module lock."""
        tree = src.tree
        top_names: Dict[str, int] = {}
        locks: Set[str] = set()
        for node in tree.body:
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, ast.AnnAssign) else [])
            for t in targets:
                if isinstance(t, ast.Name):
                    top_names.setdefault(t.id, t.lineno)
                    if _is_lock_factory(node.value):
                        locks.add(t.id)
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    local = a.asname or a.name
                    if local.endswith("LOCK"):
                        locks.add(local)
        if not locks:
            return
        funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        accesses: List[_Access] = []
        for fn in funcs:
            declared = {n for s in ast.walk(fn) if isinstance(s, ast.Global) for n in s.names}
            accesses.extend(_collect_global_accesses(fn, locks, set(top_names) - locks, declared))
        guarded = {a.attr for a in accesses if a.write and a.under_lock}
        for a in accesses:
            if a.attr not in guarded or a.under_lock:
                continue
            kind = "write" if a.write else "read"
            finding = Finding(
                self.id, src.relpath, a.line, a.col,
                f"unlocked {kind} of module-level {a.attr} in {a.method}() — "
                "it is written under the module's lock elsewhere",
                hint=self.hint,
            )
            sup = src.suppression_for(top_names[a.attr], self.id)
            if sup is not None and sup.reason:
                finding = dataclasses.replace(finding, suppressed=True, reason=sup.reason)
            yield finding

    def _check_class(self, src: SourceFile,
                     cls: ast.ClassDef) -> Iterable[Finding]:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # lock attrs: assigned a Lock()/RLock()/Condition(), or the
        # conventional names used in a `with self.<name>:` anywhere
        lock_attrs: Set[str] = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr and _is_lock_factory(node.value):
                            lock_attrs.add(attr)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        attr = _self_attr(item.context_expr)
                        if attr in _DEFAULT_LOCK_NAMES:
                            lock_attrs.add(attr)
        if not lock_attrs:
            return

        accesses: List[_Access] = []
        init_lines: Dict[str, int] = {}
        for m in methods:
            if m.name == "__init__":
                for node in ast.walk(m):
                    if isinstance(node, ast.Assign):
                        for t in node.targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                init_lines.setdefault(attr, t.lineno)
                continue  # construction is single-threaded by contract
            if m.name.endswith("_locked"):
                continue  # caller-holds-lock helper, by convention
            accesses.extend(_collect_accesses(m, lock_attrs))

        guarded: Set[str] = {a.attr for a in accesses
                             if a.write and a.under_lock}
        for a in accesses:
            if a.attr not in guarded or a.under_lock:
                continue
            kind = "write" if a.write else "read"
            finding = Finding(
                self.id, src.relpath, a.line, a.col,
                f"unlocked {kind} of {cls.name}.{a.attr} in "
                f"{a.method}() — the attribute is written under the "
                "lock elsewhere in this class",
                hint=self.hint,
            )
            # attribute-level waiver on the __init__ declaration line
            decl = init_lines.get(a.attr)
            if decl is not None:
                sup = src.suppression_for(decl, self.id)
                if sup is not None and sup.reason:
                    finding = Finding(
                        self.id, src.relpath, a.line, a.col,
                        finding.message, hint=finding.hint,
                        suppressed=True, reason=sup.reason,
                    )
            yield finding
