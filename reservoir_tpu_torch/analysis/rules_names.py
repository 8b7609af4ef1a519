"""``instrument-name-grammar``: metric names parse, and the docs/top
rendering can't drift from what the code actually emits (the port's copy of
the JAX package's ``analysis/rules_names.py``, over the port's emissions).

Every counter/gauge/histogram name literal handed to the registry must
match the ``plane.metric`` grammar (``^[a-z][a-z0-9_]*\\.[a-z][a-z0-9_]*$``
— the per-shard ``@scope`` suffix is appended at runtime by
``obs.registry.scoped`` and is not part of the literal).  On top of the
style check sit two drift detectors:

- **render drift**: a grammar-shaped literal in ``tools/reservoir_top.py``
  (the repository's top tool, which renders the port's heartbeat and
  status files unchanged) whose plane is one the port emits, but whose
  full name nothing in the port emits, renders a permanently blank row —
  the exact bug class of a metric rename that misses the top tool;
- **doc drift**: every emitted name must appear in ``BENCH.md`` (the
  "Instrument name catalog" section is the canonical list, the one the
  JAX package's rule checks), and every catalog entry must be emitted by
  some call site.  Docs describing metrics that no longer exist are worse
  than no docs.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, Project, Rule, SourceFile

__all__ = ["InstrumentNameRule", "emitted_instrument_names"]

_GRAMMAR = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")
_EMIT_METHODS = ("counter", "gauge", "histogram")
_REGISTRY_MODULE = "reservoir_tpu_torch/obs/registry.py"
_TOP_TOOL = "tools/reservoir_top.py"
_BENCH_DOC = "BENCH.md"
_CATALOG_HEADING = "instrument name catalog"


def _name_literals(expr: ast.AST) -> List[Tuple[str, int, int]]:
    """Every string literal the name expression can evaluate to.

    A conditional name (``"a.b" if fast else "a.c"``) emits *both*
    branches; an f-string name is dynamic — its fragments are not names,
    so the walk does not descend into :class:`ast.JoinedStr` (dynamic
    names are checked by the runtime registry, not statically)."""
    out: List[Tuple[str, int, int]] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.JoinedStr):
            return
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append((node.value, node.lineno, node.col_offset))
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return out


def _emit_literals(node: ast.Call) -> List[Tuple[str, int, int]]:
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _EMIT_METHODS):
        return []
    for kw in node.keywords:
        if kw.arg == "name":
            return _name_literals(kw.value)
    if node.args:
        return _name_literals(node.args[0])
    return []


def emitted_instrument_names(project: Project) -> Dict[str, List[Tuple[str, int]]]:
    """``{name: [(relpath, line), ...]}`` of every literal instrument name
    emitted through ``.counter()``/``.gauge()``/``.histogram()`` in the
    scanned tree (the registry's own module excluded — its methods are
    the definition, not an emission)."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for src in project.sources:
        if src.tree is None or src.relpath == _REGISTRY_MODULE:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            for name, line, _col in _emit_literals(node):
                out.setdefault(name, []).append((src.relpath, line))
    return out


def _catalog_names(bench_text: str) -> Dict[str, int]:
    """Backticked grammar-shaped names inside the catalog section of
    BENCH.md, mapped to their line numbers."""
    lines = bench_text.splitlines()
    names: Dict[str, int] = {}
    in_section = False
    section_level = 0
    for i, line in enumerate(lines, start=1):
        m = re.match(r"^(#+)\s*(.*)$", line)
        if m:
            level = len(m.group(1))
            if _CATALOG_HEADING in m.group(2).lower():
                in_section, section_level = True, level
                continue
            if in_section and level <= section_level:
                in_section = False
        if in_section:
            for name in re.findall(r"`([a-z][a-z0-9_]*\.[a-z][a-z0-9_]*)`",
                                   line):
                names.setdefault(name, i)
    return names


class InstrumentNameRule(Rule):
    id = "instrument-name-grammar"
    doc = (
        "instrument name literals must match the plane.metric grammar; "
        "the emitted-name set is cross-checked against the names "
        "reservoir_top renders and the BENCH.md catalog (doc-drift "
        "detector, not just a style check)"
    )
    hint = (
        "name instruments `plane.metric` (lowercase, underscores; the "
        "@scope suffix is runtime-only), add new names to the "
        "'Instrument name catalog' section of BENCH.md, and keep "
        "tools/reservoir_top.py's rendered names in the emitted set"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        emitted = emitted_instrument_names(project)

        # 1. grammar over every emitted literal
        for name, sites in emitted.items():
            if _GRAMMAR.match(name):
                continue
            for relpath, line in sites:
                yield Finding(
                    self.id, relpath, line, 0,
                    f"instrument name {name!r} does not match the "
                    "plane.metric grammar",
                    hint=self.hint,
                )
        valid_names = {n for n in emitted if _GRAMMAR.match(n)}
        planes = {n.split(".", 1)[0] for n in valid_names}

        # 2. render drift: reservoir_top names nothing emits (the tool is
        # outside the scanned tree: parsed from its text)
        top_text = project.read_text(_TOP_TOOL)
        top = SourceFile(_TOP_TOOL, top_text) if top_text is not None else None
        if top is not None and top.tree is not None:
            seen: Set[Tuple[str, int]] = set()
            for node in ast.walk(top.tree):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                name = node.value
                if not _GRAMMAR.match(name):
                    continue
                if name.split(".", 1)[0] not in planes:
                    continue  # not a metric family (file names etc.)
                if name in valid_names or (name, node.lineno) in seen:
                    continue
                seen.add((name, node.lineno))
                yield Finding(
                    self.id, _TOP_TOOL, node.lineno, node.col_offset,
                    f"reservoir_top renders {name!r} but no production "
                    "call site emits it — the row will stay blank "
                    "forever (rename drift)",
                    hint=self.hint,
                )

        # 3. doc drift, both directions, against BENCH.md
        bench = project.read_text(_BENCH_DOC)
        if bench is None:
            return
        for name in sorted(valid_names):
            if name in bench:
                continue
            relpath, line = emitted[name][0]
            yield Finding(
                self.id, relpath, line, 0,
                f"emitted instrument {name!r} is not documented in "
                f"{_BENCH_DOC} (add it to the Instrument name catalog)",
                hint=self.hint,
            )
        for name, line in sorted(_catalog_names(bench).items()):
            if name not in valid_names:
                yield Finding(
                    self.id, _BENCH_DOC, line, 0,
                    f"BENCH.md catalogs {name!r} but no production call "
                    "site emits it (stale docs)",
                    hint=self.hint,
                )
