"""Rule framework of the port's reservoir-lint (the port's copy of the JAX
package's ``analysis/core.py``).

Everything here is stdlib ``ast`` only: the linter runs in a bare
interpreter, imports neither torch nor jax nor the JAX package, and a full
pass costs well under a second.  A :class:`Project` is the parsed view of
one source tree: every ``.py`` file under ``reservoir_tpu_torch/`` (its
``tools/`` included) as a :class:`SourceFile` (text, AST and per-line
suppression table), plus raw-text access to cross-check targets outside
the scanned set (``BENCH.md``, ``tests/test_torch_faults.py``,
``tools/reservoir_top.py``).

Rules are objects with an ``id``, a one-line ``doc`` and a
``check(project)`` generator of :class:`Finding`; the driver
(:func:`run_lint`) applies the inline-suppression table afterwards, so a
rule never needs to know the syntax.  Suppression hygiene is checked by
the driver: a ``disable`` with no ``-- <reason>`` tail, or one naming an
unknown rule id, is a finding (rule ``suppression-hygiene``) and cannot
itself be suppressed.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "SourceFile",
    "Project",
    "Rule",
    "LintResult",
    "run_lint",
    "render_human",
    "render_json",
    "default_root",
]

#: Directories scanned (relative to the project root): the port's package,
#: whose command-line tools live inside it.  Tests are *read* by individual
#: rules for cross-checks but are not themselves linted: synthetic violation
#: sources live there on purpose.
SCAN_DIRS: Tuple[str, ...] = ("reservoir_tpu_torch",)

#: Inline suppression syntax.  The reason tail after ``--`` is mandatory;
#: a bare disable is a ``suppression-hygiene`` finding.  A comment-only
#: line applies to the next source line (for statements too long to carry
#: the comment inline).
_SUPPRESS_RE = re.compile(
    r"#\s*reservoir-lint:\s*disable=([A-Za-z0-9_,-]+)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, carrying everything a fix needs."""

    rule: str
    path: str  # project-root-relative, posix separators
    line: int
    col: int
    message: str
    hint: str = ""
    suppressed: bool = False
    reason: str = ""

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)


@dataclasses.dataclass
class _Suppression:
    rules: Tuple[str, ...]
    reason: str
    line: int  # line the comment sits on
    applies_to: int  # source line the suppression covers


class SourceFile:
    """One parsed production source: text, AST, suppression table."""

    def __init__(self, relpath: str, text: str) -> None:
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as exc:  # surfaced as a parse-error finding
            self.parse_error = exc
        #: line -> suppressions covering that line
        self.suppressions: Dict[int, List[_Suppression]] = {}
        for i, raw in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(raw)
            if m is None:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            reason = (m.group("reason") or "").strip()
            target = i + 1 if raw.lstrip().startswith("#") else i
            sup = _Suppression(rules, reason, line=i, applies_to=target)
            self.suppressions.setdefault(target, []).append(sup)

    def suppression_for(self, line: int, rule: str) -> Optional[_Suppression]:
        for sup in self.suppressions.get(line, ()):
            if rule in sup.rules:
                return sup
        return None


class Project:
    """The parsed source tree a lint run operates on."""

    def __init__(self, root: str, sources: List[SourceFile]) -> None:
        self.root = root
        self.sources = sources
        self._by_path = {s.relpath: s for s in sources}

    def source(self, relpath: str) -> Optional[SourceFile]:
        return self._by_path.get(relpath)

    def iter_sources(self, prefix: str = "") -> Iterable[SourceFile]:
        for src in self.sources:
            if src.relpath.startswith(prefix):
                yield src

    def read_text(self, relpath: str) -> Optional[str]:
        """Raw text of any file under the root (cross-check targets that
        are not part of the scanned set); ``None`` when absent."""
        path = os.path.join(self.root, relpath)
        try:
            with open(path, encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    @classmethod
    def load(cls, root: str, scan_dirs: Sequence[str] = SCAN_DIRS) -> "Project":
        sources: List[SourceFile] = []
        for d in scan_dirs:
            base = os.path.join(root, d)
            if not os.path.isdir(base):
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    n for n in dirnames
                    if n not in ("__pycache__", "_native", "_build", "csrc", ".git")
                )
                for name in sorted(filenames):
                    if not name.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, name)
                    rel = os.path.relpath(path, root).replace(os.sep, "/")
                    with open(path, encoding="utf-8") as fh:
                        sources.append(SourceFile(rel, fh.read()))
        return cls(root, sources)


class Rule:
    """Base class: subclasses set ``id``/``doc`` and yield findings."""

    id: str = ""
    doc: str = ""

    def check(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class LintResult:
    root: str
    checked_files: List[str]
    rules: List[str]
    findings: List[Finding]  # every finding, suppressed or not

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]


def default_root() -> str:
    """The repo root guessed from this package's location (the parent of
    the ``reservoir_tpu_torch`` package directory)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _hygiene_findings(src: SourceFile, known: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    seen: set = set()
    for sups in src.suppressions.values():
        for sup in sups:
            if id(sup) in seen:
                continue
            seen.add(id(sup))
            if not sup.reason:
                out.append(Finding(
                    "suppression-hygiene", src.relpath, sup.line, 0,
                    "suppression without a reason — every disable must "
                    "carry `-- <why this invariant is intentionally "
                    "waived here>`",
                    hint="write `# reservoir-lint: disable=<rule> -- "
                         "<reason>`; a bare disable is itself a finding",
                ))
            for rule in sup.rules:
                if rule not in known:
                    out.append(Finding(
                        "suppression-hygiene", src.relpath, sup.line, 0,
                        f"suppression names unknown rule id {rule!r}",
                        hint="known rules: " + ", ".join(sorted(known)),
                    ))
    return out


def run_lint(
    root: Optional[str] = None,
    rules: Optional[Sequence[Rule]] = None,
    scan_dirs: Sequence[str] = SCAN_DIRS,
) -> LintResult:
    """Run the invariant pass over ``root`` and return every finding with
    the inline-suppression table applied.  Zero *unsuppressed* findings is
    the committed-tree contract (``tests/test_torch_lint.py``)."""
    from . import all_rules  # late: rules import core

    if root is None:
        root = default_root()
    if rules is None:
        rules = all_rules()
    project = Project.load(root, scan_dirs=scan_dirs)
    # every shipped rule is known, so a waiver of a rule this run left out
    # (``--rules``) is not mistaken for an unknown one
    known = sorted({r.id for r in all_rules()} | {r.id for r in rules}) + ["parse-error"]
    findings: List[Finding] = []
    for src in project.sources:
        if src.parse_error is not None:
            findings.append(Finding(
                "parse-error", src.relpath,
                src.parse_error.lineno or 1, 0,
                f"syntax error: {src.parse_error.msg}",
            ))
        findings.extend(_hygiene_findings(src, known))
    for rule in rules:
        findings.extend(rule.check(project))
    # apply inline suppressions (hygiene findings stay unsuppressible so a
    # reasonless disable cannot silence itself)
    out: List[Finding] = []
    for f in findings:
        src = project.source(f.path)
        if f.rule != "suppression-hygiene" and src is not None and not f.suppressed:
            sup = src.suppression_for(f.line, f.rule)
            if sup is not None and sup.reason:
                f = dataclasses.replace(f, suppressed=True, reason=sup.reason)
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(
        root=root,
        checked_files=[s.relpath for s in project.sources],
        rules=[r.id for r in rules],
        findings=out,
    )


def render_human(result: LintResult) -> str:
    lines: List[str] = []
    for f in result.unsuppressed:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
        if f.hint:
            lines.append(f"    hint: {f.hint}")
    n, m = len(result.unsuppressed), len(result.suppressed)
    lines.append(
        f"{len(result.checked_files)} file(s) checked, "
        f"{n} finding(s), {m} suppressed"
    )
    return "\n".join(lines)


def _finding_dict(f: Finding) -> Dict[str, object]:
    d: Dict[str, object] = {
        "rule": f.rule, "file": f.path, "line": f.line, "col": f.col,
        "message": f.message, "hint": f.hint,
    }
    if f.suppressed:
        d["reason"] = f.reason
    return d


def render_json(result: LintResult) -> str:
    by_rule: Dict[str, int] = {}
    for f in result.unsuppressed:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    doc = {
        "version": 1,
        "root": result.root,
        "files": len(result.checked_files),
        "rules": result.rules,
        "findings": [_finding_dict(f) for f in result.unsuppressed],
        "suppressed": [_finding_dict(f) for f in result.suppressed],
        "summary": {
            "findings": len(result.unsuppressed),
            "suppressed": len(result.suppressed),
            "by_rule": by_rule,
        },
    }
    return json.dumps(doc, indent=2, sort_keys=True)


# --------------------------------------------------------------- AST helpers
# shared by the rule modules

def resolve_import_aliases(
    tree: ast.AST, leaf_names: Sequence[str], package_hint: str
) -> Dict[str, str]:
    """Map local alias -> leaf module name for imports of
    ``<package_hint>.<leaf>`` in any spelling (absolute, relative,
    ``from pkg import leaf as alias``).  ``leaf_names`` restricts which
    leaves are of interest (e.g. ``("registry", "trace", "flight")``)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                local = a.asname or a.name
                # from ..obs import registry as _obs  /  from . import faults
                # (a bare relative import has module=None; the leaf names
                # are distinctive enough to match on their own)
                if (mod == package_hint or mod.endswith("." + package_hint)
                        or (node.level and not mod)):
                    if a.name in leaf_names:
                        aliases[local] = a.name
                # from ..obs.registry import get  (bare-function import)
                for leaf in leaf_names:
                    suffix = f"{package_hint}.{leaf}"
                    if mod == suffix or mod.endswith("." + suffix):
                        aliases[local] = f"{leaf}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                for leaf in leaf_names:
                    suffix = f"{package_hint}.{leaf}"
                    if a.name == suffix or a.name.endswith("." + suffix):
                        aliases[a.asname or a.name.split(".")[0]] = leaf
    return aliases


def first_str_literal(node: ast.AST) -> Optional[Tuple[str, int, int]]:
    """The first string literal inside ``node`` (depth-first), as
    ``(value, line, col)`` — how instrument/site names are extracted from
    possibly-wrapped call arguments like ``scoped("serve.ingest_s", s)``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            return sub.value, sub.lineno, sub.col_offset
    return None


def iter_functions(tree: ast.AST) -> Iterable[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_no_nested(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested function/class
    scopes (their bodies are separate analyses)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(sub))


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else ``None``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_TERMINAL = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def block_terminates(stmts: Sequence[ast.stmt]) -> bool:
    """True when falling off the end of ``stmts`` is impossible."""
    return bool(stmts) and isinstance(stmts[-1], _TERMINAL)


Formatter = Callable[[Finding], str]
