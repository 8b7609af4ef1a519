"""``fault-site-registry``: the :data:`reservoir_tpu_torch.utils.faults.SITES`
registry and its call sites stay mutually honest (the port's copy of the
JAX package's ``analysis/rules_faults.py``).

Three mutually-reinforcing checks:

1. every ``site`` string handed to ``faults.fire(...)`` (or named in a
   production ``FaultRule(site=...)``) is a member of ``SITES`` — an
   unknown site silently never fires, which is exactly the failure mode
   the registry exists to prevent;
2. every ``SITES`` entry is referenced by at least one production
   ``fire()`` call site — a dead entry advertises fault coverage that
   does not exist.  (One *registry entry* may legally have several call
   sites: the entry names a failure domain, e.g. ``native.staging``
   fires on both the push and drain paths.);
3. every ``SITES`` entry appears in ``tests/test_torch_faults.py`` — the
   all-sites sweep there is the runtime counterpart of this rule, and
   :func:`site_inventory` is the API it imports so the two can never
   drift apart.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from .core import Finding, Project, Rule, first_str_literal

__all__ = ["FaultSiteRegistryRule", "site_inventory", "registered_sites"]

_FAULTS_MODULE = "reservoir_tpu_torch/utils/faults.py"
_TESTS_FILE = "tests/test_torch_faults.py"


def registered_sites(project: Project) -> Tuple[Dict[str, int], Optional[str]]:
    """``({site: defining line}, error)`` parsed from the ``SITES``
    assignment in ``utils/faults.py``."""
    src = project.source(_FAULTS_MODULE)
    if src is None or src.tree is None:
        return {}, f"{_FAULTS_MODULE} missing or unparseable"
    for node in ast.walk(src.tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "SITES"
                   for t in targets):
            continue
        value = node.value
        if isinstance(value, (ast.Tuple, ast.List)):
            sites: Dict[str, int] = {}
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    sites[elt.value] = elt.lineno
            return sites, None
    return {}, f"no SITES tuple found in {_FAULTS_MODULE}"


def _fire_site_literal(node: ast.Call) -> Optional[Tuple[str, int, int]]:
    """The site literal of a ``*.fire(...)`` / ``fire(...)`` call."""
    fn = node.func
    is_fire = (isinstance(fn, ast.Attribute) and fn.attr == "fire") or (
        isinstance(fn, ast.Name) and fn.id == "fire")
    if not is_fire:
        return None
    for kw in node.keywords:
        if kw.arg == "site":
            return first_str_literal(kw.value)
    if node.args:
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, arg.lineno, arg.col_offset
    return None


def _rule_site_literal(node: ast.Call) -> Optional[Tuple[str, int, int]]:
    """The site literal of a ``FaultRule(...)`` construction."""
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name != "FaultRule":
        return None
    for kw in node.keywords:
        if kw.arg == "site":
            return first_str_literal(kw.value)
    if node.args:
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, arg.lineno, arg.col_offset
    return None


def site_inventory(project_or_root=None) -> Dict[str, List[Tuple[str, int]]]:
    """``{site: [(relpath, line), ...]}`` of every production ``fire()``
    call site, keyed by registered site name (sites with no call site map
    to an empty list).  This is the API ``tests/test_torch_faults.py`` imports
    for its all-sites sweep cross-check — the sweep and the linter read
    the same inventory, so neither can drift against ``faults.SITES``.

    Accepts a :class:`Project`, a root path, or ``None`` (repo root)."""
    from .core import default_root

    if isinstance(project_or_root, Project):
        project = project_or_root
    else:
        project = Project.load(project_or_root or default_root())
    sites, _err = registered_sites(project)
    inventory: Dict[str, List[Tuple[str, int]]] = {s: [] for s in sites}
    for src in project.iter_sources("reservoir_tpu_torch/"):
        if src.tree is None or src.relpath == _FAULTS_MODULE:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            lit = _fire_site_literal(node)
            if lit is not None and lit[0] in inventory:
                inventory[lit[0]].append((src.relpath, lit[1]))
    return inventory


class FaultSiteRegistryRule(Rule):
    id = "fault-site-registry"
    doc = (
        "every fire()/FaultRule site literal must be in faults.SITES; "
        "every SITES entry needs a production call site and coverage in "
        "tests/test_torch_faults.py"
    )
    hint = (
        "add the site to faults.SITES (with a docstring note naming the "
        "failure domain), wire faults.fire(site) into the hot path, and "
        "extend the all-sites sweep in tests/test_torch_faults.py"
    )

    def check(self, project: Project) -> Iterable[Finding]:
        sites, err = registered_sites(project)
        src = project.source(_FAULTS_MODULE)
        if err is not None:
            if src is not None:
                yield Finding(self.id, _FAULTS_MODULE, 1, 0, err,
                              hint=self.hint)
            return

        # 1. unknown site literals at call/rule sites
        inventory: Dict[str, List[Tuple[str, int]]] = {s: [] for s in sites}
        for fsrc in project.iter_sources("reservoir_tpu_torch/"):
            if fsrc.tree is None or fsrc.relpath == _FAULTS_MODULE:
                continue
            for node in ast.walk(fsrc.tree):
                if not isinstance(node, ast.Call):
                    continue
                lit = _fire_site_literal(node) or _rule_site_literal(node)
                if lit is None:
                    continue
                site, line, col = lit
                if site not in sites:
                    yield Finding(
                        self.id, fsrc.relpath, line, col,
                        f"site {site!r} is not in faults.SITES — the rule "
                        "can never fire (unknown names are legal at "
                        "runtime, so this fails silently)",
                        hint=self.hint,
                    )
                elif _fire_site_literal(node) is not None:
                    inventory[site].append((fsrc.relpath, line))

        # 2. dead registry entries (no production call site)
        for site, line in sites.items():
            if not inventory.get(site):
                yield Finding(
                    self.id, _FAULTS_MODULE, line, 0,
                    f"SITES entry {site!r} has no production fire() call "
                    "site — the registry advertises coverage that does "
                    "not exist",
                    hint=self.hint,
                )

        # 3. every entry exercised by the fault-matrix tests
        tests = project.read_text(_TESTS_FILE)
        if tests is not None:
            for site, line in sites.items():
                if f'"{site}"' not in tests and f"'{site}'" not in tests:
                    yield Finding(
                        self.id, _FAULTS_MODULE, line, 0,
                        f"SITES entry {site!r} never appears in "
                        f"{_TESTS_FILE} — the all-sites sweep cannot be "
                        "covering it",
                        hint=self.hint,
                    )
