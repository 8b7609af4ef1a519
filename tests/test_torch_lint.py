"""reservoir-lint over the port (``reservoir_tpu_torch/analysis``).

1. The committed-tree contract: the pass over ``reservoir_tpu_torch/``
   reports zero unsuppressed findings, every waiver carries its reason,
   and taking out any one waiver, or ``ops/fmath.py``'s place on the
   allowlist, makes a finding appear.
2. For every rule, a synthetic source it must flag and a disciplined one
   it must not, the torch transcendentals included.
3. The linter runs in a fresh interpreter without importing torch, jax or
   the JAX package, and its CLI keeps the reference's exit codes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import tokenize

import pytest

from reservoir_tpu_torch.analysis import (
    all_rules,
    emitted_instrument_names,
    render_human,
    render_json,
    run_lint,
    site_inventory,
)
from reservoir_tpu_torch.analysis import rules_numerics
from reservoir_tpu_torch.analysis.core import Project
from reservoir_tpu_torch.analysis.rules_faults import FaultSiteRegistryRule
from reservoir_tpu_torch.analysis.rules_gating import ZeroOverheadGateRule
from reservoir_tpu_torch.analysis.rules_locks import GuardedByRule
from reservoir_tpu_torch.analysis.rules_names import InstrumentNameRule
from reservoir_tpu_torch.analysis.rules_numerics import BitexactRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "reservoir_tpu_torch"


def _lint(tmp_path, files, rule):
    """Write a synthetic tree and run one rule over it."""
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")
    return run_lint(root=str(tmp_path), rules=[rule])


def _ids(result):
    return sorted({f.rule for f in result.unsuppressed})


# ---------------------------------------------------- the committed tree


def test_committed_tree_has_zero_unsuppressed_findings():
    result = run_lint(root=REPO)
    assert result.unsuppressed == [], "\n" + render_human(result)
    assert result.suppressed and all(f.reason for f in result.suppressed)
    assert {r.id for r in all_rules()} == set(result.rules)
    assert all(p.startswith(PKG + "/") for p in result.checked_files)
    assert f"{PKG}/tools/reservoir_lint.py" in result.checked_files


@pytest.fixture(scope="module")
def tree_copy(tmp_path_factory):
    """The package's sources and the rules' cross-check targets, copied."""
    root = tmp_path_factory.mktemp("tree")
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("_build", "csrc", "_native", "__pycache__"))
    for rel in ("tests/test_torch_faults.py", "tools/reservoir_top.py", "BENCH.md"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), root / rel)
    return root


def _waivers():
    """Every ``reservoir-lint: disable`` comment in the package: (file, line)."""
    out = []
    for dirpath, _, names in os.walk(os.path.join(REPO, PKG)):
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    for tok in tokenize.generate_tokens(fh.readline):
                        if tok.type == tokenize.COMMENT and re.search(r"#\s*reservoir-lint:\s*disable=", tok.string):
                            out.append((os.path.relpath(path, REPO), tok.start[0]))
    return out


def test_every_waiver_is_needed(tree_copy):
    waivers = _waivers()
    assert len(waivers) >= 7
    for rel, line in waivers:
        path = tree_copy / rel
        text = path.read_text(encoding="utf-8")
        lines = text.splitlines(keepends=True)
        ids = re.search(r"disable=([A-Za-z0-9_,-]+)", lines[line - 1]).group(1).split(",")
        lines[line - 1] = re.sub(r"#\s*reservoir-lint:\s*disable=.*$", "#", lines[line - 1])
        path.write_text("".join(lines), encoding="utf-8")
        try:
            result = run_lint(root=str(tree_copy), rules=[r for r in all_rules() if r.id in ids])
        finally:
            path.write_text(text, encoding="utf-8")
        assert result.unsuppressed, f"the waiver at {rel}:{line} silences nothing"


def test_fmath_is_the_one_module_that_owns_the_transcendentals(monkeypatch):
    rule = BitexactRule()
    assert run_lint(root=REPO, rules=[rule]).unsuppressed == []
    monkeypatch.setattr(rules_numerics, "HOST_ALLOWLIST",
                        tuple(p for p in rules_numerics.HOST_ALLOWLIST if not p.endswith("fmath.py")))
    found = run_lint(root=REPO, rules=[rule]).unsuppressed
    assert found and {f.path for f in found} == {f"{PKG}/ops/fmath.py"}


def test_linter_imports_neither_torch_nor_jax_nor_the_jax_package():
    code = (
        "import sys; import reservoir_tpu_torch.tools.reservoir_lint as rl\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('torch', 'jax', 'numpy', 'reservoir_tpu')]\n"
        "assert not bad, bad\n"
        "sys.exit(rl.main(['--json']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["summary"]["findings"] == 0 and doc["version"] == 1
    assert set(doc) == {"version", "root", "files", "rules", "findings", "suppressed", "summary"}
    assert all(entry["reason"] for entry in doc["suppressed"])


def test_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    cli = [sys.executable, "-m", f"{PKG}.tools.reservoir_lint"]
    proc = subprocess.run(cli + ["--rules", "bogus"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "unknown rule" in proc.stderr
    bad = tmp_path / PKG / "ops"
    bad.mkdir(parents=True)
    bad.joinpath("k.py").write_text("import torch\n\ndef f(x):\n    return torch.log(x)\n")
    proc = subprocess.run(cli + ["--root", str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "bitexact-no-numpy-transcendentals" in proc.stdout
    proc = subprocess.run(cli + ["--list-rules"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert all(rule.id in proc.stdout for rule in all_rules())


def test_json_report_matches_the_reference_schema():
    doc = json.loads(render_json(run_lint(root=REPO)))
    assert set(doc["summary"]) == {"findings", "suppressed", "by_rule"}
    for entry in doc["suppressed"]:
        assert {"rule", "file", "line", "col", "message", "hint", "reason"} <= set(entry)


# ------------------------------------------------ rule 1: bitexact numerics


@pytest.mark.parametrize("call", [
    "np.log(x)", "np.power(x, 2)", "torch.exp(x)", "torch.log1p(x)", "torch.special.expm1(x)",
    "torch.Tensor.log(x)", "x.log()", "x.exp_()", "(x * 2).pow(3)", "exp(x)",
])
def test_bitexact_flags_transcendentals_in_the_device_path(tmp_path, call):
    result = _lint(tmp_path, {
        f"{PKG}/ops/kernel.py": f"""
            import numpy as np
            import torch
            from torch import exp

            def f(x):
                return {call}
        """,
    }, BitexactRule())
    assert _ids(result) == ["bitexact-no-numpy-transcendentals"]
    assert len(result.unsuppressed) == 1


def test_bitexact_flags_a_recipe_of_its_own(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/ops/kernel.py": "def log1p(x):\n    return x\n",
        f"{PKG}/ops/fmath.py": "def log1p(x):\n    return x\n",
    }, BitexactRule())
    assert [f.path for f in result.unsuppressed] == [f"{PKG}/ops/kernel.py"]


def test_bitexact_flags_the_gate_module(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/stream/gate.py": "import numpy\n\ndef f(x):\n    return numpy.expm1(x)\n",
    }, BitexactRule())
    assert len(result.unsuppressed) == 1


def test_bitexact_ignores_fmath_host_modules_and_other_libraries(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/ops/kernel.py": """
            import logging
            import math
            import torch
            from . import fmath

            def f(x, log):
                logging.log(10, "x")
                log.info("y")
                return fmath.log(x) + fmath.exp(x) + math.log(2.0) + torch.sqrt(x)
        """,
        f"{PKG}/ops/fmath.py": "import torch\n\ndef log(x):\n    return torch.log(x)\n",
        f"{PKG}/ops/autotune.py": "import numpy as np\n\ndef cost(x):\n    return np.log(x)\n",
        f"{PKG}/oracle/host.py": "import numpy as np\n\ndef f(x):\n    return np.log(x)\n",
    }, BitexactRule())
    assert result.unsuppressed == []


# --------------------------------------------------- rule 2: zero-overhead


_GATE_BAD = """
    from .obs import registry as _obs

    def unguarded():
        reg = _obs.get()
        reg.counter("serve.ingest_total").inc()

    def chained():
        _obs.get().counter("serve.ingest_total").inc()

    def held(plane):
        plane.fire("bridge.demux")
"""

_GATE_GOOD = """
    from .obs import registry as _obs
    from .utils import faults as _faults

    def guarded():
        reg = _obs.get()
        if reg is not None:
            reg.counter("serve.ingest_total").inc()

    def early_exit(plane):
        _faults.fire("bridge.demux", plane)
        reg = _obs.get()
        if reg is None:
            return
        reg.counter("serve.ingest_total").inc()

    def short_circuit():
        reg = _obs.get()
        return reg is not None and reg.counter("a.b").value
"""


@pytest.mark.parametrize("source,expected", [(_GATE_BAD, 3), (_GATE_GOOD, 0)], ids=["bad", "good"])
def test_gate_rule(tmp_path, source, expected):
    result = _lint(tmp_path, {f"{PKG}/hot.py": source}, ZeroOverheadGateRule())
    assert len(result.unsuppressed) == expected
    if expected:
        assert _ids(result) == ["zero-overhead-gate"]


# ----------------------------------------------- rule 3: fault site registry


_FAULTS_DEF = 'SITES = ("a.b", "c.d")\n\ndef fire(site, plane=None):\n    pass\n'


def test_fault_registry_flags_unknown_dead_and_untested_sites(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/utils/faults.py": _FAULTS_DEF,
        f"{PKG}/mod.py": """
            from .utils import faults as _faults

            def go():
                _faults.fire("a.b")
                _faults.fire("zz.unknown")
        """,
        "tests/test_torch_faults.py": 'SWEEP = ["a.b"]\n',
    }, FaultSiteRegistryRule())
    msgs = sorted(f.message for f in result.unsuppressed)
    assert len(msgs) == 3
    assert any("'zz.unknown' is not in faults.SITES" in m for m in msgs)
    assert any("no production fire() call site" in m for m in msgs)
    assert any("never appears in tests/test_torch_faults.py" in m for m in msgs)


def test_fault_registry_accepts_a_consistent_tree(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/utils/faults.py": _FAULTS_DEF,
        f"{PKG}/mod.py": """
            from .utils import faults as _faults

            def go():
                _faults.fire("a.b")
                _faults.fire("c.d")
                _faults.fire("a.b")
        """,
        "tests/test_torch_faults.py": 'SWEEP = ["a.b", "c.d"]\n',
    }, FaultSiteRegistryRule())
    assert result.unsuppressed == []
    inv = site_inventory(str(tmp_path))
    assert inv["a.b"] == [(f"{PKG}/mod.py", 5), (f"{PKG}/mod.py", 7)]


# -------------------------------------------- rule 4: instrument name drift


def test_name_rule_flags_grammar_render_and_doc_drift(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/m.py": """
            def f(reg, fast, knob):
                reg.counter("BadName").inc()
                reg.gauge("ok.metric").set(1)
                reg.histogram("x.alpha" if fast else "x.beta").observe(2)
                reg.gauge(f"dyn.{knob}").set(3)
        """,
        "tools/reservoir_top.py": 'ROWS = ["ok.metric", "ok.ghost"]\n',
        "BENCH.md": """
            ### Instrument name catalog

            `ok.metric` `x.alpha` `x.beta` `doc.stale`
        """,
    }, InstrumentNameRule())
    msgs = sorted(f.message for f in result.unsuppressed)
    assert len(msgs) == 3
    assert any("'BadName' does not match" in m for m in msgs)
    assert any("renders 'ok.ghost'" in m for m in msgs)
    assert any("catalogs 'doc.stale'" in m for m in msgs)
    names = set(emitted_instrument_names(Project.load(str(tmp_path))))
    assert {"x.alpha", "x.beta"} <= names and not any(n.startswith("dyn.") for n in names)


def test_name_rule_accepts_a_consistent_tree_and_the_port_emits_the_catalog(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/m.py": "def f(reg):\n    reg.counter('ok.metric').inc()\n",
        "tools/reservoir_top.py": 'ROWS = ["ok.metric"]\n',
        "BENCH.md": "### Instrument name catalog\n\n`ok.metric`\n",
    }, InstrumentNameRule())
    assert result.unsuppressed == []
    assert len(emitted_instrument_names(Project.load(REPO))) >= 30


# ------------------------------------------------------- rule 5: guarded-by


_BOX = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            {waiver}self._n = 0

        def bump(self):
            with self._lock:
                self._n += 1

        def peek(self):
            {body}

        def _peek_locked(self):
            return self._n
"""

_MODULE = """
    import threading
    from ._cuda_common import COUNT_LOCK

    _lock = threading.Lock()
    {waiver}{name} = {init}

    def put(k, v):
        global launches
        with _lock:
            _cache[k] = v
        with COUNT_LOCK:
            launches += 1

    def peek(k):
        {body}
"""

_WAIVER = "# reservoir-lint: disable=guarded-by -- monotonic, a GIL-atomic read\n"


@pytest.mark.parametrize("case", ["attribute", "module_global", "count_lock"])
@pytest.mark.parametrize("variant", ["racy", "locked", "waived", "out_of_scope"])
def test_guarded_by(tmp_path, case, variant):
    if case == "attribute":
        path, lock, read, indent = "obs/events.py", "self._lock", "return self._n", " " * 12
    elif case == "module_global":
        path, lock, read, indent = "native.py", "_lock", "return _cache.get(k)", " " * 4
    else:
        path, lock, read, indent = "ops/algorithm_l_cuda.py", "COUNT_LOCK", "return launches", " " * 4
    body = read if variant != "locked" else f"with {lock}:\n{indent}    {read}".replace(
        "\n" + indent, "\n" + " " * (len(indent) + 4 if case == "attribute" else 8))
    waiver = _WAIVER + indent if variant == "waived" else ""
    if case == "attribute":
        src = _BOX.format(waiver=waiver, body=body)
    else:
        # the other module global, declared without a waiver
        other = "launches = 0" if case == "module_global" else "_cache = {}"
        name, init = ("_cache", "{}") if case == "module_global" else ("launches", "0")
        src = _MODULE.format(waiver=waiver, name=name, init=init, body=body).replace(
            "_lock = threading.Lock()\n", f"_lock = threading.Lock()\n    {other}\n")
    where = f"{PKG}/{path}" if variant != "out_of_scope" else f"{PKG}/single_threaded.py"
    result = _lint(tmp_path, {where: src}, GuardedByRule())
    if variant == "racy":
        assert len(result.unsuppressed) == 1, render_human(result)
        assert "peek()" in result.unsuppressed[0].message
    else:
        assert result.unsuppressed == [], render_human(result)
    if variant == "waived":
        assert len(result.suppressed) == 1 and "GIL-atomic" in result.suppressed[0].reason


# ------------------------------------------------------------- the driver


def test_suppression_forms(tmp_path):
    result = _lint(tmp_path, {
        f"{PKG}/ops/a.py": """
            import torch

            def f(x):
                return torch.log(x)  # reservoir-lint: disable=bitexact-no-numpy-transcendentals -- a log line only
        """,
        f"{PKG}/ops/b.py": """
            import torch

            def f(x):
                # reservoir-lint: disable=bitexact-no-numpy-transcendentals -- a log line only
                return torch.log(x)
        """,
    }, BitexactRule())
    assert result.unsuppressed == [] and len(result.suppressed) == 2


@pytest.mark.parametrize("source,ids", [
    ("import torch\n\ndef f(x):\n    return torch.log(x)  # reservoir-lint: disable=bitexact-no-numpy-transcendentals\n",
     ["bitexact-no-numpy-transcendentals", "suppression-hygiene"]),
    ("X = 1  # reservoir-lint: disable=no-such-rule -- whatever\n", ["suppression-hygiene"]),
    ("def f(:\n", ["parse-error"]),
], ids=["bare", "unknown_rule", "syntax_error"])
def test_driver_findings(tmp_path, source, ids):
    assert _ids(_lint(tmp_path, {f"{PKG}/ops/kernel.py": source}, BitexactRule())) == ids
