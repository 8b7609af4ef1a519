"""Numerics rule: the device path's transcendentals go through one module.

``bitexact-no-numpy-transcendentals`` is the port's form of the JAX
package's rule of the same id.  The kernels compute ``log``, ``exp`` and
``log1p`` with ``csrc/fmath.cuh``, a transcription of XLA's CPU recipes,
and their plain versions with :mod:`reservoir_tpu_torch.ops.fmath`, which
rounds as those recipes do, one IEEE operation at a time.  numpy's and
torch's own ``log``/``exp``/``log1p``/``expm1``/``pow`` differ from them in
the final ulps, and one ulp is enough to flip an Algorithm-L skip floor and
fork the counter-based random stream: a plain version would then no longer
be the kernel's bit-for-bit reference.  So the device-path modules
(``ops/``, ``stream/gate.py``) call neither numpy's nor torch's, in any
spelling: ``np.log``, ``from numpy import exp``, ``torch.log``,
``torch.special.expm1``, ``torch.Tensor.log(x)`` or the method forms
``x.log()``, ``x.exp_()``, ``x.pow(y)``; nor do they define a ``log``,
``exp``, ``log1p``, ``expm1``, ``pow`` or ``power`` of their own.
``ops/fmath.py`` is the one module that owns them; the host-only geometry
and cache modules
(``ops/autotune.py``, ``ops/blocking.py``) do no random-adjacent math and are
allowlisted by path.

The reference's second numerics rule, ``no-wallclock-in-traced``, guards the
bodies of ``jax.jit``, ``pl.pallas_call`` and ``shard_map``, which bake a
wall-clock or host-RNG read in at trace time.  The port traces nothing (its
torch code runs eagerly and its kernels are CUDA C++), so it has no such
rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set

from .core import Finding, Project, Rule, dotted

__all__ = ["BitexactRule", "DEVICE_PATH_PREFIXES", "DEVICE_PATH_FILES", "HOST_ALLOWLIST"]

#: Device-path scope: every module here feeds bits that must reconcile
#: with the kernels' math.
DEVICE_PATH_PREFIXES = ("reservoir_tpu_torch/ops/",)
DEVICE_PATH_FILES = ("reservoir_tpu_torch/stream/gate.py",)

#: Modules inside the scope that may call them: ``ops/fmath.py``, which owns
#: the device path's transcendentals, and the host-side geometry and cache
#: modules.
HOST_ALLOWLIST = (
    "reservoir_tpu_torch/ops/fmath.py",
    "reservoir_tpu_torch/ops/autotune.py",
    "reservoir_tpu_torch/ops/blocking.py",
)

_NUMPY = ("log", "exp", "log1p", "expm1", "power")
_TORCH = ("log", "exp", "log1p", "expm1", "pow")
#: tensor methods, in-place forms included
_METHODS = _TORCH + tuple(n + "_" for n in _TORCH)


def _module_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> imported module for every ``import x [as y]`` and
    ``from x import y [as z]`` binding in the file."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            # a relative import (``from . import fmath``) keeps its dots
            base = "." * node.level + (node.module or "")
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}" if node.module else base + a.name
    return out


def _root(node: ast.AST) -> Optional[str]:
    """The name at the root of an attribute chain, else ``None``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class BitexactRule(Rule):
    id = "bitexact-no-numpy-transcendentals"
    doc = (
        "numpy log/exp/log1p/expm1/power and torch log/exp/log1p/expm1/pow "
        "(Tensor methods included), and recipes of their own, are forbidden "
        "in device-path modules (ops/, stream/gate.py) but ops/fmath.py: a "
        "one-ulp difference from the kernels' fmath forks the Threefry skip "
        "chain"
    )
    hint = (
        "compute the transcendental with reservoir_tpu_torch.ops.fmath "
        "(the plain twin of csrc/fmath.cuh): numpy's and torch's own differ "
        "from the kernels' in the final ulps, and one ulp flips the "
        "Algorithm-L skip floor and forks the counter-based RNG stream; "
        "host-only modules belong on the HOST_ALLOWLIST"
    )

    def _in_scope(self, relpath: str) -> bool:
        if relpath in HOST_ALLOWLIST:
            return False
        if relpath in DEVICE_PATH_FILES:
            return True
        return any(relpath.startswith(p) for p in DEVICE_PATH_PREFIXES)

    def check(self, project: Project) -> Iterable[Finding]:
        for src in project.sources:
            if src.tree is None or not self._in_scope(src.relpath):
                continue
            aliases = _module_aliases(src.tree)
            numpy_names: Set[str] = {n for n, m in aliases.items() if m == "numpy"}
            torch_names: Set[str] = {n for n, m in aliases.items() if m == "torch" or m.startswith("torch.")}
            # `from numpy import log` / `from torch import exp`: direct functions
            direct = {n: m for n, m in aliases.items()
                      if (m.startswith("numpy.") and m.split(".")[-1] in _NUMPY)
                      or (m.startswith("torch.") and m.split(".")[-1] in _TORCH)}
            for node in src.tree.body:
                # a second owner: a recipe of its own beside fmath's
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name in _NUMPY + _TORCH:
                    yield Finding(
                        self.id, src.relpath, node.lineno, node.col_offset,
                        f"device-path module {src.relpath} defines its own {node.name}()",
                        hint=self.hint,
                    )
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = self._banned(node.func, aliases, numpy_names, torch_names, direct)
                if name is not None:
                    yield Finding(
                        self.id, src.relpath, node.lineno, node.col_offset,
                        f"{name} in device-path module {src.relpath}",
                        hint=self.hint,
                    )

    @staticmethod
    def _banned(fn: ast.AST, aliases: Dict[str, str], numpy_names: Set[str],
                torch_names: Set[str], direct: Dict[str, str]) -> Optional[str]:
        if isinstance(fn, ast.Name):
            return direct.get(fn.id)
        if not isinstance(fn, ast.Attribute):
            return None
        root = _root(fn.value)
        if root in numpy_names:
            return f"{root}.{fn.attr}" if fn.attr in _NUMPY else None
        if root in torch_names:
            # torch.log, torch.special.expm1, torch.Tensor.log(x)
            return dotted(fn) if fn.attr in _METHODS else None
        if root in aliases:
            return None  # another module's function (math.log, logging.log)
        # a method of a tensor (or of any value): x.log(), (a * b).pow(2)
        return f"Tensor.{fn.attr}" if fn.attr in _METHODS else None
