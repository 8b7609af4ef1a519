"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file becomes a shared library with a plain C interface,
loaded with ``ctypes``; nothing links against PyTorch, so a build takes
seconds.  Libraries go to ``reservoir_tpu_torch/_build/`` under a name keyed
by a hash of every source in ``csrc/`` and of the flags, so an edited
source is rebuilt and a stale library is never loaded.  All sources are
compiled in parallel, one ``nvcc`` each.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false``.  The
kernels' float math must round exactly as the plain versions do, so no
multiply-add is contracted and ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

__all__ = ["NVCC_FLAGS", "build_all", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or the toolkit's usual
    install location; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from reservoir_tpu_torch/csrc at first use"
    )


def _sources() -> List[str]:
    return sorted(f for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> str:
    return os.path.join(_OUT, f"lib{name}-{digest}.so")


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, all at
    once; returns ``{name: library path}``."""
    digest = _digest()
    names = [f[:-3] for f in _sources() if f.endswith(".cu")]
    os.makedirs(_OUT, exist_ok=True)
    todo = {}
    for name in names:
        path = _lib_path(name, digest)
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(dir=_OUT, suffix=".so.tmp")
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            todo[name] = (proc, tmp, path)
    failures = []
    for name, (proc, tmp, path) in todo.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {name: _lib_path(name, digest) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            _loaded[name] = lib
        return lib
