"""Build the port's CUDA kernels with ``nvcc`` at first use and load them,
and build its host library with ``g++``.

Each ``csrc/*.cu`` file becomes a shared library with a plain C interface,
loaded with ``ctypes``; nothing links against PyTorch, so a build takes
seconds.  Libraries go to ``reservoir_tpu_torch/_build/`` under a name keyed
by a hash of every source in ``csrc/`` and of the flags, so an edited
source is rebuilt and a stale library is never loaded.  All sources are
compiled in parallel, one ``nvcc`` each.  The host libraries
(:func:`build_host`: ``_native/staging_buffer.cc``, and
``_native/skip_gate.cc``, which compiles ``csrc/algl_chain.cuh`` for the
CPU) follow the same rules with ``g++``, their digest keyed on the
``csrc`` headers they include as well.  Every build writes a temporary file beside its library and
renames it into place, so processes that build at once never load a half
written file, and a failed build leaves no temporary file behind.

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
from typing import Dict, List, Tuple

__all__ = ["CXX", "CXX_FLAGS", "NVCC_FLAGS", "build_all", "build_host", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

#: the host libraries' compiler, found on the ``PATH``, and its flags: no
#: ``-march=native``, since a library built on one machine may be found by
#: another that shares the checkout, and no contraction of a multiply and an
#: add, so the skip gate's chain rounds as the kernels' does
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra",
             "-ffp-contract=off")

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


def _compile(jobs: Dict[str, tuple]) -> None:
    """Run every ``{name: (command without -o, source, library path)}`` at
    once, each into a temporary file renamed onto its library on success;
    raises with the compilers' output if any failed.  No temporary file
    outlives the call."""
    os.makedirs(_OUT, exist_ok=True)
    running = {}
    failures = []
    try:
        for name, (cmd, source, path) in jobs.items():
            fd, tmp = tempfile.mkstemp(dir=_OUT, suffix=".so.tmp")
            os.close(fd)
            running[name] = (None, tmp, path)
            proc = subprocess.Popen(
                [*cmd, "-o", tmp, source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running[name] = (proc, tmp, path)
        for name, (proc, tmp, path) in running.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}:\n{out}")
            else:
                os.replace(tmp, path)
    finally:
        for proc, tmp, _ in running.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("compilation failed:\n" + "\n".join(failures))


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, all at
    once; returns ``{name: library path}``."""
    digest = _digest()
    names = [f[:-3] for f in _sources() if f.endswith(".cu")]
    todo = [name for name in names if not os.path.exists(_lib_path(name, digest))]
    if todo:
        nvcc = nvcc_path()
        _compile({
            f"{name}.cu": ([nvcc, *NVCC_FLAGS], os.path.join(_CSRC, name + ".cu"),
                           _lib_path(name, digest))
            for name in todo
        })
    return {name: _lib_path(name, digest) for name in names}


def build_host(source: str, headers: Tuple[str, ...] = ()) -> str:
    """The host library built from the C++ file ``source`` with :data:`CXX`
    and :data:`CXX_FLAGS` (built if there is no current one); returns its
    path.  ``headers`` names the ``csrc/`` headers it includes (``csrc/`` is
    then on the include path); the digest covers them too.  Raises if the
    compiler is missing or fails."""
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found on PATH; the port's host library is "
                           f"built from {os.path.relpath(source, _HERE)} at first use")
    flags = CXX_FLAGS + (("-I", _CSRC) if headers else ())
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for path in (source, *(os.path.join(_CSRC, name) for name in headers)):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    name = os.path.splitext(os.path.basename(source))[0]
    path = _lib_path(name, h.hexdigest()[:16])
    if not os.path.exists(path):
        _compile({os.path.basename(source): ([found, *flags], source, path)})
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            _loaded[name] = lib
        return lib
