"""What every cell's run shares: finding a cell's files by name, the seeded
inputs' keys, the measured window with its spans and profiler, the checks
that decide ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under this directory, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the deployment's sizes and its ``mode``;
- ``modes/<mode>.py``: how a mode's engine is built and fed, and its plain
  reference (``reference/``);
- ``traffic/<traffic>.json``: the mix's parameters, and the ``loop`` that
  reads them (``loops/<loop>.py``);
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  each, ``value(run) -> float | None``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

from .timeline import PREFIX, Timeline, load_chrome_trace

__all__ = ["HERE", "REPO", "WORK", "FORBIDDEN", "Cell", "Check", "Context", "Outcome", "Window",
           "forbidden_modules", "load_module", "load_cell", "no_span", "share", "tile_order", "words_off"]

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: the run's own files (the traced window's trace), inside the checkout
WORK = REPO / ".cardbench"
#: top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "reservoir_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are in :data:`FORBIDDEN`,
    compared whole (``reservoir_tpu_torch`` is not ``reservoir_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


_MODULES: Dict[str, ModuleType] = {}


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under this directory, loaded by its path (a
    metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    key = f"{kind}/{name}"
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(f"cardbench._{kind}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[key] = module
    return _MODULES[key]


def _load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str) -> Cell:
    """The workload ``name`` of the benchmark ``bench``, its configuration
    and traffic read, and the metrics it reports."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload named {name!r}; known: {[w['name'] for w in bench['workloads']]}")
    w = entries[0]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config={**_load_json("configs", Path(config["file"]).stem), "name": w["config"]},
        traffic={**_load_json("traffic", w["traffic"]), "name": w["traffic"]},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def words_off(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """32-bit words that differ between two sets of arrays (bits, so NaN
    payloads and signed zeros count); a missing or reshaped array counts
    all its words."""
    off = 0
    for name, w in want.items():
        w = np.ascontiguousarray(w)
        g = got.get(name)
        if g is None or np.shape(g) != w.shape:
            off += w.size
            continue
        g = np.ascontiguousarray(g)
        off += int((g.view(np.uint8).reshape(w.size, -1) != w.view(np.uint8).reshape(w.size, -1)).any(1).sum())
    return off


def share(prev: Optional[Dict[str, np.ndarray]], new: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``new`` with each array equal to ``prev``'s replaced by ``prev``'s,
    so that a run keeps every answer it reads without a copy of each."""
    if prev is None:
        return new
    return {name: prev[name] if name in prev and np.array_equal(prev[name], a) else a for name, a in new.items()}


@dataclass
class Check:
    """One number compared, with its limit, and the answers it covers."""

    name: str
    value: float
    limit: float
    answers: int = 1
    wrong: int = 0

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a loop hands back: the window's raw readings (``record``), the
    work its per-layer bounds count (``work``), the checks, and the memory
    peak read before the reference ran."""

    record: Dict[str, Any]
    work: Dict[str, Any]
    checks: List[Check]
    memory_peak_bytes: int
    timeline: Optional[Timeline] = None


def no_span(name: str):
    """A span that records nothing (outside the window)."""
    return contextlib.nullcontext()


class Window:
    """The measured window: host spans around the calls into the program,
    and with ``trace`` the profiler over the whole window."""

    def __init__(self, trace: bool, device, name: str) -> None:
        self.trace = trace
        self.device = device
        self.path = WORK / f"trace-{name}.json"
        self.start = self.stop = None
        self.timeline: Optional[Timeline] = None
        self._prof = None
        self._range = None

    def span(self, name: str):
        """A span named ``name`` around a call into the program (a profiler
        range when tracing, nothing otherwise)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def __enter__(self) -> "Window":
        # the collector runs through the window, as in a user's process; what
        # set-up left (the imports, the engines, the pools) is collected once
        # and frozen, so that its passes scan what the window makes
        gc.collect()
        gc.freeze()
        if self.trace:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            if self.device.type == "cuda":  # the profiler's first device activity, outside the window
                with torch.profiler.record_function(PREFIX + "profiler_start"):
                    torch.ones(1, device=self.device).add_(1)
                    torch.cuda.synchronize(self.device)
            self._range = torch.profiler.record_function(PREFIX + "window")
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def close(self) -> None:
        """The window's end: called once the last work has completed."""
        self.stop = time.perf_counter()
        gc.unfreeze()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __exit__(self, *exc) -> None:
        if self.stop is None:
            self.close()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                WORK.mkdir(exist_ok=True)
                self._prof.export_chrome_trace(str(self.path))
                self._prof = None
                self.timeline = load_chrome_trace(str(self.path))


class Context:
    """One run's settings: the cell, the seed, the window's length, whether
    it is traced, the device, and the process's start on the host's clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
                 precision: Optional[str] = None) -> None:
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.t0 = t0
        #: ``None``: the program under test; a reference precision: the
        #: control, the reference in the program's place
        self.precision = precision

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def rng(self, *stream: int) -> np.random.Generator:
        """A host generator for one purpose (``stream``) of this seed."""
        return np.random.default_rng(np.random.SeedSequence([self.seed, *stream]))

    def key_words(self, *stream: int) -> np.ndarray:
        """``[2]`` uint32 engine key words drawn from the seed."""
        return np.random.SeedSequence([self.seed, 0x6B6579, *stream]).generate_state(2, dtype=np.uint32)

    def generator(self):
        """The card's generator for the inputs, seeded from the seed."""
        import torch

        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.SeedSequence([self.seed, 0x706F6F6C]).generate_state(1, dtype=np.uint64)[0]))
        return gen

    def window(self) -> Window:
        return Window(self.trace, self.device, self.cell.name)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            import torch

            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        """Return the program's freed memory to the card before the
        reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def tile_order(rng: np.random.Generator, pool: int, n: int) -> np.ndarray:
    """``n`` pool indices: consecutive random permutations of the pool, so
    every tile is used as often as the others."""
    blocks = -(-n // pool)
    return np.argsort(rng.random((blocks, pool)), axis=1).reshape(-1)[:n].astype(np.int64)


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (the kernel's
    record of it, to its clock tick; now when it cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        age = 0.0
    return now - max(age, 0.0)
