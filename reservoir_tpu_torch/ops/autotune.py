"""The autotune store: the JAX package's JSON cache of tuned settings.

The port's copy of the JAX package's ``ops/autotune.py``: one JSON file of
entries keyed by strings whose first ``|``-separated field names the
entry's kind, written atomically (temp file and rename) and read through
an mtime memo.  A file one package wrote loads in the other.

Kernel geometry (``algl``, ``weighted``, ``distinct`` and the host-side
``gate`` entries): :class:`Geometry` under :func:`make_key`'s
``kernel|device_kind|R=..|k=..|B=..|dtype`` key.  The device kind is the
card's name (``torch.cuda.get_device_name``, :func:`device_kind`) or
``"cpu"``, JAX's name for its CPU device, so a TPU's entries and an H100's
never meet.  In the port ``block_r`` is rows a CUDA block: threads for
``algl_update`` and its WIDE and gated instantiations (one thread a row),
warps for ``weighted_update`` and ``distinct_update`` (one warp a row),
checked against the kernel's choices by :mod:`.blocking`.  ``chunk_b`` and
``gather_chunk`` are read and written back untouched: the port's kernels
stream no batch chunks.  ``gate_tile`` and ``gate_push_chunk`` are the skip
gate's, as in the reference.  ``tools/block_sweep.py`` records a variant
only where it beats the default past the spread of its readings; the
engine and the bridge look entries up once a tile shape.  With no entry
(every CPU test, any untuned card or shape) a lookup returns ``None`` and
each launch keeps its default geometry; an entry can cost speed, never a
result, since every geometry gives the default's bits.

The serving plane keeps its tuned knobs here too (``serve|...`` entries,
:mod:`reservoir_tpu_torch.serve.autotune`), through :func:`lookup_raw` /
:func:`record_raw`.

Schema 3: the file is stamped ``"_schema": 3``.  A file without the stamp
(schema 1, the algl-only era) is migrated on load, each key without a known
kind read as an ``algl`` entry, and rewritten in schema 3 by the next
:func:`record_raw`.  A missing or unparseable file reads as empty: a corrupt
cache costs the tuned settings, never the caller.

The file is ``$RESERVOIR_ALGL_AUTOTUNE_CACHE`` when set, else
``TPU_ALGL_AUTOTUNE.json`` at the root of the checkout, the JAX package's
default too.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, NamedTuple, Optional

__all__ = [
    "Geometry",
    "KERNELS",
    "ENTRY_KINDS",
    "cache_path",
    "device_kind",
    "make_key",
    "load",
    "lookup",
    "lookup_raw",
    "record",
    "record_raw",
    "record_if_better",
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DEFAULT_CACHE = os.path.join(_REPO, "TPU_ALGL_AUTOTUNE.json")

_SCHEMA = 3
#: the kernel-geometry kinds of the JAX package's entries
KERNELS = ("algl", "weighted", "distinct", "gate")
#: every key prefix the store accepts
ENTRY_KINDS = KERNELS + ("serve",)

# path -> (mtime, parsed entries)
_LOAD_MEMO: dict = {}


class Geometry(NamedTuple):
    """One tuned kernel geometry (the reference's fields).

    ``block_r``: rows a block (0 = the kernel's default).
    ``chunk_b``: the reference's batch-streaming chunk (kept, unused here).
    ``gather_chunk``: the reference's one-hot gather window (kept, unused).
    ``gate_tile`` / ``gate_push_chunk``: the skip gate's candidate-tile
    width and push slice (``kernel="gate"`` entries; 0 = untuned).
    """

    block_r: int
    chunk_b: int
    gather_chunk: int
    gate_tile: int = 0
    gate_push_chunk: int = 0


def cache_path() -> str:
    return os.environ.get("RESERVOIR_ALGL_AUTOTUNE_CACHE", _DEFAULT_CACHE)


def device_kind(device: Optional[Any] = None) -> str:
    """The device name the cache keys on: ``torch.cuda.get_device_name`` of
    a CUDA device (``None`` means the card, as everywhere in the port),
    ``"cpu"`` for a CPU device or when no card is reachable.  It never
    raises: construction must not fail on a lookup."""
    import torch

    try:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            return "cpu"
        return str(torch.cuda.get_device_name(dev))
    except Exception:
        return "cpu"


def _dtype_name(dtype: Any) -> str:
    """A numpy or torch dtype (or its name) as numpy names it."""
    name = getattr(dtype, "name", None)
    if isinstance(name, str) and not hasattr(dtype, "is_floating_point"):
        return name  # a numpy dtype
    if hasattr(dtype, "is_floating_point"):  # a torch dtype
        return str(dtype).rsplit(".", 1)[-1]
    import numpy as np

    return np.dtype(dtype).name


def make_key(device_kind: str, R: int, k: int, B: int, dtype: Any, *, kernel: str = "algl") -> str:
    """The cache key of one kernel geometry: the reference's form."""
    return f"{kernel}|{device_kind}|R={R}|k={k}|B={B}|{_dtype_name(dtype)}"


def _migrate(data: dict) -> dict:
    """The entries in schema-3 key form, whatever schema the file was; the
    stamp itself is dropped."""
    if data.get("_schema") == _SCHEMA:
        return {key: v for key, v in data.items() if key != "_schema"}
    out = {}
    for key, v in data.items():
        if key == "_schema" or not isinstance(key, str):
            continue
        if key.split("|", 1)[0] in ENTRY_KINDS:
            out[key] = v
        else:
            out["algl|" + key] = v
    return out


def load(path: Optional[str] = None) -> dict:
    """The cache's entries ({} when the file is absent or unparseable)."""
    path = path or cache_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    memo = _LOAD_MEMO.get(path)
    if memo is not None and memo[0] == mtime:
        return memo[1]
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, json.JSONDecodeError):
        data = {}
    data = _migrate(data)
    _LOAD_MEMO[path] = (mtime, data)
    return data


def lookup_raw(key: str, path: Optional[str] = None) -> Optional[dict]:
    """The entry dict under ``key``, or None.  The caller owns the key's
    format and the entry's shape."""
    entry = load(path).get(key)
    return entry if isinstance(entry, dict) else None


def record_raw(key: str, entry: dict, path: Optional[str] = None) -> None:
    """Write one entry, merged into the file (atomic temp file and rename;
    a schema-1 file is migrated as it is rewritten).  The key's prefix must
    be one of :data:`ENTRY_KINDS`: any other would be read back as an
    ``algl`` key."""
    kind = key.split("|", 1)[0]
    if kind not in ENTRY_KINDS:
        raise ValueError(f"unknown entry kind {kind!r}: key prefix must be one of {ENTRY_KINDS}")
    path = path or cache_path()
    data = dict(load(path))
    data[key] = entry
    data["_schema"] = _SCHEMA
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".autotune.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _LOAD_MEMO.pop(path, None)


def lookup(device_kind: str, R: int, k: int, B: int, dtype: Any, path: Optional[str] = None, *,
           kernel: str = "algl") -> Optional[Geometry]:
    """The tuned geometry for this kernel, device and shape, or ``None``
    (the kernel's default)."""
    entry = load(path).get(make_key(device_kind, R, k, B, dtype, kernel=kernel))
    if not isinstance(entry, dict):
        return None
    try:
        return Geometry(
            block_r=int(entry["block_r"]),
            chunk_b=int(entry.get("chunk_b", 0)),
            gather_chunk=int(entry.get("gather_chunk", 0)),
            gate_tile=int(entry.get("gate_tile", 0)),
            gate_push_chunk=int(entry.get("gate_push_chunk", 0)),
        )
    except (KeyError, TypeError, ValueError):
        return None


def record(device_kind: str, R: int, k: int, B: int, dtype: Any, geometry: Geometry,
           elem_per_sec: Optional[float] = None, source: Optional[str] = None,
           path: Optional[str] = None, *, kernel: str = "algl") -> None:
    """Write one geometry entry, merged into the file; ``elem_per_sec`` and
    ``source`` ride along as provenance (:func:`record_if_better` keeps
    only winners by the rate)."""
    entry = {
        "block_r": int(geometry.block_r),
        "chunk_b": int(geometry.chunk_b),
        "gather_chunk": int(geometry.gather_chunk),
    }
    # gate fields only when set: other entries keep the reference's shape
    if geometry.gate_tile:
        entry["gate_tile"] = int(geometry.gate_tile)
    if geometry.gate_push_chunk:
        entry["gate_push_chunk"] = int(geometry.gate_push_chunk)
    if elem_per_sec is not None:
        entry["elem_per_sec"] = float(elem_per_sec)
    if source is not None:
        entry["source"] = source
    record_raw(make_key(device_kind, R, k, B, dtype, kernel=kernel), entry, path)


def record_if_better(device_kind: str, R: int, k: int, B: int, dtype: Any, geometry: Geometry,
                     elem_per_sec: float, source: Optional[str] = None,
                     path: Optional[str] = None, *, kernel: str = "algl") -> bool:
    """Record only if no entry exists or this rate beats the stored one;
    returns whether the entry was written."""
    entry = load(path).get(make_key(device_kind, R, k, B, dtype, kernel=kernel))
    if isinstance(entry, dict):
        prev = entry.get("elem_per_sec")
        if isinstance(prev, (int, float)) and prev >= elem_per_sec:
            return False
    record(device_kind, R, k, B, dtype, geometry, elem_per_sec=elem_per_sec, source=source,
           path=path, kernel=kernel)
    return True
