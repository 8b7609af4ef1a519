"""The autotune store: the JAX package's JSON cache of tuned settings.

The port's copy of the store half of the JAX package's
``ops/autotune.py``: one JSON file of entries keyed by strings whose first
``|``-separated field names the entry's kind, written atomically (temp
file and rename) and read through an mtime memo.  The serving plane keeps
its tuned knobs here (``serve|...`` entries,
:mod:`reservoir_tpu_torch.serve.autotune`); the kernel-geometry kinds
(``algl``, ``weighted``, ``distinct``, ``gate``) are kept as the file
holds them, so a file one package wrote loads in the other.

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
from typing import Optional

__all__ = [
    "KERNELS",
    "ENTRY_KINDS",
    "cache_path",
    "load",
    "lookup_raw",
    "record_raw",
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


def cache_path() -> str:
    return os.environ.get("RESERVOIR_ALGL_AUTOTUNE_CACHE", _DEFAULT_CACHE)


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
