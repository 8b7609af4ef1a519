"""Engine checkpoints in the JAX package's ``.npz`` format (uniform and
weighted modes).

A checkpoint holds the state arrays and a JSON manifest, byte-compatible
with ``reservoir_tpu/utils/checkpoint.py`` format version 1: the same
``state_class``/``fields`` manifest (``ReservoirState`` with ``samples,
count, nxt, log_w, key``; ``WeightedState`` with ``samples, lkeys, count,
xw, key``), the key stored as its uint32 words in
a ``prng_key`` field with its impl name, and the same ``engine`` block
(config, lifecycle, fill lower bound).  A checkpoint written by either
package restores in the other and continues bit-identically, because every
draw is keyed on the absolute stream index.

Writes are atomic (temp file, fsync, rename).  A truncated or corrupt file
raises :class:`~reservoir_tpu_torch.errors.CheckpointCorrupt`; a checkpoint
of a mode this port does not run raises
:class:`~reservoir_tpu_torch.errors.CheckpointMismatch`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import SamplerConfig
from ..convert import state_from_numpy, state_to_numpy, weighted_state_from_numpy
from ..errors import CheckpointCorrupt, CheckpointMismatch

__all__ = ["save_engine", "load_engine"]

_FORMAT_VERSION = 1
_KEY_IMPL = "threefry2x32"
#: state class -> (its fields in order, the converter from numpy)
_STATES = {
    "ReservoirState": (("samples", "count", "nxt", "log_w", "key"), state_from_numpy),
    "WeightedState": (("samples", "lkeys", "count", "xw", "key"), weighted_state_from_numpy),
}


def _atomic_write_npz(path: str, arrays: dict, manifest: dict) -> None:
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
                **arrays,
            )
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_npz(path: str) -> Tuple[dict, dict]:
    try:
        with np.load(path) as data:
            if "__manifest__" not in data.files:
                raise CheckpointCorrupt(f"{path!r} has no checkpoint manifest")
            manifest = json.loads(bytes(data["__manifest__"]).decode())
            arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, KeyError, ValueError) as e:
        if isinstance(e, CheckpointCorrupt):
            raise
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is truncated or corrupt ({type(e).__name__}: {e})"
        ) from e
    version = manifest.get("format_version")
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format version {version!r}; this build "
            f"reads version {_FORMAT_VERSION}"
        )
    return arrays, manifest


def _config_to_jsonable(config: SamplerConfig) -> dict:
    d = dataclasses.asdict(config)
    for key, value in d.items():
        if key.endswith("_dtype") and value is not None:
            d[key] = value if value == "wide" else np.dtype(value).name
    return d


def save_engine(path: str, engine, metadata: Optional[dict] = None) -> None:
    """Checkpoint a live engine: state, config and lifecycle."""
    engine._check_open()
    state_class = type(engine._state).__name__
    names = _STATES[state_class][0]
    host = state_to_numpy(engine._state)
    arrays = {name: host[name] for name in names}
    fields = [{"name": name, "kind": "array"} for name in names[:-1]]
    fields.append({"name": "key", "kind": "prng_key", "impl": _KEY_IMPL})
    dev = engine.device
    manifest = {
        "state_class": state_class,
        "fields": fields,
        "format_version": _FORMAT_VERSION,
        "metadata": metadata or {},
        "engine": {
            "config": _config_to_jsonable(engine.config),
            "reusable": engine._reusable,
            "min_count": engine._min_count,
            "has_map_fn": False,
            "has_hash_fn": False,
            "backend": {
                "platform": dev.type,
                "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            },
        },
    }
    _atomic_write_npz(path, arrays, manifest)


def load_engine(path: str, engine_cls: Optional[type] = None, *, device: Any = None):
    """Rebuild a checkpointed uniform or weighted engine on ``device``."""
    from ..engine import ReservoirEngine

    arrays, manifest = _read_npz(path)
    info = manifest.get("engine")
    if info is None:
        raise ValueError(f"{path!r} is a bare state checkpoint, not an engine checkpoint")
    state_class = manifest.get("state_class")
    if state_class not in _STATES:
        raise CheckpointMismatch(
            f"checkpoint {path!r} holds a {state_class}; the torch port restores "
            f"uniform and weighted engines ({' and '.join(_STATES)}) only"
        )
    names, from_numpy = _STATES[state_class]
    if info.get("has_map_fn") or info.get("has_hash_fn"):
        raise CheckpointMismatch(
            f"checkpoint {path!r} was saved with a map_fn/hash_fn, which the "
            "torch port does not run"
        )
    kinds = {f["name"]: f for f in manifest.get("fields", ())}
    for name in names:
        if name not in kinds or name not in arrays:
            raise CheckpointCorrupt(f"checkpoint {path!r}: state field {name!r} is missing")
    if kinds["key"].get("kind") != "prng_key" or kinds["key"].get("impl") != _KEY_IMPL:
        raise CheckpointMismatch(
            f"checkpoint {path!r}: key field {kinds['key']} is not {_KEY_IMPL} key data"
        )
    config = SamplerConfig(**info["config"])
    if config.weighted != (state_class == "WeightedState"):
        raise CheckpointMismatch(
            f"checkpoint {path!r}: a {state_class} with a config of weighted={config.weighted}"
        )
    R, k = config.num_reservoirs, config.max_sample_size
    if arrays["samples"].shape != (R, k):
        raise CheckpointMismatch(
            f"checkpoint {path!r}: samples have shape {arrays['samples'].shape}, "
            f"but the recorded config has R={R}, k={k}"
        )
    state = from_numpy(*(arrays[name] for name in names), device="cpu")
    engine = (engine_cls or ReservoirEngine)(
        config, reusable=info["reusable"], device=device, _initial_state=state
    )
    engine._min_count = info["min_count"]
    return engine
