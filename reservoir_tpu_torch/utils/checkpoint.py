"""Engine checkpoints in the JAX package's ``.npz`` format (uniform mode).

A checkpoint holds the state arrays and a JSON manifest, byte-compatible
with ``reservoir_tpu/utils/checkpoint.py`` format version 1: the same
``state_class``/``fields`` manifest, the key stored as its uint32 words in
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
from ..convert import state_from_numpy, state_to_numpy
from ..errors import CheckpointCorrupt, CheckpointMismatch

__all__ = ["save_engine", "load_engine"]

_FORMAT_VERSION = 1
_KEY_IMPL = "threefry2x32"
_FIELDS = ("samples", "count", "nxt", "log_w", "key")


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
    host = state_to_numpy(engine._state)
    arrays = {name: host[name] for name in _FIELDS}
    fields = [{"name": name, "kind": "array"} for name in _FIELDS[:-1]]
    fields.append({"name": "key", "kind": "prng_key", "impl": _KEY_IMPL})
    dev = engine.device
    manifest = {
        "state_class": "ReservoirState",
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
    """Rebuild a checkpointed uniform-mode engine on ``device``."""
    from ..engine import ReservoirEngine

    arrays, manifest = _read_npz(path)
    info = manifest.get("engine")
    if info is None:
        raise ValueError(f"{path!r} is a bare state checkpoint, not an engine checkpoint")
    if manifest.get("state_class") != "ReservoirState":
        raise CheckpointMismatch(
            f"checkpoint {path!r} holds a {manifest.get('state_class')}; the "
            "torch port restores uniform-mode (ReservoirState) engines only"
        )
    if info.get("has_map_fn") or info.get("has_hash_fn"):
        raise CheckpointMismatch(
            f"checkpoint {path!r} was saved with a map_fn/hash_fn, which the "
            "torch port does not run"
        )
    kinds = {f["name"]: f for f in manifest.get("fields", ())}
    for name in _FIELDS:
        if name not in kinds or name not in arrays:
            raise CheckpointCorrupt(f"checkpoint {path!r}: state field {name!r} is missing")
    if kinds["key"].get("kind") != "prng_key" or kinds["key"].get("impl") != _KEY_IMPL:
        raise CheckpointMismatch(
            f"checkpoint {path!r}: key field {kinds['key']} is not {_KEY_IMPL} key data"
        )
    config = SamplerConfig(**info["config"])
    R, k = config.num_reservoirs, config.max_sample_size
    if arrays["samples"].shape != (R, k):
        raise CheckpointMismatch(
            f"checkpoint {path!r}: samples have shape {arrays['samples'].shape}, "
            f"but the recorded config has R={R}, k={k}"
        )
    state = state_from_numpy(
        arrays["samples"], arrays["count"], arrays["nxt"], arrays["log_w"],
        arrays["key"], device="cpu",
    )
    engine = (engine_cls or ReservoirEngine)(
        config, reusable=info["reusable"], device=device, _initial_state=state
    )
    engine._min_count = info["min_count"]
    return engine
