"""Engine checkpoints in the JAX package's ``.npz`` format (uniform,
weighted and distinct modes).

A checkpoint holds the state arrays and a JSON manifest, byte-compatible
with ``reservoir_tpu/utils/checkpoint.py`` format version 1: the same
``state_class``/``fields`` manifest (``ReservoirState`` with ``samples,
count, nxt, log_w, key``; ``WeightedState`` with ``samples, lkeys, count,
xw, key``; ``DistinctState`` with ``values, hash_hi, hash_lo, size, count,
salts, value_hi``), a key stored as its uint32 words in a ``prng_key``
field with its impl name, an absent ``value_hi`` (4-byte keys) as a field
of kind ``none``, and the same ``engine`` block (config, lifecycle, fill
lower bound).  A checkpoint written by either package restores in the
other and continues bit-identically: every draw is keyed on the absolute
stream index, and a distinct state is a function of the values seen.

Writes are atomic (temp file, fsync, rename); the writer carries the
``checkpoint.write`` fault-injection site (:mod:`.faults`).  A truncated or
corrupt file raises :class:`~reservoir_tpu_torch.errors.CheckpointCorrupt`;
a checkpoint of a mode this port does not run raises
:class:`~reservoir_tpu_torch.errors.CheckpointMismatch`.

A bare state (:func:`save_state`) has the same manifest without the
``engine`` block; a row sub-state (:func:`pack_rows`, :func:`unpack_rows`:
the payload of a row adoption's journal frame) has only its
``state_class`` and ``fields``.  A checkpoint directory's ``epoch.json``
(:func:`read_epoch`, :func:`write_epoch`, :func:`advance_epoch`) is the JAX
package's too, so an epoch advanced by either package fences the other's
bridges.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import SamplerConfig
from ..convert import (
    distinct_state_from_numpy,
    state_from_numpy,
    state_to_numpy,
    weighted_state_from_numpy,
)
from ..errors import CheckpointCorrupt, CheckpointMismatch
from ..obs import registry as _obs
from . import faults
from .tracing import trace_span

__all__ = [
    "save_state",
    "load_state",
    "pack_rows",
    "unpack_rows",
    "save_engine",
    "load_engine",
    "read_engine_metadata",
    "read_epoch",
    "write_epoch",
    "advance_epoch",
]

_FORMAT_VERSION = 1
_EPOCH_NAME = "epoch.json"
_KEY_IMPL = "threefry2x32"
#: state class -> (its fields in order, each with its manifest kind, and the
#: converter from numpy); an "optional" field is an array or absent
_STATES = {
    "ReservoirState": (
        (("samples", "array"), ("count", "array"), ("nxt", "array"), ("log_w", "array"),
         ("key", "prng_key")),
        state_from_numpy,
    ),
    "WeightedState": (
        (("samples", "array"), ("lkeys", "array"), ("count", "array"), ("xw", "array"),
         ("key", "prng_key")),
        weighted_state_from_numpy,
    ),
    "DistinctState": (
        (("values", "array"), ("hash_hi", "array"), ("hash_lo", "array"), ("size", "array"),
         ("count", "array"), ("salts", "array"), ("value_hi", "optional")),
        distinct_state_from_numpy,
    ),
}


def _state_class(config: SamplerConfig) -> str:
    if config.distinct:
        return "DistinctState"
    return "WeightedState" if config.weighted else "ReservoirState"


def _atomic_write_npz(path: str, arrays: dict, manifest: dict) -> None:
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as fh:
            # inside the temp-file guard: an injected crash mid-write leaves
            # the previous checkpoint and no temp file behind
            faults.fire("checkpoint.write")
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


def _read_npz(path: str, arrays: bool = True) -> Tuple[dict, dict]:
    """``(arrays, manifest)`` of a checkpoint (``arrays`` empty when not
    asked for)."""
    try:
        with np.load(path) as data:
            if "__manifest__" not in data.files:
                raise CheckpointCorrupt(f"{path!r} has no checkpoint manifest")
            manifest = json.loads(bytes(data["__manifest__"]).decode())
            arrays = {k: data[k] for k in data.files if k != "__manifest__"} if arrays else {}
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


def _pack_state(state, metadata: Optional[dict]) -> Tuple[dict, dict]:
    """A state's arrays and its manifest (without the ``engine`` block)."""
    state_class = type(state).__name__
    if state_class not in _STATES:
        raise TypeError(f"expected one of {', '.join(_STATES)}, got {state_class}")
    host = state_to_numpy(state)
    arrays, fields = {}, []
    for name, kind in _STATES[state_class][0]:
        if host[name] is None:
            fields.append({"name": name, "kind": "none"})
            continue
        arrays[name] = host[name]
        if kind == "prng_key":
            fields.append({"name": name, "kind": "prng_key", "impl": _KEY_IMPL})
        else:
            fields.append({"name": name, "kind": "array"})
    manifest = {
        "state_class": state_class,
        "fields": fields,
        "format_version": _FORMAT_VERSION,
        "metadata": metadata or {},
    }
    return arrays, manifest


def _unpack_state(path: str, arrays: dict, manifest: dict, device: Any = "cpu"):
    """The state a checkpoint's arrays and manifest describe, on ``device``."""
    state_class = manifest.get("state_class")
    if state_class not in _STATES:
        raise CheckpointMismatch(
            f"checkpoint {path!r} holds a {state_class}; the torch port restores "
            f"{', '.join(_STATES)} only"
        )
    specs, from_numpy = _STATES[state_class]
    kinds = {f["name"]: f for f in manifest.get("fields", ())}
    values = []
    for name, kind in specs:
        field = kinds.get(name)
        if field is not None and field.get("kind") == "none" and kind == "optional":
            values.append(None)
            continue
        if field is None or name not in arrays:
            raise CheckpointCorrupt(f"checkpoint {path!r}: state field {name!r} is missing")
        if kind == "prng_key" and (field.get("kind") != "prng_key" or field.get("impl") != _KEY_IMPL):
            raise CheckpointMismatch(
                f"checkpoint {path!r}: key field {field} is not {_KEY_IMPL} key data"
            )
        values.append(arrays[name])
    return from_numpy(*values, device=device)


def pack_rows(state) -> Tuple[dict, dict]:
    """A row sub-state's arrays and manifest in the form of the JAX
    package's bare ``_pack_state`` (``state_class`` and ``fields`` only):
    what a row adoption's journal frame carries."""
    arrays, manifest = _pack_state(state, None)
    return arrays, {"state_class": manifest["state_class"], "fields": manifest["fields"]}


def unpack_rows(arrays: dict, manifest: dict, device: Any = "cpu"):
    """The sub-state :func:`pack_rows` (or the JAX package's packer)
    described, on ``device``."""
    return _unpack_state("a packed row sub-state", arrays, manifest, device)


def save_state(path: str, state, metadata: Optional[dict] = None) -> None:
    """Write one state (``ReservoirState``, ``WeightedState`` or
    ``DistinctState``) to ``path`` atomically, in the JAX package's bare
    state format; ``metadata`` (JSON-able) comes back from
    :func:`load_state`."""
    arrays, manifest = _pack_state(state, metadata)
    _atomic_write_npz(path, arrays, manifest)


def load_state(path: str, with_metadata: bool = False, *, device: Any = "cpu"):
    """The state saved by :func:`save_state` (by either package) on
    ``device``; with ``with_metadata``, ``(state, metadata)``."""
    arrays, manifest = _read_npz(path)
    state = _unpack_state(path, arrays, manifest, device)
    return (state, manifest.get("metadata", {})) if with_metadata else state


def read_engine_metadata(path: str) -> dict:
    """The ``metadata`` a checkpoint was saved with, without restoring its
    state."""
    return _read_npz(path, arrays=False)[1].get("metadata", {})


def read_epoch(directory: str) -> int:
    """The primary epoch persisted in a checkpoint directory (0 when none
    was ever written).  A writer admitted at epoch E refuses durable writes
    once the persisted epoch exceeds E
    (:class:`~reservoir_tpu_torch.errors.FencedError`)."""
    try:
        with open(os.path.join(directory, _EPOCH_NAME), encoding="utf-8") as fh:
            return int(json.load(fh)["epoch"])
    except FileNotFoundError:
        return 0
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorrupt(
            f"epoch file in {directory!r} is unreadable ({type(e).__name__}: {e})"
        ) from e


def write_epoch(directory: str, epoch: int) -> int:
    """Persist ``epoch`` atomically (temp file and rename, the file and the
    directory fsynced: an epoch bump lost in an OS crash would un-fence the
    old primary)."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.epoch")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump({"epoch": int(epoch)}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(directory, _EPOCH_NAME))
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return int(epoch)


def advance_epoch(directory: str) -> int:
    """Bump and persist the primary epoch; returns the new value.  Every
    writer admitted at an older epoch (of either package) fails its next
    durable write with ``FencedError``."""
    return write_epoch(directory, read_epoch(directory) + 1)


def save_engine(path: str, engine, metadata: Optional[dict] = None) -> None:
    """Checkpoint a live engine: state, config and lifecycle.  ``map_fn``
    and ``hash_fn`` are code, not data: they are recorded only as present
    or absent, and must be passed again to :func:`load_engine`."""
    engine._check_open()
    arrays, manifest = _pack_state(engine._state, metadata)
    # the backend a restore's pre-flight names: a meshed engine's ranks
    if engine.mesh is not None:
        dev, count = engine.mesh.devices[0], engine.mesh.size
    else:
        dev = engine.device
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
    manifest.update({
        "engine": {
            "config": _config_to_jsonable(engine.config),
            "reusable": engine._reusable,
            "min_count": engine._min_count,
            "has_map_fn": engine._map_fn is not None,
            "has_hash_fn": engine._hash_fn is not None,
            "backend": {
                "platform": dev.type,
                "device_count": count,
            },
        },
    })
    reg = _obs.get()
    t0 = time.perf_counter() if reg is not None else 0.0
    with trace_span("reservoir_checkpoint_write"):
        _atomic_write_npz(path, arrays, manifest)
    if reg is not None:
        reg.histogram("checkpoint.write_s").observe(time.perf_counter() - t0)


#: state fields whose second dimension is the sample capacity ``k``
_K_FIELDS = frozenset({"samples", "values", "lkeys", "hash_hi", "hash_lo"})


def _preflight(path: str, config: SamplerConfig, arrays: dict, manifest: dict, mesh) -> None:
    """The reference's recovery pre-flight: refuse a restore whose state
    arrays cannot match the recorded config, naming the field, and a
    meshed restore whose rows do not divide over the ranks of the mesh it
    restores onto (the port's counterpart of the live backend's device
    count), naming the backend the checkpoint was taken on."""
    R = config.num_reservoirs
    for field in manifest.get("fields", ()):
        if field.get("kind") == "none":
            continue
        name = field["name"]
        arr = arrays.get(name)
        if arr is None:
            raise CheckpointCorrupt(
                f"checkpoint {path!r}: state field {name!r} listed in the "
                "manifest is missing from the archive"
            )
        if arr.ndim < 1 or arr.shape[0] != R:
            raise CheckpointMismatch(
                f"checkpoint {path!r}: state field {name!r} has leading "
                f"dimension {arr.shape[0] if arr.ndim else '<scalar>'}, but "
                f"the recorded config has num_reservoirs={R}"
            )
        if name in _K_FIELDS and arr.ndim >= 2 and arr.shape[1] != config.max_sample_size:
            raise CheckpointMismatch(
                f"checkpoint {path!r}: state field {name!r} has sample "
                f"capacity {arr.shape[1]}, but the recorded config has "
                f"max_sample_size={config.max_sample_size}"
            )
    if config.mesh_axis is not None and mesh is not None:
        live = mesh.shape[config.mesh_axis]
        if R % live:
            saved = (manifest.get("engine") or {}).get("backend") or {}
            was = (
                f"; it was taken on {saved['device_count']} "
                f"{saved.get('platform', '?')} device(s)"
                if saved.get("device_count")
                else ""
            )
            raise CheckpointMismatch(
                f"checkpoint {path!r} shards {R} reservoirs over mesh axis "
                f"{config.mesh_axis!r}, which does not divide evenly over "
                f"the {live} device(s) of the live backend{was}"
            )


def load_engine(path: str, engine_cls: Optional[type] = None, *, device: Any = None,
                mesh: Any = None, with_metadata: bool = False, map_fn: Any = None,
                hash_fn: Any = None):
    """Rebuild a checkpointed uniform, weighted or distinct engine on
    ``device``, or, for a config with ``mesh_axis``, re-sharded over
    ``mesh`` (default: every visible card); with ``with_metadata``,
    ``(engine, metadata)`` (the stream bridge's recovery reads its journal
    watermark there).  Raises the reference's ``ValueError`` when the
    checkpoint was saved with a ``map_fn`` or ``hash_fn`` and none is
    passed, or the other way round: a silent mismatch would change what is
    stored; and its pre-flight's ``CheckpointMismatch`` when the rows do
    not divide over the mesh."""
    from ..engine import ReservoirEngine

    arrays, manifest = _read_npz(path)
    info = manifest.get("engine")
    if info is None:
        raise ValueError(f"{path!r} is a bare state checkpoint, not an engine checkpoint")
    state_class = manifest.get("state_class")
    if state_class not in _STATES:
        raise CheckpointMismatch(
            f"checkpoint {path!r} holds a {state_class}; the torch port restores "
            f"{', '.join(_STATES)} engines only"
        )
    for flag, fn, name in (("has_map_fn", map_fn, "map_fn"), ("has_hash_fn", hash_fn, "hash_fn")):
        if bool(info.get(flag)) != (fn is not None):
            raise ValueError(
                f"checkpoint was saved with {name} "
                f"{'present' if info.get(flag) else 'absent'}; restore must match"
            )
    config = SamplerConfig(**info["config"])
    if _state_class(config) != state_class:
        raise CheckpointMismatch(
            f"checkpoint {path!r}: a {state_class} with a config of weighted="
            f"{config.weighted}, distinct={config.distinct}"
        )
    if config.mesh_axis is not None and device is None and mesh is None:
        from ..parallel.sharded import make_mesh

        mesh = make_mesh(axis=config.mesh_axis)
    if mesh is not None and mesh.multiprocess:
        from ..parallel.sharded import not_ported

        raise not_ported("restoring a checkpoint onto the ranks")
    _preflight(path, config, arrays, manifest, mesh)
    state = _unpack_state(path, arrays, manifest)
    engine = (engine_cls or ReservoirEngine)(
        config, reusable=info["reusable"], device=device, mesh=mesh, map_fn=map_fn,
        hash_fn=hash_fn, _initial_state=state,
    )
    engine._min_count = info["min_count"]
    return (engine, manifest.get("metadata", {})) if with_metadata else engine
