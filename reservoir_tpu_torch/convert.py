"""Reservoir state to and from numpy, in the JAX package's field layout.

The layout is that of the JAX package's states and of its checkpoints:
``ReservoirState`` has ``samples [R, k]``, ``count``/``nxt [R]`` int32 and
``log_w [R]`` float32; ``WeightedState`` has ``samples [R, k]``,
``lkeys [R, k]`` float32, ``count [R]`` int32 and ``xw [R]`` float32; both
hold the keys as ``[R, 2]`` uint32 words (what ``jax.random.key_data``
returns).  Two packages given the same arrays start from the same state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ops.algorithm_l import SAMPLE_DTYPES, ReservoirState
from .ops.weighted import WeightedState

__all__ = [
    "resolve_device",
    "state_from_numpy",
    "state_to_numpy",
    "weighted_state_from_numpy",
    "weighted_state_to_numpy",
]


def resolve_device(device: Optional[object] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  A CUDA
    device without a card raises: the port never carries on on the CPU
    unless it is asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch version on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _samples_and_keys(samples, key_words):
    samples = np.ascontiguousarray(samples)
    key_words = np.asarray(key_words)
    if samples.ndim != 2:
        raise ValueError(f"samples must be [R, k], got shape {samples.shape}")
    R = samples.shape[0]
    if key_words.shape != (R, 2) or key_words.dtype != np.uint32:
        raise ValueError(f"key words must be uint32 [{R}, 2], got {key_words.dtype} {key_words.shape}")
    out = torch.from_numpy(samples.copy())
    if out.dtype not in SAMPLE_DTYPES:
        raise ValueError(f"samples dtype must be one of {SAMPLE_DTYPES}, got {out.dtype}")
    return out, torch.from_numpy(key_words.astype(np.int64))


def _check_shapes(state, shapes: Dict[str, tuple]) -> None:
    for name, shape in shapes.items():
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(getattr(state, name).shape)}")


def state_from_numpy(
    samples, count, nxt, log_w, key_words, device: Optional[object] = None
) -> ReservoirState:
    """A :class:`ReservoirState` on ``device`` from numpy arrays."""
    dev = resolve_device(device)
    samples_t, key_t = _samples_and_keys(samples, key_words)
    R = samples_t.shape[0]
    out = ReservoirState(
        samples=samples_t,
        count=torch.from_numpy(np.array(count, np.int32)),
        nxt=torch.from_numpy(np.array(nxt, np.int32)),
        log_w=torch.from_numpy(np.array(log_w, np.float32)),
        key=key_t,
    )
    _check_shapes(out, {"count": (R,), "nxt": (R,), "log_w": (R,)})
    return ReservoirState(*(t.to(dev) for t in out))


def weighted_state_from_numpy(
    samples, lkeys, count, xw, key_words, device: Optional[object] = None
) -> WeightedState:
    """A :class:`WeightedState` on ``device`` from numpy arrays."""
    dev = resolve_device(device)
    samples_t, key_t = _samples_and_keys(samples, key_words)
    R, k = samples_t.shape
    out = WeightedState(
        samples=samples_t,
        lkeys=torch.from_numpy(np.array(lkeys, np.float32)),
        count=torch.from_numpy(np.array(count, np.int32)),
        xw=torch.from_numpy(np.array(xw, np.float32)),
        key=key_t,
    )
    _check_shapes(out, {"lkeys": (R, k), "count": (R,), "xw": (R,)})
    return WeightedState(*(t.to(dev) for t in out))


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A state's fields (either class) as host numpy arrays; ``key`` as
    uint32 words."""
    host = {name: t.detach().cpu().numpy() for name, t in zip(state._fields, state)}
    host["key"] = host["key"].astype(np.uint32)
    return host


def weighted_state_to_numpy(state: WeightedState) -> Dict[str, np.ndarray]:
    """A :class:`WeightedState`'s fields as host numpy arrays (``samples``,
    ``lkeys``, ``count``, ``xw``, ``key`` as uint32 words)."""
    if not isinstance(state, WeightedState):
        raise TypeError(f"expected a WeightedState, got {type(state).__name__}")
    return state_to_numpy(state)
