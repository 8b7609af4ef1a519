"""Reservoir state to and from numpy, in the JAX package's field layout.

The layout is that of the JAX package's ``ReservoirState`` and of its
checkpoints: ``samples [R, k]``, ``count``/``nxt [R]`` int32,
``log_w [R]`` float32 and the keys as ``[R, 2]`` uint32 words (what
``jax.random.key_data`` returns).  Two packages given the same arrays start
from the same state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ops.algorithm_l import SAMPLE_DTYPES, ReservoirState

__all__ = ["resolve_device", "state_from_numpy", "state_to_numpy"]


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


def state_from_numpy(
    samples, count, nxt, log_w, key_words, device: Optional[object] = None
) -> ReservoirState:
    """A :class:`ReservoirState` on ``device`` from numpy arrays."""
    samples = np.ascontiguousarray(samples)
    key_words = np.asarray(key_words)
    R = samples.shape[0] if samples.ndim == 2 else -1
    if samples.ndim != 2:
        raise ValueError(f"samples must be [R, k], got shape {samples.shape}")
    if key_words.shape != (R, 2) or key_words.dtype != np.uint32:
        raise ValueError(f"key words must be uint32 [{R}, 2], got {key_words.dtype} {key_words.shape}")
    dev = resolve_device(device)
    out = ReservoirState(
        samples=torch.from_numpy(samples.copy()),
        count=torch.from_numpy(np.array(count, np.int32)),
        nxt=torch.from_numpy(np.array(nxt, np.int32)),
        log_w=torch.from_numpy(np.array(log_w, np.float32)),
        key=torch.from_numpy(key_words.astype(np.int64)),
    )
    if out.samples.dtype not in SAMPLE_DTYPES:
        raise ValueError(f"samples dtype must be one of {SAMPLE_DTYPES}, got {out.samples.dtype}")
    for name in ("count", "nxt", "log_w"):
        if tuple(getattr(out, name).shape) != (R,):
            raise ValueError(f"{name} must be [{R}], got {tuple(getattr(out, name).shape)}")
    return ReservoirState(*(t.to(dev) for t in out))


def state_to_numpy(state: ReservoirState) -> Dict[str, np.ndarray]:
    """The state's fields as host numpy arrays; ``key`` as uint32 words."""
    host = {name: t.detach().cpu().numpy() for name, t in zip(state._fields, state)}
    host["key"] = host["key"].astype(np.uint32)
    return host
