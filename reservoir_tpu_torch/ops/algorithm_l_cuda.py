"""The Algorithm-L tile update as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/algorithm_l_pallas.py:_kernel``, entry points
``update_pallas`` and ``update_steady_pallas``).  The kernel source is
``csrc/algorithm_l.cu``: one thread per reservoir row reads only the
elements it accepts and updates the state in place.  Its note says what
bounds it on an H100.

:func:`update_cuda` and :func:`update_steady_cuda` take the state and tile
on one device:

- on CUDA tensors they launch the kernel, which mutates the state's
  tensors in place and returns the same state (``count`` advanced); a
  launch error raises;
- on CPU tensors they run the plain version (:func:`update` /
  :func:`update_steady` of :mod:`.algorithm_l`), which returns a new state.

:data:`launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda_common import build_info, check_tensors
from .algorithm_l import ReservoirState, update, update_steady

__all__ = [
    "launches",
    "update_cuda",
    "update_steady_cuda",
    "fmath_cuda",
    "kernel_info",
    "update",
    "update_steady",
]

#: kernel launches so far (set it to 0 to count a run)
launches = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("algorithm_l")
        lib.algl_update.argtypes = [_VP] * 7 + [_INT] * 4 + [_VP]
        lib.algl_update.restype = _INT
        lib.algl_fmath.argtypes = [_VP, _VP, _INT, _INT, _VP]
        lib.algl_fmath.restype = _INT
        lib.algl_error_string.argtypes = [_INT]
        lib.algl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().algl_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def kernel_info() -> dict:
    """:func:`~._cuda_common.build_info` of ``algl_update``'s kernel
    (needs a card)."""
    return build_info(_library().algl_kernel_info)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _validate(state: ReservoirState, batch: torch.Tensor, valid) -> None:
    R = state.samples.shape[0]
    tensors = {
        "samples": state.samples, "count": state.count, "nxt": state.nxt,
        "log_w": state.log_w, "key": state.key, "batch": batch,
    }
    expect = {
        "count": ((R,), torch.int32), "nxt": ((R,), torch.int32),
        "log_w": ((R,), torch.float32), "key": ((R, 2), torch.int64),
    }
    if valid is not None:
        tensors["valid"] = valid
        expect["valid"] = ((R,), torch.int32)
    check_tensors("batch", tensors, expect)


def _launch(state: ReservoirState, batch: torch.Tensor, valid, fill: bool) -> ReservoirState:
    global launches
    _validate(state, batch, valid)
    if state.samples.device.type == "cpu":
        return (update if fill else update_steady)(state, batch, valid)
    if state.samples.device.type != "cuda":
        raise ValueError(f"unsupported device {state.samples.device}")
    R, k = state.samples.shape
    B = batch.shape[1]
    lib = _library()
    # the kernel reads the key as uint32 words: the low half of each int64
    key32 = state.key.to(torch.int32)
    code = lib.algl_update(
        state.samples.data_ptr(), state.count.data_ptr(), state.nxt.data_ptr(),
        state.log_w.data_ptr(), key32.data_ptr(), batch.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        R, k, B, int(fill), _stream(state.samples.device),
    )
    _raise_on(code, "algl_update launch")
    launches += 1
    return state


def update_cuda(
    state: ReservoirState, batch: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> ReservoirState:
    """Fill-capable tile update (the port of ``update_pallas``)."""
    return _launch(state, batch, valid, fill=True)


def update_steady_cuda(
    state: ReservoirState, batch: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> ReservoirState:
    """Steady tile update without the fill copy (the port of
    ``update_steady_pallas``)."""
    return _launch(state, batch, valid, fill=False)


def fmath_cuda(x: torch.Tensor, which: str) -> torch.Tensor:
    """The kernel's own ``log``, ``exp`` or ``log1p`` over a float32 CUDA
    tensor, for holding the device math against :mod:`.fmath`.  Not counted
    in :data:`launches`."""
    ops = {"log": 0, "exp": 1, "log1p": 2}
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("fmath_cuda takes a float32 CUDA tensor")
    x = x.contiguous()
    y = torch.empty_like(x)
    code = _library().algl_fmath(
        x.data_ptr(), y.data_ptr(), x.numel(), ops[which], _stream(x.device)
    )
    _raise_on(code, "algl_fmath launch")
    return y
