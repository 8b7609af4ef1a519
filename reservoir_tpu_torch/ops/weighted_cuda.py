"""The weighted (A-ExpJ) tile update as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/weighted_pallas.py:_kernel``, entry point
``update_pallas``).  The kernel source is ``csrc/weighted.cu``: one warp per
reservoir row scans the row's weights in the blocked association of
:mod:`.prefix`, fills and accepts in place, and reads only the elements it
keeps.  Its note says what bounds it on an H100.  Unlike the Pallas kernel
it takes ``valid``, so ragged tiles run through it too.

:func:`update_cuda` takes the state, elements and weights on one device:

- on CUDA tensors it launches the kernel, which mutates the state's tensors
  in place and returns the same state (``count`` advanced); a launch error
  raises;
- on CPU tensors it runs the plain version (:func:`.weighted.update`), which
  returns a new state.

:data:`launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .algorithm_l_cuda import check_tensors
from .weighted import WeightedState, update

__all__ = ["launches", "update_cuda", "update"]

#: kernel launches so far (set it to 0 to count a run)
launches = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("weighted")
        lib.weighted_update.argtypes = [_VP] * 8 + [_INT] * 3 + [_VP]
        lib.weighted_update.restype = _INT
        lib.weighted_error_string.argtypes = [_INT]
        lib.weighted_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _validate(state: WeightedState, elems: torch.Tensor, weights: torch.Tensor, valid) -> None:
    R, k = state.samples.shape
    if elems.ndim != 2 or elems.shape[1] < 1:
        raise ValueError(f"elems must be [R={R}, B >= 1], got {tuple(elems.shape)}")
    tensors = {
        "samples": state.samples, "lkeys": state.lkeys, "count": state.count,
        "xw": state.xw, "key": state.key, "elems": elems, "weights": weights,
    }
    expect = {
        "lkeys": ((R, k), torch.float32), "count": ((R,), torch.int32),
        "xw": ((R,), torch.float32), "key": ((R, 2), torch.int64),
        "weights": ((R, elems.shape[1]), torch.float32),
    }
    if valid is not None:
        tensors["valid"] = valid
        expect["valid"] = ((R,), torch.int32)
    check_tensors("elems", tensors, expect)


def update_cuda(
    state: WeightedState,
    elems: torch.Tensor,
    weights: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> WeightedState:
    """Fill-capable weighted tile update (the port of ``update_pallas``):
    reservoir ``r`` takes ``elems[r, :valid[r]]`` with their weights."""
    global launches
    _validate(state, elems, weights, valid)
    dev = state.samples.device
    if dev.type == "cpu":
        return update(state, elems, weights, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, k = state.samples.shape
    lib = _library()
    # the kernel reads the key as uint32 words: the low half of each int64
    key32 = state.key.to(torch.int32)
    code = lib.weighted_update(
        state.samples.data_ptr(), state.lkeys.data_ptr(), state.count.data_ptr(),
        state.xw.data_ptr(), key32.data_ptr(), elems.data_ptr(), weights.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        R, k, elems.shape[1], torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        msg = lib.weighted_error_string(code).decode()
        raise RuntimeError(f"weighted_update launch failed: CUDA error {code} ({msg})")
    launches += 1
    return state
