"""The distinct-mode (bottom-k) tile merge as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/distinct_pallas.py:_kernel``, entry point
``update_pallas``).  The kernel source is ``csrc/distinct.cu``: one warp per
reservoir row reads the row 128 keys at a time with 16-byte loads (the next
chunk in flight while the current one is scrambled), ballots the keys below
the row's threshold and merges them into the row's sorted block in shared
memory up to 32 at a time: a binary search a lane for the rank and an equal
entry, the new keys ranked among themselves, then one merge pass.  On an
H100 the scramble's integer operations bound a steady tile, and the
serial steps a row takes per round bound a tile from empty; its note says
how the design answers both.  Unlike the Pallas kernel it takes ``valid``,
so ragged tiles run through it too.

:func:`update_cuda` takes the state and a tile on one device.  A narrow
tile is ``[R, B]`` of the state's dtype; a wide one an int64/uint64
``[R, B]`` tensor (the kernel reads the two words of each key in place) or
an ``(hi, lo)`` pair of 32-bit ``[R, B]`` planes:

- on CUDA tensors it launches the kernel, which mutates the state's tensors
  in place and returns the same state (``count`` advanced); a launch error
  raises;
- on CPU tensors it runs the plain version (:func:`.distinct.update`), which
  returns a new state.

:data:`launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda_common import build_info, check_tensors
from .distinct import NARROW_DTYPES, WIDE_DTYPES, Batch, DistinctState, update

__all__ = ["launches", "update_cuda", "update", "MAX_SMEM", "kernel_info"]

#: kernel launches so far (set it to 0 to count a run)
launches = 0

#: shared memory a block may use on sm_90: a row's block (12 bytes an entry
#: narrow, 16 wide) must fit, so k <= 19,370 narrow and k <= 14,528 wide
MAX_SMEM = 232448

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None


def _library(path: Optional[str] = None):
    """The kernel's library, declared for ``ctypes``: the checkout's build
    of ``csrc/distinct.cu``, or with ``path`` another build with the same C
    entry points, which :func:`update_cuda` then launches until the next
    call with a path (``kernel_ab.py`` times two builds so)."""
    global _lib
    if _lib is None or path is not None:
        from .._build import load

        lib = load("distinct") if path is None else ctypes.CDLL(path)
        lib.distinct_update.argtypes = [_VP] * 9 + [_INT] + [_VP] + [_INT] * 3 + [_VP]
        lib.distinct_update.restype = _INT
        lib.distinct_error_string.argtypes = [_INT]
        lib.distinct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info(k: int, wide: bool) -> dict:
    """:func:`~._cuda_common.build_info` of the kernel a launch at
    ``k`` runs, for narrow or wide keys (needs a card)."""
    return build_info(_library().distinct_kernel_info, int(wide), k)


def _tile_words(state: DistinctState, batch: Batch):
    """``(tensors to check, lo plane, hi plane or None, stride, B)``: the
    tile as 32-bit word planes, read in place."""
    if not state.wide:
        if isinstance(batch, tuple):
            raise ValueError("a narrow state takes one [R, B] tile, not planes")
        return {"batch": batch}, batch, None, 1, batch.shape[1] if batch.ndim == 2 else -1
    if isinstance(batch, tuple):
        hi, lo = batch
        if hi.dtype not in NARROW_DTYPES or lo.dtype not in NARROW_DTYPES:
            raise ValueError("a wide tile's (hi, lo) planes must be 32-bit tensors")
        lo, hi = lo.view(torch.int32), hi.view(torch.int32)
        if hi.shape != lo.shape:
            raise ValueError(f"hi {tuple(hi.shape)} and lo {tuple(lo.shape)} planes differ in shape")
        return {"batch": lo, "hi": hi}, lo, hi, 1, lo.shape[1] if lo.ndim == 2 else -1
    if batch.dtype not in WIDE_DTYPES:
        raise ValueError(f"a wide state takes int64/uint64 tiles or (hi, lo) planes, got {batch.dtype}")
    if batch.ndim != 2:
        raise ValueError(f"batch must be [R, B], got {tuple(batch.shape)}")
    # little-endian: word 2p is the low half of key p, word 2p + 1 the high
    words = batch.view(torch.int32) if batch.is_contiguous() else batch
    return {"batch": words}, words, words, 2, batch.shape[1]


def _validate(state: DistinctState, batch: Batch, valid) -> tuple:
    R, k = state.values.shape
    tiles, lo, hi, stride, B = _tile_words(state, batch)
    if B < 1:
        raise ValueError(f"batch must be [R={R}, B >= 1], got {tuple(lo.shape)}")
    tensors = {
        "samples": state.values.view(torch.int32) if state.wide else state.values,
        "hash_hi": state.hash_hi, "hash_lo": state.hash_lo, "size": state.size,
        "count": state.count, "salts": state.salts, **tiles,
    }
    expect = {
        "hash_hi": ((R, k), torch.int32), "hash_lo": ((R, k), torch.int32),
        "size": ((R,), torch.int32), "count": ((R,), torch.int32),
        "salts": ((R, 4), torch.int32),
    }
    if state.wide:
        tensors["value_hi"] = state.value_hi
        expect["value_hi"] = ((R, k), torch.int32)
        expect["samples"] = ((R, k), torch.int32)
    if "hi" in tiles:
        expect["hi"] = ((R, B), torch.int32)
    if valid is not None:
        tensors["valid"] = valid
        expect["valid"] = ((R,), torch.int32)
    if not state.wide and state.values.dtype not in NARROW_DTYPES:
        raise ValueError(f"narrow values must be one of {NARROW_DTYPES}, got {state.values.dtype}")
    check_tensors("batch", tensors, expect)
    return lo, hi, stride, B


def update_cuda(
    state: DistinctState, batch: Batch, valid: Optional[torch.Tensor] = None
) -> DistinctState:
    """Distinct tile merge (the port of ``update_pallas``): reservoir ``r``
    takes ``batch[r, :valid[r]]``."""
    global launches
    lo, hi, stride, B = _validate(state, batch, valid)
    dev = state.values.device
    if dev.type == "cpu":
        return update(state, batch, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, k = state.values.shape
    if (4 if state.wide else 3) * 4 * k > MAX_SMEM:
        raise ValueError(
            f"k={k} is too large for the distinct kernel: a row's entries must fit in "
            f"{MAX_SMEM} bytes of shared memory"
        )
    lib = _library()
    hi_ptr = None if hi is None else hi.data_ptr() + (4 if stride == 2 else 0)
    code = lib.distinct_update(
        state.values.data_ptr(), state.value_hi.data_ptr() if state.wide else None,
        state.hash_hi.data_ptr(), state.hash_lo.data_ptr(), state.size.data_ptr(),
        state.count.data_ptr(), state.salts.data_ptr(), lo.data_ptr(), hi_ptr, stride,
        valid.data_ptr() if valid is not None else None,
        R, k, B, torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        msg = lib.distinct_error_string(code).decode()
        raise RuntimeError(f"distinct_update launch failed: CUDA error {code} ({msg})")
    launches += 1
    return state
