"""The distinct-mode (bottom-k) tile merge as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/distinct_pallas.py:_kernel``, entry point
``update_pallas``).  The kernel source is ``csrc/distinct.cu``: one warp per
reservoir row reads the row 128 keys at a time with 16-byte loads (the next
chunk in flight while the current one is scrambled), ballots the keys below
the row's threshold and merges them into the row's sorted block in shared
memory up to 32 at a time: a binary search a lane for the rank and an equal
entry, the new keys ranked among themselves, then one merge pass.  Where a
row's block passes shared memory (k > 19,370 narrow, k > 14,528 wide), the
same rounds run on the block in place in the state's global arrays.  On an
H100 the scramble's integer operations bound a steady tile, and the
serial steps a row takes per round bound a tile from empty; its note says
how the design answers both.  Unlike the Pallas kernel it takes ``valid``,
so ragged tiles run through it too.

Its pre-hashed instantiation (the template flag ``PRE``, entry point
``distinct_update_hashed``) runs the reference's hooks: it reads
a separate pair of ``[R, B]`` pre-scramble hash planes and scrambles those
instead of the keys' words, orders entries by ``(hash, value)`` (a user
hash may give two keys one hash) and follows the reference's XLA rule for a
scrambled hash of (MAX, MAX).  :func:`update_prehashed_cuda` launches it;
its plain version is :func:`.distinct.update_prehashed`.

:func:`update_cuda` takes the state and a tile on one device.  A narrow
tile is ``[R, B]`` of the state's dtype; a wide one an int64/uint64
``[R, B]`` tensor (the kernel reads the two words of each key in place) or
an ``(hi, lo)`` pair of 32-bit ``[R, B]`` planes:

- on CUDA tensors it launches the kernel, which mutates the state's tensors
  in place and returns the same state (``count`` advanced); a launch error
  raises;
- on CPU tensors it runs the plain version (:func:`.distinct.update`), which
  returns a new state.

With hooks (:mod:`.hooks`), on the card it maps the tile with ``map_fn``
(cast to the state's dtype), takes the mapped keys' hash words from
``hash_fn`` (their own words without one, :func:`.distinct.hook_hashes`)
and launches the pre-hashed instantiation on them, as the reference runs
any hook on XLA; on the CPU the plain version applies the hooks itself.

:data:`launches` counts launches of the default instantiation and
:data:`prehashed_launches` those of the pre-hashed one, and nothing else;
they are added to under :data:`~._cuda_common.COUNT_LOCK`, since the
interop server launches from several threads.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from ._cuda_common import COUNT_LOCK, build_info, check_block_r, check_tensors
from .distinct import (NARROW_DTYPES, WIDE_DTYPES, Batch, DistinctState, hook_hashes, map_keys, update,
                       update_prehashed)
from .hashing import to_i32

__all__ = ["launches", "prehashed_launches", "update_cuda", "update_prehashed_cuda", "update",
           "kernel_info"]

#: launches of the default instantiation so far (set it to 0 to count a run)
launches = 0
#: launches of the pre-hashed instantiation so far (set it to 0 to count a run)
prehashed_launches = 0

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
        if hasattr(lib, "distinct_update_hashed"):  # an older build (kernel_ab.py) has none
            lib.distinct_update_hashed.argtypes = [_VP] * 9 + [_INT] + [_VP] * 3 + [_INT] * 3 + [_VP]
            lib.distinct_update_hashed.restype = _INT
        if hasattr(lib, "distinct_update_rows"):  # an older build (kernel_ab.py) has none
            lib.distinct_update_rows.argtypes = [_VP] * 9 + [_INT] + [_VP] * 3 + [_INT] * 4 + [_VP]
            lib.distinct_update_rows.restype = _INT
        lib.distinct_error_string.argtypes = [_INT]
        lib.distinct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info(k: int, wide: bool, prehashed: bool = False, block_r: Optional[int] = None) -> dict:
    """:func:`~._cuda_common.build_info` of the kernel a launch at
    ``k`` runs, for narrow or wide keys, default or pre-hashed, at
    ``block_r`` warps a block (``None``: the default's) (needs a card):
    ``dynamic_smem`` is 0 where a row's block passes shared memory
    (k > 19,370 narrow, k > 14,528 wide) and the instantiation that keeps
    it in the state's own arrays runs."""
    lib = _library()
    if block_r is not None:
        return build_info(lib.distinct_rows_kernel_info, int(wide), int(prehashed), k, block_r)
    query = lib.distinct_prehashed_kernel_info if prehashed else lib.distinct_kernel_info
    return build_info(query, int(wide), k)


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


def _validate(state: DistinctState, batch: Batch, valid, hashes=None) -> tuple:
    R, k = state.values.shape
    tiles, lo, hi, stride, B = _tile_words(state, batch)
    if B < 1:
        raise ValueError(f"batch must be [R={R}, B >= 1], got {tuple(lo.shape)}")
    if hashes is not None:
        tiles["pre_hi"], tiles["pre_lo"] = hashes
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
    if hashes is not None:
        expect["pre_hi"] = expect["pre_lo"] = ((R, B), torch.int32)
    if valid is not None:
        tensors["valid"] = valid
        expect["valid"] = ((R,), torch.int32)
    if not state.wide and state.values.dtype not in NARROW_DTYPES:
        raise ValueError(f"narrow values must be one of {NARROW_DTYPES}, got {state.values.dtype}")
    check_tensors("batch", tensors, expect)
    return lo, hi, stride, B


def update_cuda(
    state: DistinctState,
    batch: Batch,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
    hash_fn: Optional[Callable] = None,
    block_r: Optional[int] = None,
) -> DistinctState:
    """Distinct tile merge (the port of ``update_pallas``): reservoir ``r``
    takes ``batch[r, :valid[r]]``, mapped by ``map_fn`` and hashed by
    ``hash_fn`` where given, at ``block_r`` warps a block."""
    if map_fn is None and hash_fn is None:
        return update_prehashed_cuda(state, batch, None, valid, block_r)
    check_block_r("distinct", block_r)
    if state.values.device.type == "cpu":
        return update(state, batch, valid, map_fn, hash_fn)
    mapped = map_keys(state, batch, map_fn)
    hashes = tuple(to_i32(w).contiguous() for w in hook_hashes(state, mapped, hash_fn))
    return update_prehashed_cuda(state, mapped, hashes, valid, block_r)


def update_prehashed_cuda(
    state: DistinctState,
    batch: Batch,
    hashes: Optional[Tuple[torch.Tensor, torch.Tensor]],
    valid: Optional[torch.Tensor] = None,
    block_r: Optional[int] = None,
) -> DistinctState:
    """The tile merge of keys ``batch`` whose pre-scramble hash words are
    ``hashes`` (an ``(hi, lo)`` pair of int32 ``[R, B]`` planes), launched
    as the pre-hashed instantiation; ``None`` hashes the keys' own words,
    launched as the default one.  ``block_r`` is warps a block (one a
    row, at most): ``None`` asks for 4 through ``distinct_update`` /
    ``distinct_update_hashed``, another value (1, 2 or 4) through
    ``distinct_update_rows``, counted as the instantiation it runs; the
    launcher takes as many of them as keep their rows on chip
    (``shape_for``).  On CPU tensors it runs
    :func:`.distinct.update_prehashed`."""
    global launches, prehashed_launches
    check_block_r("distinct", block_r)
    lo, hi, stride, B = _validate(state, batch, valid, hashes)
    dev = state.values.device
    if dev.type == "cpu":
        return update_prehashed(state, batch, hashes, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, k = state.values.shape
    lib = _library()
    hi_ptr = None if hi is None else hi.data_ptr() + (4 if stride == 2 else 0)
    args = [
        state.values.data_ptr(), state.value_hi.data_ptr() if state.wide else None,
        state.hash_hi.data_ptr(), state.hash_lo.data_ptr(), state.size.data_ptr(),
        state.count.data_ptr(), state.salts.data_ptr(), lo.data_ptr(), hi_ptr, stride,
    ]
    tail = [valid.data_ptr() if valid is not None else None, R, k, B,
            torch.cuda.current_stream(dev).cuda_stream]
    pre = [None, None] if hashes is None else [hashes[0].data_ptr(), hashes[1].data_ptr()]
    if block_r is not None:
        name = "distinct_update_rows"
        code = lib.distinct_update_rows(*args, *pre, *tail[:-1], block_r, tail[-1])
    elif hashes is None:
        name, code = "distinct_update", lib.distinct_update(*args, *tail)
    else:
        name = "distinct_update_hashed"
        code = lib.distinct_update_hashed(*args, *pre, *tail)
    if code != 0:
        msg = lib.distinct_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    with COUNT_LOCK:
        if hashes is None:
            launches += 1
        else:
            prehashed_launches += 1
    return state
