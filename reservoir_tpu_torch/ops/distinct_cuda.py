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

Three instantiations, one rule and one launch count each, chosen once a
tile by :func:`rule_for` as the reference's engine routes a tile between
its Pallas kernel and its XLA sort-merge, and launched by :func:`launch`:

- a full tile with no hook and no ``valid``: :data:`DEFAULT`,
  ``distinct_update`` (:data:`launches`), the Pallas rule (a scrambled
  hash of (MAX, MAX) is never taken);
- ``valid`` given, or ``map_fn`` without ``hash_fn``: :data:`KEEPMAX`,
  ``distinct_update_keepmax`` (:data:`keepmax_launches`), the same kernel
  under the XLA rule (such a lane is kept while its row is not full);
- ``hash_fn``: :data:`HASHED`, the pre-hashed kernel,
  ``distinct_update_hashed`` (:data:`prehashed_launches`), which reads a pair of ``[R, B]``
  pre-scramble hash planes (:func:`.hooks.hash_planes`) and scrambles
  those instead of the keys' words, orders entries by ``(hash, value)``
  (a user hash may give two keys one hash) and follows the XLA rule.

Their plain version is :func:`.distinct.update_prehashed`.
:func:`update_cuda` takes the state and a tile on one device.  A narrow
tile is ``[R, B]`` of the state's dtype; a wide one an int64/uint64
``[R, B]`` tensor (the kernel reads the two words of each key in place) or
an ``(hi, lo)`` pair of 32-bit ``[R, B]`` planes:

- on CUDA tensors it launches a kernel, which mutates the state's tensors
  in place and returns the same state (``count`` advanced); a launch error
  raises;
- on CPU tensors it runs the plain version (:func:`.distinct.update`), which
  returns a new state.

With hooks (:mod:`.hooks`), on the card it maps the tile with ``map_fn``
(cast to the state's dtype) before the launch; on the CPU the plain version
applies the hooks itself.

The three counts are added to under :data:`~._cuda_common.COUNT_LOCK`,
since the interop server launches from several threads, and count nothing
else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from ._cuda_common import COUNT_LOCK, build_info, check_block_r, check_tensors
from .distinct import NARROW_DTYPES, WIDE_DTYPES, Batch, DistinctState, join_planes, map_keys, update, update_prehashed
from .hooks import hash_planes

__all__ = ["DEFAULT", "HASHED", "KEEPMAX", "launches", "keepmax_launches", "prehashed_launches", "rule_for",
           "launch", "update_cuda", "update_prehashed_cuda", "update", "kernel_info"]

#: launches of the default instantiation so far (set it to 0 to count a run)
launches = 0
#: launches of the keep-max instantiation so far (set it to 0 to count a run)
keepmax_launches = 0
#: launches of the pre-hashed instantiation so far (set it to 0 to count a run)
prehashed_launches = 0

#: the kernel's rules (``dst::Rule`` of ``csrc/distinct.cu``): the Pallas
#: rule, pre-hashed and keep-max
DEFAULT, HASHED, KEEPMAX = 0, 1, 2
#: each rule's C entry point at the default geometry
_ENTRY = ("distinct_update", "distinct_update_hashed", "distinct_update_keepmax")

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None


def _library(path: Optional[str] = None):
    """The kernel's library, declared for ``ctypes``: the checkout's build
    of ``csrc/distinct.cu``, or with ``path`` another build with the same C
    entry points, which :func:`update_cuda` then launches until the next
    call with a path (``kernel_ab.py`` times two builds so).  An older build
    without keep-max leaves ``distinct_update_rows`` undeclared (it takes no
    rule there), so a launch at ``block_r`` on it raises."""
    global _lib
    if _lib is None or path is not None:
        from .._build import load

        lib = load("distinct") if path is None else ctypes.CDLL(path)
        lib.distinct_update.argtypes = [_VP] * 9 + [_INT] + [_VP] + [_INT] * 3 + [_VP]
        lib.distinct_update.restype = _INT
        if hasattr(lib, "distinct_update_hashed"):
            lib.distinct_update_hashed.argtypes = [_VP] * 9 + [_INT] + [_VP] * 3 + [_INT] * 3 + [_VP]
            lib.distinct_update_hashed.restype = _INT
        if hasattr(lib, "distinct_update_keepmax"):
            lib.distinct_update_keepmax.argtypes = lib.distinct_update.argtypes
            lib.distinct_update_keepmax.restype = _INT
            lib.distinct_update_rows.argtypes = [_VP] * 9 + [_INT] + [_VP] * 3 + [_INT] * 5 + [_VP]
            lib.distinct_update_rows.restype = _INT
        lib.distinct_error_string.argtypes = [_INT]
        lib.distinct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info(k: int, wide: bool, rule: int = DEFAULT, block_r: Optional[int] = None) -> dict:
    """:func:`~._cuda_common.build_info` of the kernel a launch of ``rule``
    at ``k`` runs, for narrow or wide keys, at ``block_r`` warps a block
    (``None``: the default's) (needs a card): ``dynamic_smem`` is 0 where a
    row's block passes shared memory (k > 19,370 narrow, k > 14,528 wide)
    and the instantiation that keeps it in the state's own arrays runs."""
    return build_info(_library().distinct_rows_kernel_info, int(wide), rule, k, 4 if block_r is None else block_r)


def rule_for(valid, mapped: bool = False, hashed: bool = False) -> int:
    """The rule of a tile, as the reference's engine routes it between its
    Pallas kernel and its XLA sort-merge (``reservoir_tpu/engine.py:386-387``,
    ``ops/distinct.py:232``): :data:`HASHED` under a ``hash_fn``,
    :data:`KEEPMAX` where ``valid`` is given or the keys are mapped, else
    :data:`DEFAULT`."""
    return HASHED if hashed else KEEPMAX if mapped or valid is not None else DEFAULT


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
    ``hash_fn`` where given, at ``block_r`` warps a block, under the rule
    :func:`rule_for` gives."""
    rule = rule_for(valid, mapped=map_fn is not None, hashed=hash_fn is not None)
    if map_fn is None and hash_fn is None:
        return launch(state, batch, None, valid, block_r, rule)
    check_block_r("distinct", block_r)
    if state.values.device.type == "cpu":
        return update(state, batch, valid, map_fn, hash_fn)
    mapped = map_keys(state, batch, map_fn)
    hashes = hash_planes(hash_fn, join_planes(mapped)) if rule == HASHED else None
    return launch(state, mapped, hashes, valid, block_r, rule)


def update_prehashed_cuda(
    state: DistinctState,
    batch: Batch,
    hashes: Optional[Tuple[torch.Tensor, torch.Tensor]],
    valid: Optional[torch.Tensor] = None,
    block_r: Optional[int] = None,
) -> DistinctState:
    """The tile merge of keys ``batch`` whose pre-scramble hash words are
    ``hashes`` (an ``(hi, lo)`` pair of int32 ``[R, B]`` planes), or with
    ``None`` the keys' own words, under the rule :func:`rule_for` gives
    (:func:`launch`)."""
    return launch(state, batch, hashes, valid, block_r, rule_for(valid, hashed=hashes is not None))


def launch(
    state: DistinctState,
    batch: Batch,
    hashes: Optional[Tuple[torch.Tensor, torch.Tensor]],
    valid: Optional[torch.Tensor],
    block_r: Optional[int],
    rule: int,
) -> DistinctState:
    """One launch of ``rule`` (:data:`HASHED` takes ``hashes``, the others
    ``None``), counted as its instantiation.  ``block_r`` is warps a block
    (one a row, at most): ``None`` asks for 4 through the rule's own entry
    point, another value (1, 2 or 4) through ``distinct_update_rows``; the
    launcher takes as many of them as keep their rows on chip
    (``shape_for``).  On CPU tensors it runs
    :func:`.distinct.update_prehashed` (keep-max where ``rule`` is
    :data:`KEEPMAX`)."""
    global launches, keepmax_launches, prehashed_launches
    check_block_r("distinct", block_r)
    if (rule == HASHED) != (hashes is not None) or rule not in (DEFAULT, HASHED, KEEPMAX):
        raise ValueError(f"rule {rule} with hashes {'given' if hashes is not None else 'None'}")
    lo, hi, stride, B = _validate(state, batch, valid, hashes)
    dev = state.values.device
    if dev.type == "cpu":
        return update_prehashed(state, batch, hashes, valid, keep_max=rule == KEEPMAX)
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
    pre = [] if hashes is None else [hashes[0].data_ptr(), hashes[1].data_ptr()]
    tail = [valid.data_ptr() if valid is not None else None, R, k, B]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if block_r is None:
        name = _ENTRY[rule]
        code = getattr(lib, name)(*args, *pre, *tail, stream)
    else:
        name = "distinct_update_rows"
        code = lib.distinct_update_rows(*args, *(pre or [None, None]), *tail, block_r, rule, stream)
    if code != 0:
        msg = lib.distinct_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    with COUNT_LOCK:
        if rule == HASHED:
            prehashed_launches += 1
        elif rule == KEEPMAX:
            keepmax_launches += 1
        else:
            launches += 1
    return state
