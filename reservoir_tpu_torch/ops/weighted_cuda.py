"""The weighted (A-ExpJ) tile update as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/weighted_pallas.py:_kernel``, entry point
``update_pallas``).  The kernel source is ``csrc/weighted.cu``: one warp per
reservoir row scans the row's weights in the blocked association of
:mod:`.prefix` while the next block's weights load, keeps the row's keys in
shared memory (for k up to 7,136; beyond, in the state's own arrays) with a
per-lane first minimum reduced across the warp, fills and accepts, and
gathers only the elements it keeps, once a slot at the end.  On an H100 the
bytes of the weights bound a steady tile and the sequential acceptance
chain a fill tile; where acceptances come densely, their draws are made
lane-parallel ahead of the chain.  Its note says more.  Unlike the Pallas
kernel it takes ``valid``, so ragged tiles run through it too.

:func:`update_cuda` takes the state, elements and weights on one device:

- on CUDA tensors it launches the kernel, which mutates the state's tensors
  in place and returns the same state (``count`` advanced); a launch error
  raises;
- on CPU tensors it runs the plain version (:func:`.weighted.update`), which
  returns a new state.

With a ``map_fn`` (:mod:`.hooks`) it maps the whole element tile on the
card and casts it to the sample dtype, then launches the unchanged kernel:
for an elementwise map the reference's map on accept, which the plain
version applies on the CPU.

:data:`launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ._cuda_common import build_info, check_block_r, check_tensors
from .hooks import map_values
from .weighted import WeightedState, update

__all__ = ["launches", "update_cuda", "update", "kernel_info"]

#: kernel launches so far (set it to 0 to count a run)
launches = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None


def _library(path: Optional[str] = None):
    """The kernel's library, declared for ``ctypes``: the checkout's build
    of ``csrc/weighted.cu``, or with ``path`` another build with the same C
    entry points, which :func:`update_cuda` then launches until the next
    call with a path (``kernel_ab.py`` times two builds so)."""
    global _lib
    if _lib is None or path is not None:
        from .._build import load

        lib = load("weighted") if path is None else ctypes.CDLL(path)
        lib.weighted_update.argtypes = [_VP] * 8 + [_INT] * 3 + [_VP]
        lib.weighted_update.restype = _INT
        if hasattr(lib, "weighted_update_rows"):  # an older build (kernel_ab.py) has none
            lib.weighted_update_rows.argtypes = [_VP] * 8 + [_INT] * 4 + [_VP]
            lib.weighted_update_rows.restype = _INT
        lib.weighted_error_string.argtypes = [_INT]
        lib.weighted_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info(k: int, block_r: Optional[int] = None) -> dict:
    """:func:`~._cuda_common.build_info` of the kernel a launch at
    ``k`` runs, at ``block_r`` warps a block (``None``: the default's)
    (needs a card)."""
    if block_r is not None:
        return build_info(_library().weighted_rows_kernel_info, k, block_r)
    return build_info(_library().weighted_kernel_info, k)


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
    map_fn: Optional[Callable] = None,
    block_r: Optional[int] = None,
) -> WeightedState:
    """Fill-capable weighted tile update (the port of ``update_pallas``):
    reservoir ``r`` takes ``elems[r, :valid[r]]`` with their weights,
    mapped by ``map_fn`` where given, at ``block_r`` warps a block (one a
    row; ``None``: the default, 4, through ``weighted_update``, another
    value through ``weighted_update_rows``)."""
    global launches
    check_block_r("weighted", block_r)
    if map_fn is not None:
        if state.samples.device.type == "cpu":
            return update(state, elems, weights, valid, map_fn)
        elems = map_values(map_fn, elems, state.samples.dtype)
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
    name, geometry = ("weighted_update", ()) if block_r is None else ("weighted_update_rows", (block_r,))
    code = getattr(lib, name)(
        state.samples.data_ptr(), state.lkeys.data_ptr(), state.count.data_ptr(),
        state.xw.data_ptr(), key32.data_ptr(), elems.data_ptr(), weights.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        R, k, elems.shape[1], *geometry, torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        msg = lib.weighted_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    launches += 1
    return state
