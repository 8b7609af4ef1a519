"""The Algorithm-L tile update as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/algorithm_l_pallas.py:_kernel``, entry points
``update_pallas`` and ``update_steady_pallas``).  The kernel source is
``csrc/algorithm_l.cu``: one thread per reservoir row walks the row's
acceptance chain without waiting on memory: each accept's element is
gathered by ``cp.async`` into a ring in shared memory and written to its
slot a few accepts later, in acceptance order; the fill copy is coalesced;
a row expecting many accepts has its samples prefetched into L2.  It reads
only the elements it accepts and updates the state in place.  Its note says
what bounds it on an H100.

:func:`update_gated_cuda` applies the skip gate's candidate tiles with the
second kernel of that file, ``algl_update_gated`` (one thread a row, the
same chain from ``csrc/algl_chain.cuh``).  The JAX package's gated update
is XLA, not Pallas (``reservoir_tpu/ops/algorithm_l.py:_update_gated_one``):
the port gives it a kernel because a lockstep loop on the card would cost
tens of launches and a host sync a step.

:func:`merge_draws_cuda` draws what a uniform merge draws
(:func:`~.algorithm_l.merge_draws`: the hypergeometric scan's ``j_a`` and
the two permutations' keys) with the kernel of ``csrc/algl_merge.cu``, in
one launch and without a host sync.  The JAX package computes them in XLA
(its ``lax.scan`` and ``_masked_perm``), not Pallas: the port gives them a
kernel because the plain version's scan is k lockstep steps of small
launches, each with a host sync.  :func:`~.algorithm_l.merge_samples_keyed`
draws through it.

Each update takes ``block_r``, rows a block (threads: one a row), from
:data:`~.blocking.BLOCK_CHOICES` (32, 64, 128, 256; the engine resolves
a cache entry through :mod:`.blocking`): ``None`` launches the default, 128, through
the entry points ``algl_update``, ``algl_update_wide`` and
``algl_update_gated``; another value through their ``*_rows`` twins, the
template instantiation built for it.  Every geometry gives the default's
bits.

WIDE counters (``[R, 2]`` uint32 ``count`` and ``nxt``) take the WIDE
instantiations of both kernels: ``algl_update_wide`` for a tile update and
``algl_merge_draws_wide`` for a merge's draws (the reference runs both on
XLA: its Pallas kernel declines WIDE states).  The kernels read the words
in place as uint64, so a counter tensor that is not 8-byte aligned is
first copied into one that is.  The gated update takes int32 counters only
and raises for WIDE ones, as the reference does.

:func:`update_cuda` and :func:`update_steady_cuda` take the state and tile
on one device:

- on CUDA tensors they launch the kernel, which mutates the state's
  tensors in place and returns the same state (``count`` advanced); a
  launch error raises;
- on CPU tensors they run the plain version (:func:`update` /
  :func:`update_steady` of :mod:`.algorithm_l`), which returns a new state.

With a ``map_fn`` (:mod:`.hooks`) the update, the gated one too, maps the
whole tile on the card and casts it to the sample dtype, then launches the
unchanged kernel on the mapped words: for an elementwise map the same
state as the reference's map on accept, which the plain version applies on
the CPU.  The map costs one pass over the tile beside the kernel, which
reads only the elements it accepts.

:data:`launches` counts ``algl_update`` launches, :data:`wide_launches`
``algl_update_wide`` launches, :data:`gated_launches` ``algl_update_gated``
launches, :data:`merge_launches` ``algl_merge_draws`` launches and
:data:`wide_merge_launches` ``algl_merge_draws_wide`` launches, and nothing
else; the update counts are added to under
:data:`~._cuda_common.COUNT_LOCK`, since the interop server launches from
several threads.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ._cuda_common import COUNT_LOCK, build_info, check_block_r, check_tensors
from .hooks import map_values
from .algorithm_l import (MergeDraws, ReservoirState, _check_counts, _signed_rows, merge_draws, update,
                          update_gated, update_steady)

__all__ = [
    "launches",
    "wide_launches",
    "gated_launches",
    "update_cuda",
    "merge_launches",
    "wide_merge_launches",
    "update_gated_cuda",
    "update_steady_cuda",
    "merge_draws_cuda",
    "fmath_cuda",
    "kernel_info",
    "gated_kernel_info",
    "merge_kernel_info",
    "update",
    "update_steady",
]

#: ``algl_update`` launches so far (set it to 0 to count a run)
launches = 0
#: ``algl_update_wide`` launches so far (set it to 0 to count a run)
wide_launches = 0
#: ``algl_update_gated`` launches so far (set it to 0 to count a run)
gated_launches = 0
#: ``algl_merge_draws`` launches so far (set it to 0 to count a run)
merge_launches = 0
#: ``algl_merge_draws_wide`` launches so far (set it to 0 to count a run)
wide_merge_launches = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None
_merge_lib = None


def _library(path: Optional[str] = None):
    """The kernel's library, declared for ``ctypes``: the checkout's build
    of ``csrc/algorithm_l.cu``, or with ``path`` another build with the same
    C entry points, which :func:`update_cuda` then launches until the next
    call with a path (``kernel_ab.py`` times two builds so)."""
    global _lib
    if _lib is None or path is not None:
        from .._build import load

        lib = load("algorithm_l") if path is None else ctypes.CDLL(path)
        lib.algl_update.argtypes = [_VP] * 7 + [_INT] * 4 + [_VP]
        lib.algl_update.restype = _INT
        # an older build (kernel_ab.py) may lack any of these
        for name, argtypes in (
            ("algl_update_wide", [_VP] * 7 + [_INT] * 4 + [_VP]),
            ("algl_update_gated", [_VP] * 8 + [_INT] * 3 + [_VP]),
            ("algl_update_rows", [_VP] * 7 + [_INT] * 5 + [_VP]),
            ("algl_update_wide_rows", [_VP] * 7 + [_INT] * 5 + [_VP]),
            ("algl_update_gated_rows", [_VP] * 8 + [_INT] * 4 + [_VP]),
        ):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = _INT
        lib.algl_fmath.argtypes = [_VP, _VP, _INT, _INT, _VP]
        lib.algl_fmath.restype = _INT
        lib.algl_error_string.argtypes = [_INT]
        lib.algl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _merge_library(path: Optional[str] = None):
    """The merge kernel's library, declared for ``ctypes``: the checkout's
    build of ``csrc/algl_merge.cu``, or with ``path`` another build with the
    same C entry points (as :func:`_library`)."""
    global _merge_lib
    if _merge_lib is None or path is not None:
        from .._build import load

        lib = load("algl_merge") if path is None else ctypes.CDLL(path)
        lib.algl_merge_draws.argtypes = [_VP] * 7 + [_INT] * 2 + [_VP]
        lib.algl_merge_draws.restype = _INT
        if hasattr(lib, "algl_merge_draws_wide"):  # an older build (kernel_ab.py) has none
            lib.algl_merge_draws_wide.argtypes = [_VP] * 6 + [_INT] * 2 + [_VP]
            lib.algl_merge_draws_wide.restype = _INT
        _merge_lib = lib
    return _merge_lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().algl_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def kernel_info(wide: bool = False, block_r: Optional[int] = None) -> dict:
    """:func:`~._cuda_common.build_info` of ``algl_update``'s kernel, or
    with ``wide`` of ``algl_update_wide``'s, at ``block_r`` threads a block
    (``None``: the default's) (needs a card)."""
    lib = _library()
    if block_r is not None:
        return build_info(lib.algl_rows_kernel_info, int(wide), block_r)
    return build_info(lib.algl_wide_kernel_info if wide else lib.algl_kernel_info)


def gated_kernel_info(block_r: Optional[int] = None) -> dict:
    """:func:`~._cuda_common.build_info` of ``algl_update_gated``'s kernel
    at ``block_r`` threads a block (``None``: the default's) (needs a
    card)."""
    if block_r is not None:
        return build_info(_library().algl_rows_kernel_info, 2, block_r)
    return build_info(_library().algl_gated_kernel_info)


def merge_kernel_info(wide: bool = False) -> dict:
    """:func:`~._cuda_common.build_info` of ``algl_merge_draws``' kernel,
    or with ``wide`` of ``algl_merge_draws_wide``'s (needs a card)."""
    lib = _merge_library()
    return build_info(lib.algl_merge_wide_kernel_info if wide else lib.algl_merge_kernel_info)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _aligned8(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in a fresh (aligned) allocation where its data
    does not start on 8 bytes: a WIDE kernel reads ``[R, 2]`` uint32 words
    as uint64."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _validate(state: ReservoirState, batch: torch.Tensor, valid) -> None:
    R = state.samples.shape[0]
    tensors = {
        "samples": state.samples, "count": state.count, "nxt": state.nxt,
        "log_w": state.log_w, "key": state.key, "batch": batch,
    }
    counter = ((R, 2), torch.uint32) if state.count.ndim == 2 else ((R,), torch.int32)
    expect = {
        "count": counter, "nxt": counter,
        "log_w": ((R,), torch.float32), "key": ((R, 2), torch.int64),
    }
    if valid is not None:
        tensors["valid"] = valid
        expect["valid"] = ((R,), torch.int32)
    check_tensors("batch", tensors, expect)


def _launch(state: ReservoirState, batch: torch.Tensor, valid, fill: bool,
            map_fn: Optional[Callable] = None, block_r: Optional[int] = None) -> ReservoirState:
    global launches, wide_launches
    check_block_r("algl", block_r)
    if map_fn is not None:
        if state.samples.device.type == "cpu":
            return (update if fill else update_steady)(state, batch, valid, map_fn)
        batch = map_values(map_fn, batch, state.samples.dtype)
    _validate(state, batch, valid)
    if state.samples.device.type == "cpu":
        return (update if fill else update_steady)(state, batch, valid)
    if state.samples.device.type != "cuda":
        raise ValueError(f"unsupported device {state.samples.device}")
    R, k = state.samples.shape
    B = batch.shape[1]
    lib = _library()
    wide = state.wide
    if wide:
        state = state._replace(count=_aligned8(state.count), nxt=_aligned8(state.nxt))
    # the kernel reads the key as uint32 words: the low half of each int64
    key32 = state.key.to(torch.int32)
    name = "algl_update_wide" if wide else "algl_update"
    geometry = () if block_r is None else (block_r,)
    if geometry:
        name += "_rows"
    code = getattr(lib, name)(
        state.samples.data_ptr(), state.count.data_ptr(), state.nxt.data_ptr(),
        state.log_w.data_ptr(), key32.data_ptr(), batch.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        R, k, B, int(fill), *geometry, _stream(state.samples.device),
    )
    _raise_on(code, f"{name} launch")
    with COUNT_LOCK:
        if wide:
            wide_launches += 1
        else:
            launches += 1
    return state


def update_cuda(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
    block_r: Optional[int] = None,
) -> ReservoirState:
    """Fill-capable tile update (the port of ``update_pallas``; WIDE
    counters launch ``algl_update_wide``) at ``block_r`` threads a block
    (``None``: the default)."""
    return _launch(state, batch, valid, True, map_fn, block_r)


def update_steady_cuda(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
    block_r: Optional[int] = None,
) -> ReservoirState:
    """Steady tile update without the fill copy (the port of
    ``update_steady_pallas``) at ``block_r`` threads a block."""
    return _launch(state, batch, valid, False, map_fn, block_r)


def update_gated_cuda(
    state: ReservoirState,
    batch: torch.Tensor,
    nvalid: torch.Tensor,
    advance: torch.Tensor,
    map_fn: Optional[Callable] = None,
    block_r: Optional[int] = None,
) -> ReservoirState:
    """Apply one pre-gated ``[R, Bg]`` candidate tile: row ``r`` advances
    by ``advance[r]`` elements, of which ``batch[r, :nvalid[r]]`` were
    shipped (the plain version is :func:`~.algorithm_l.update_gated`).
    On CUDA tensors it launches ``algl_update_gated``, which mutates the
    state in place and returns it; on CPU tensors it runs the plain
    version, which returns a new state.  ``nvalid`` must lie in
    ``[0, Bg]`` and ``advance`` be nonnegative (the engine checks both on
    the host; the kernel trusts them).  WIDE counters raise
    ``ValueError``, as the reference's ``update_gated`` does.  A
    ``map_fn`` maps the candidate tile as :func:`update_cuda` maps a
    tile; ``block_r`` is threads a block (``None``: the default)."""
    global gated_launches
    check_block_r("algl_gated", block_r)
    if state.wide:
        raise ValueError("update_gated requires narrow (non-WIDE) counters")
    if map_fn is not None:
        if state.samples.device.type == "cpu":
            return update_gated(state, batch, nvalid, advance, map_fn)
        batch = map_values(map_fn, batch, state.samples.dtype)
    R = state.samples.shape[0]
    tensors = {
        "samples": state.samples, "count": state.count, "nxt": state.nxt,
        "log_w": state.log_w, "key": state.key, "batch": batch, "nvalid": nvalid,
        "advance": advance,
    }
    expect = {
        "count": ((R,), torch.int32), "nxt": ((R,), torch.int32),
        "log_w": ((R,), torch.float32), "key": ((R, 2), torch.int64),
        "nvalid": ((R,), torch.int32), "advance": ((R,), torch.int32),
    }
    check_tensors("batch", tensors, expect)
    if state.samples.device.type == "cpu":
        return update_gated(state, batch, nvalid, advance)
    if state.samples.device.type != "cuda":
        raise ValueError(f"unsupported device {state.samples.device}")
    R, k = state.samples.shape
    key32 = state.key.to(torch.int32)
    name, geometry = ("algl_update_gated", ()) if block_r is None else ("algl_update_gated_rows", (block_r,))
    code = getattr(_library(), name)(
        state.samples.data_ptr(), state.count.data_ptr(), state.nxt.data_ptr(),
        state.log_w.data_ptr(), key32.data_ptr(), batch.data_ptr(), nvalid.data_ptr(),
        advance.data_ptr(), R, k, batch.shape[1], *geometry, _stream(state.samples.device),
    )
    _raise_on(code, f"{name} launch")
    gated_launches += 1
    return state


def merge_draws_cuda(
    count_a: torch.Tensor,
    count_b: torch.Tensor,
    row_keys: torch.Tensor,
    k: int,
    signed: Optional[torch.Tensor] = None,
) -> MergeDraws:
    """What a uniform merge of ``[R, k]`` samples draws
    (:class:`~.algorithm_l.MergeDraws`) for counts ``count_a``,
    ``count_b`` (int32 or uint32 ``[R]``), ``row_keys`` (int64 ``[R, 2]``
    key words) and ``signed`` (uint8 ``[R]``, as
    :func:`~.algorithm_l.merge_samples_keyed` takes it).  On CUDA tensors
    (contiguous) it launches ``algl_merge_draws`` once, into new tensors,
    with no host sync; on CPU tensors it runs the plain
    :func:`~.algorithm_l.merge_draws`.  WIDE counts (both ``[R, 2]``
    32-bit words) launch ``algl_merge_draws_wide`` and take no
    ``signed``."""
    global merge_launches, wide_merge_launches
    R = row_keys.shape[0]
    _check_counts(count_a, count_b, R)
    for name, c in (("count_a", count_a), ("count_b", count_b)):
        if c.device != row_keys.device:
            raise ValueError(f"{name} is on {c.device}, row_keys on {row_keys.device}")
    if row_keys.shape != (R, 2) or row_keys.dtype != torch.int64:
        raise ValueError(f"row_keys must be int64 [R={R}, 2] key words, got {row_keys.dtype} "
                         f"{tuple(row_keys.shape)}")
    if signed is not None and (signed.shape != (R,) or signed.dtype != torch.uint8
                               or signed.device != row_keys.device):
        raise ValueError(f"signed must be uint8 [R={R}] on {row_keys.device}, got {signed.dtype} "
                         f"{tuple(signed.shape)} on {signed.device}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    dev = row_keys.device
    if dev.type == "cpu":
        return merge_draws(count_a, count_b, row_keys, k, signed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    wide = count_a.ndim == 2
    if signed is None and not wide:
        signed = _signed_rows(count_a, count_b)
    if not all(t.is_contiguous() for t in (count_a, count_b, row_keys, signed) if t is not None):
        raise ValueError("count_a, count_b, row_keys and signed must be contiguous")
    # the kernel reads the key as uint32 words: the low half of each int64
    key32 = row_keys.to(torch.int32)
    j_a = torch.empty(R, dtype=torch.int32, device=dev)
    u_a = torch.empty((R, k), dtype=torch.float32, device=dev)
    u_b = torch.empty((R, k), dtype=torch.float32, device=dev)
    lib = _merge_library()
    if wide:
        count_a, count_b = _aligned8(count_a), _aligned8(count_b)
        code = lib.algl_merge_draws_wide(
            count_a.data_ptr(), count_b.data_ptr(), key32.data_ptr(), j_a.data_ptr(),
            u_a.data_ptr(), u_b.data_ptr(), R, k, _stream(dev),
        )
        _raise_on(code, "algl_merge_draws_wide launch")
        wide_merge_launches += 1
    else:
        code = lib.algl_merge_draws(
            count_a.data_ptr(), count_b.data_ptr(), signed.data_ptr(), key32.data_ptr(),
            j_a.data_ptr(), u_a.data_ptr(), u_b.data_ptr(), R, k, _stream(dev),
        )
        _raise_on(code, "algl_merge_draws launch")
        merge_launches += 1
    return MergeDraws(j_a, u_a, u_b)


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
