"""What the kernel wrappers share: the checks made before a pointer crosses
to CUDA, the query of what the build made of a kernel, and the lock their
launch counts are taken under."""

from __future__ import annotations

import ctypes
import threading

from .algorithm_l import SAMPLE_DTYPES
from .blocking import BLOCK_CHOICES

__all__ = ["BUILD_INFO_FIELDS", "COUNT_LOCK", "build_info", "check_block_r", "check_tensors"]

#: held while a wrapper adds a launch to its count: the interop server
#: launches from a thread a connection, and ``count += 1`` on a module
#: global is not atomic across threads
COUNT_LOCK = threading.Lock()

#: what :func:`build_info` reports of a kernel, in its order
BUILD_INFO_FIELDS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "warps_per_sm")


def build_info(query, *args: int) -> dict:
    """A library's ``*_kernel_info(*args, out)`` (``csrc/kinfo.cuh``) as a
    dict: registers a thread, local memory a thread (spills), static and
    dynamic shared memory a block, and resident warps an SM at the launch
    shape."""
    query.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = (ctypes.c_int * len(BUILD_INFO_FIELDS))()
    code = query(*args, out)
    if code != 0:
        raise RuntimeError(f"kernel info query failed: CUDA error {code}")
    return dict(zip(BUILD_INFO_FIELDS, out))


def check_tensors(batch_name: str, tensors: dict, expect: dict) -> None:
    """What a kernel's wrapper checks before any pointer crosses to CUDA:
    every tensor in ``tensors`` on the device of ``tensors["samples"]`` and
    contiguous; the samples of a 4-byte dtype; ``tensors[batch_name]`` an
    ``[R, B]`` tile of the samples' dtype; each name in ``expect`` of its
    ``(shape, dtype)``."""
    samples, batch = tensors["samples"], tensors[batch_name]
    R = samples.shape[0]
    for name, t in tensors.items():
        if t.device != samples.device:
            raise ValueError(f"{name} is on {t.device}, samples on {samples.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if samples.dtype not in SAMPLE_DTYPES:
        raise ValueError(f"samples dtype must be one of {SAMPLE_DTYPES}, got {samples.dtype}")
    if batch.dtype != samples.dtype:
        raise ValueError(f"{batch_name} dtype {batch.dtype} != samples dtype {samples.dtype}")
    if batch.ndim != 2 or batch.shape[0] != R:
        raise ValueError(f"{batch_name} must be [R={R}, B], got {tuple(batch.shape)}")
    for name, (shape, dtype) in expect.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )


def check_block_r(kernel: str, block_r) -> None:
    """``block_r`` (rows a block) is ``None`` (the default launch) or one the
    kernel was built for (:data:`~.blocking.BLOCK_CHOICES`), else
    ``ValueError``."""
    if block_r is not None and block_r not in BLOCK_CHOICES[kernel]:
        raise ValueError(f"block_r must be None or one of {BLOCK_CHOICES[kernel]} for {kernel}, got {block_r!r}")
