"""reservoir-tpu on PyTorch and CUDA: the port of ``reservoir_tpu`` to an
NVIDIA H100.

It runs the uniform (duplicates-mode) Algorithm-L engine, the weighted
A-ExpJ engine and the distinct (bottom-k) engine, and merges the reservoirs
of several shards of one stream into one exact sample:

- :mod:`reservoir_tpu_torch.ops.threefry`, :mod:`.ops.rng` — counter-keyed
  Threefry draws equal to ``jax.random``'s;
- :mod:`reservoir_tpu_torch.ops.fmath` — float32 ``log``/``exp``/``log1p``
  bit-identical to XLA CPU's;
- :mod:`reservoir_tpu_torch.ops.hashing` — the salted 64-bit scramble of
  distinct mode;
- :mod:`reservoir_tpu_torch.ops.algorithm_l`, :mod:`.ops.weighted` (with
  the blocked prefix sum of :mod:`.ops.prefix`) and :mod:`.ops.distinct` —
  the plain torch versions, each with its pairwise merge;
- :mod:`reservoir_tpu_torch.ops.algorithm_l_cuda`, :mod:`.ops.weighted_cuda`,
  :mod:`.ops.distinct_cuda` and :mod:`.ops.merge_cuda` — the hand-written
  CUDA kernels (``csrc/algorithm_l.cu``, ``csrc/weighted.cu``,
  ``csrc/distinct.cu``, ``csrc/merge_ring.cu``), built with ``nvcc`` at
  first use;
- :class:`ReservoirEngine` with checkpoints in the JAX package's format;
- :class:`DeviceStreamBridge` and :class:`DeviceSampler`
  (:mod:`reservoir_tpu_torch.stream`) — the host-to-device stream bridge:
  the C++ demux of :mod:`.native` into pinned host tiles, ragged flushes,
  the flush journal and recovery, in the JAX package's formats;
- :mod:`reservoir_tpu_torch.parallel.merge` — the merge tree over parts
  spread over ranks, and the stream mergers.

The package imports torch and numpy, never jax and nothing of
``reservoir_tpu``.  Its entry points run on the card (``device=None`` means
``"cuda"``); ``device="cpu"`` runs the plain version.
"""

from .config import MAX_SIZE, SamplerConfig
from .engine import ReservoirEngine
from .errors import CheckpointCorrupt, CheckpointMismatch, SamplerClosedError
from .stream import DeviceSampler, DeviceStreamBridge

__version__ = "0.1.0"

__all__ = [
    "MAX_SIZE",
    "CheckpointCorrupt",
    "CheckpointMismatch",
    "DeviceSampler",
    "DeviceStreamBridge",
    "ReservoirEngine",
    "SamplerClosedError",
    "SamplerConfig",
]
