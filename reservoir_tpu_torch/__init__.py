"""reservoir-tpu on PyTorch and CUDA: the port of ``reservoir_tpu`` to an
NVIDIA H100.

It runs the uniform (duplicates-mode) Algorithm-L engine and the weighted
A-ExpJ engine:

- :mod:`reservoir_tpu_torch.ops.threefry`, :mod:`.ops.rng` — counter-keyed
  Threefry draws equal to ``jax.random``'s;
- :mod:`reservoir_tpu_torch.ops.fmath` — float32 ``log``/``exp``/``log1p``
  bit-identical to XLA CPU's;
- :mod:`reservoir_tpu_torch.ops.algorithm_l` and :mod:`.ops.weighted` (with
  the blocked prefix sum of :mod:`.ops.prefix`) — the plain torch versions;
- :mod:`reservoir_tpu_torch.ops.algorithm_l_cuda` and
  :mod:`.ops.weighted_cuda` — the hand-written CUDA kernels
  (``csrc/algorithm_l.cu``, ``csrc/weighted.cu``), built with ``nvcc`` at
  first use;
- :class:`ReservoirEngine` with checkpoints in the JAX package's format.

The package imports torch and numpy, never jax and nothing of
``reservoir_tpu``.  Its entry points run on the card (``device=None`` means
``"cuda"``); ``device="cpu"`` runs the plain version.
"""

from .config import MAX_SIZE, SamplerConfig
from .engine import ReservoirEngine
from .errors import CheckpointCorrupt, CheckpointMismatch, SamplerClosedError

__version__ = "0.1.0"

__all__ = [
    "MAX_SIZE",
    "CheckpointCorrupt",
    "CheckpointMismatch",
    "ReservoirEngine",
    "SamplerClosedError",
    "SamplerConfig",
]
