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
  spread over ranks, and the stream mergers;
- :mod:`reservoir_tpu_torch.parallel.sharded` — one engine's reservoirs
  sharded over the ranks of a ``Mesh`` (``SamplerConfig(mesh_axis=...)``),
  and :mod:`.parallel.multihost`, the ``torch.distributed`` join;
- :mod:`reservoir_tpu_torch.api` — the reference's public surface: the
  ``Sampler`` trait, the factories :func:`sampler` and :func:`distinct`
  with the single-use / reusable lifecycle, ``SampleView`` snapshots, and
  the host ``weighted`` sampler;
- :mod:`reservoir_tpu_torch.oracle` — the host samplers' CPU oracles
  (``AlgorithmLOracle``, ``BottomKOracle``, ``AExpJOracle``,
  ``NaiveWeightedOracle``), with the C scans of ``_native/algl_scan.cc``
  and ``_native/bottom_k.cc`` built with g++ at first use;
- :mod:`reservoir_tpu_torch.stream.operator` — the pass-through operator
  :class:`Sample` (``run``, ``run_async``, the completion protocol), whose
  ``Sample.device`` samples on the card through the engine's kernels;
- :mod:`reservoir_tpu_torch.stream.interop` — ``SampleServer``, the socket
  server behind the JVM shim stage, on the host samplers or, with a
  ``DeviceSampler`` factory, on the card;
- :mod:`reservoir_tpu_torch.serve` — the serving plane:
  :class:`ReservoirService` multiplexes tenant sessions onto the rows of one
  bridge, recycling rows through the engine's ``reset_rows``;
  ``StandbyReplica`` and ``FailoverController`` keep a hot standby and fail
  over to it; ``ShardedReservoirService`` routes sessions over shard units
  and migrates them through ``export_rows`` / ``adopt_rows``.

The package imports torch and numpy, never jax and nothing of
``reservoir_tpu``.  Importing the package itself imports neither torch nor
numpy: its engine, bridge and host API load when first asked for, as the
JAX package's do, so its stdlib-only lint
(:mod:`reservoir_tpu_torch.analysis`) runs in a bare interpreter.  Its
entry points run on the card (``device=None`` means ``"cuda"``);
``device="cpu"`` runs the plain version.  The host samplers
(:func:`sampler`, :func:`distinct`, ``Sample(k)``) are host samplers, the
semantic baseline, on the CPU by design.
"""

from .config import DEFAULT_INITIAL_SIZE, MAX_SIZE, SamplerConfig
from .errors import (
    AbruptStreamTermination,
    CheckpointCorrupt,
    CheckpointMismatch,
    FencedError,
    FlushTimeout,
    RetryPolicy,
    SamplerClosedError,
    ServiceSaturated,
    SessionIngestError,
    StaleSessionError,
    StreamCancelled,
    TransientDeviceError,
    UnknownSessionError,
)

__version__ = "0.1.0"


def __getattr__(name):
    # loaded when first asked for, as the JAX package does: importing the
    # package pulls in neither torch nor numpy
    if name in ("sampler", "distinct", "Sampler"):
        from . import api

        return getattr(api, name)
    if name == "ReservoirEngine":
        from .engine import ReservoirEngine

        return ReservoirEngine
    if name in ("Sample", "DeviceStreamBridge", "DeviceSampler"):
        from . import stream

        return getattr(stream, name)
    if name in (
        "ReservoirService",
        "SessionTable",
        "Session",
        "StandbyReplica",
        "JournalFollower",
        "FailoverController",
        "HeartbeatWriter",
    ):
        from . import serve

        return getattr(serve, name)
    raise AttributeError(f"module 'reservoir_tpu_torch' has no attribute {name!r}")


__all__ = [
    "DEFAULT_INITIAL_SIZE",
    "MAX_SIZE",
    "AbruptStreamTermination",
    "CheckpointCorrupt",
    "CheckpointMismatch",
    "DeviceSampler",
    "DeviceStreamBridge",
    "FailoverController",
    "FencedError",
    "FlushTimeout",
    "HeartbeatWriter",
    "JournalFollower",
    "ReservoirEngine",
    "ReservoirService",
    "RetryPolicy",
    "Sample",
    "Sampler",
    "SamplerClosedError",
    "SamplerConfig",
    "ServiceSaturated",
    "Session",
    "SessionIngestError",
    "SessionTable",
    "StaleSessionError",
    "StandbyReplica",
    "StreamCancelled",
    "TransientDeviceError",
    "UnknownSessionError",
    "distinct",
    "sampler",
]
