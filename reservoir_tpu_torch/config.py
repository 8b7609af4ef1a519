"""Engine configuration and parameter validation.

The port keeps its own copy of the JAX package's ``SamplerConfig`` with the
same fields and the same checks, so a checkpoint's recorded config restores
in either package.  Which of its options the port's engine runs is the
engine's business (:mod:`reservoir_tpu_torch.engine`).  The checks of the
sampler factories' parameters, which :mod:`~reservoir_tpu_torch.api` and
:mod:`~reservoir_tpu_torch.stream.operator` make when a sampler or a flow
is built, are copies of the JAX package's too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

__all__ = [
    "DEFAULT_INITIAL_SIZE",
    "MAX_SIZE",
    "SamplerConfig",
    "validate_distinct_params",
    "validate_hash",
    "validate_map",
    "validate_max_sample_size",
    "validate_non_distinct_params",
    "validate_shared_params",
]

#: Maximum sample size (``Int.MaxValue - 2``, the reference's ``MaxSize``).
MAX_SIZE: int = 2**31 - 3

#: Initial capacity of a growable reservoir that is not pre-allocated (the
#: reference's ``Sampler.scala:72``); the engine's reservoirs are always
#: ``k`` wide.
DEFAULT_INITIAL_SIZE: int = 16


def validate_max_sample_size(max_sample_size: Any) -> int:
    """``0 < max_sample_size <= MAX_SIZE``, else ``ValueError``."""
    if not isinstance(max_sample_size, int) or isinstance(max_sample_size, bool):
        raise ValueError(
            f"max_sample_size must be an int, got {type(max_sample_size).__name__}"
        )
    if max_sample_size <= 0:
        raise ValueError(f"max_sample_size must be positive, got {max_sample_size}")
    if max_sample_size > MAX_SIZE:
        raise ValueError(
            f"max_sample_size must be <= {MAX_SIZE}, got {max_sample_size}"
        )
    return max_sample_size


def validate_map(map_fn: Any) -> Callable:
    """A callable ``map``, else ``TypeError`` (the reference's null check)."""
    if map_fn is None or not callable(map_fn):
        raise TypeError("map function must be callable (got %r)" % (map_fn,))
    return map_fn


def validate_hash(hash_fn: Any) -> Callable:
    """A callable ``hash``, else ``TypeError``."""
    if hash_fn is None or not callable(hash_fn):
        raise TypeError("hash function must be callable (got %r)" % (hash_fn,))
    return hash_fn


def validate_shared_params(max_sample_size: Any, map_fn: Any) -> None:
    """What every sampler factory checks: the size and the ``map``."""
    validate_max_sample_size(max_sample_size)
    validate_map(map_fn)


def validate_non_distinct_params(max_sample_size: Any, map_fn: Any) -> None:
    """What the uniform factories check (the shared checks)."""
    validate_shared_params(max_sample_size, map_fn)


def validate_distinct_params(max_sample_size: Any, map_fn: Any, hash_fn: Any) -> None:
    """What the distinct factories check: the shared checks and the
    ``hash``."""
    validate_shared_params(max_sample_size, map_fn)
    validate_hash(hash_fn)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Frozen engine configuration: ``num_reservoirs`` independent
    reservoirs of capacity ``max_sample_size``, fed ``[R, tile_size]`` tiles.

    Attributes:
      max_sample_size: ``k``, reservoir capacity per stream.
      num_reservoirs: ``R``, independent reservoirs.
      tile_size: ``B``, elements per reservoir per tile.
      element_dtype: dtype name of stream elements.
      sample_dtype: dtype name of stored samples; defaults to
        ``element_dtype``.
      count_dtype: per-reservoir counter dtype (``"int32"``, or ``"wide"``
        for emulated 64-bit counters).
      distinct: bottom-k distinct-value mode.
      weighted: A-ExpJ weighted mode.
      mesh_axis: mesh axis the reservoirs are sharded over.
      impl: kernel selection, ``"auto"``, ``"xla"`` or ``"pallas"``.
    """

    max_sample_size: int
    num_reservoirs: int = 1
    tile_size: int = 1024
    element_dtype: Any = "int32"
    sample_dtype: Optional[Any] = None
    count_dtype: Any = "int32"
    distinct: bool = False
    weighted: bool = False
    mesh_axis: Optional[str] = None
    impl: str = "auto"

    def __post_init__(self) -> None:
        validate_max_sample_size(self.max_sample_size)
        if self.num_reservoirs <= 0:
            raise ValueError("num_reservoirs must be positive")
        if self.tile_size <= 0:
            raise ValueError("tile_size must be positive")
        if self.impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"impl must be 'auto', 'xla' or 'pallas', got {self.impl!r}"
            )
        if self.count_dtype == "wide" and (self.distinct or self.weighted):
            raise ValueError(
                "count_dtype='wide' is only supported in duplicates mode "
                "(distinct/weighted counters stay int32)"
            )

    @property
    def k(self) -> int:
        return self.max_sample_size

    def resolved_sample_dtype(self) -> Any:
        return self.sample_dtype if self.sample_dtype is not None else self.element_dtype
