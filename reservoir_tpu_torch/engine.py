"""ReservoirEngine — R lockstep reservoirs on the card: uniform, weighted or
distinct.

The port of the JAX package's ``engine.py`` for duplicates (uniform) mode,
weighted (A-ExpJ) mode and distinct (bottom-k) mode: the same
construction-time validation, single-use/reusable lifecycle and result
truncation, over ``[R, B]`` tiles where reservoir ``r`` consumes
``tile[r, :valid[r]]`` of its own stream (and, weighted, the same slice of a
parallel ``[R, B]`` weights tile).

Every uniform tile goes through the CUDA kernel of
:mod:`~reservoir_tpu_torch.ops.algorithm_l_cuda`, every weighted tile
through that of :mod:`~reservoir_tpu_torch.ops.weighted_cuda`, every
distinct tile through that of :mod:`~reservoir_tpu_torch.ops.distinct_cuda`;
with ``device="cpu"`` the same wrappers run the plain torch versions.  There
is no other path and no fallback: a build or launch failure raises.  In
uniform mode a host-side lower bound on every reservoir's count (no device
read) decides between the fill-capable and the steady update, as in the JAX
engine; a weighted tile always takes the fill-capable kernel, because a
zero-weight item is counted without taking a slot.

Distinct mode takes 4-byte integer keys (int32, uint32) or 8-byte ones
(int64, uint64).  An 8-byte host tile is split into its ``(hi, lo)`` word
planes on the host (:func:`~.ops.distinct.split_values_host`) before its
pinned snapshot; an 8-byte tile on the card goes to the kernel as it is,
which reads both words of each key in place.  Results reassemble 8-byte
keys on the host (:func:`~.ops.distinct.assemble_values`).

Host tiles and weights (numpy arrays, lists, CPU tensors) are snapshotted
into a pinned host buffer and copied to the card without blocking; the
buffer is held until the copy's event has completed, so a caller may reuse
its own buffers as soon as :meth:`ReservoirEngine.sample` returns.  CUDA
tensors on the engine's device are used as they are: host weights are
checked to be nonnegative, device weights are not (that would cost a
device-to-host sync per tile).
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import SamplerConfig, validate_max_sample_size
from .convert import resolve_device
from .errors import SamplerClosedError
from .ops import algorithm_l as _algl
from .ops import algorithm_l_cuda as _kernel
from .ops import distinct as _dist
from .ops import distinct_cuda as _dkernel
from .ops import weighted as _wtd
from .ops import weighted_cuda as _wkernel
from .ops.rng import key_from_seed

__all__ = ["ReservoirEngine"]

_TORCH_DTYPES = {
    "int32": torch.int32,
    "float32": torch.float32,
    "uint32": torch.uint32,
}
#: distinct mode's key dtypes: 4-byte (narrow) and 8-byte (wide) integers
_DISTINCT_DTYPES = {
    "int32": torch.int32,
    "uint32": torch.uint32,
    "int64": torch.int64,
    "uint64": torch.uint64,
}

State = Union[_algl.ReservoirState, _wtd.WeightedState, _dist.DistinctState]


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Left out of the first slice', "
        f"{item}); the torch port runs uniform, weighted and distinct modes with "
        "int32 counters on one device"
    )


class ReservoirEngine:
    """R independent k-reservoirs updated in lockstep on one device.

    Args:
      config: engine configuration (k, R, dtypes, tile size); with
        ``weighted=True`` every ``sample`` call takes a ``weights`` tile;
        with ``distinct=True`` the keys are 4- or 8-byte integers.
      key: an int seed (``None`` means 0; the key words of ``jr.key(seed)``)
        or ``[2]`` uint32 key words.
      reusable: single-use engines close on ``result()``; reusable ones
        stay open.
      device: ``None`` means ``"cuda"`` and raises without a card;
        ``"cpu"`` runs the plain torch version.
    """

    def __init__(
        self,
        config: SamplerConfig,
        key: Union[int, Any, None] = None,
        reusable: bool = False,
        *,
        device: Optional[Any] = None,
        map_fn: Any = None,
        hash_fn: Any = None,
        _initial_state: Optional[State] = None,
    ) -> None:
        validate_max_sample_size(config.max_sample_size)
        if config.weighted and config.distinct:
            raise ValueError("weighted and distinct modes are mutually exclusive")
        if config.count_dtype == "wide" or np.dtype(config.count_dtype) != np.int32:
            raise _not_in_slice(f"count_dtype={config.count_dtype!r}", "L3")
        if config.mesh_axis is not None:
            raise _not_in_slice("mesh_axis", "L4")
        if map_fn is not None or hash_fn is not None:
            raise _not_in_slice("map_fn / hash_fn", "L5")
        if config.impl == "xla":
            raise ValueError(
                "impl='xla' is not a production path of the torch port; "
                "'auto' and 'pallas' both run the CUDA kernel"
            )
        dtype_name = np.dtype(config.resolved_sample_dtype()).name
        dtypes = _DISTINCT_DTYPES if config.distinct else _TORCH_DTYPES
        if dtype_name != np.dtype(config.element_dtype).name or dtype_name not in dtypes:
            if config.distinct:
                raise ValueError(
                    "distinct mode requires a 32- or 64-bit integer sample dtype, the "
                    f"same for elements and samples: one of {sorted(dtypes)}, got "
                    f"{config.element_dtype!r} / {config.resolved_sample_dtype()!r}"
                )
            raise ValueError(
                "the torch port stores 4-byte words: element and sample dtype "
                f"must both be one of {sorted(dtypes)}, got "
                f"{config.element_dtype!r} / {config.resolved_sample_dtype()!r}"
            )
        self._config = config
        self._dtype = dtypes[dtype_name]
        self._np_dtype = np.dtype(dtype_name)
        self._wide = self._np_dtype.itemsize == 8
        self._reusable = reusable
        self._open = True
        self._device = resolve_device(device)
        self._ops = _dist if config.distinct else (_wtd if config.weighted else _algl)
        if _initial_state is not None:
            self._state = type(_initial_state)(*_on(_initial_state, lambda t: t.to(self._device)))
        else:
            if key is None or isinstance(key, int):
                words = key_from_seed(0 if key is None else key)
            else:
                words = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))
            self._state = self._ops.init(
                words, config.num_reservoirs, config.max_sample_size,
                sample_dtype=self._dtype, device=self._device,
            )
        # host-side lower bound on every reservoir's count: exact under
        # full tiles, conservative under ragged ones
        self._min_count = 0
        # (pinned buffer, copy event) pairs not yet known to be complete
        self._staging: deque = deque()

    # ------------------------------------------------------------ properties

    @property
    def config(self) -> SamplerConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_open(self) -> bool:
        """Reusable engines are always open; single-use ones close on
        ``result()``."""
        return True if self._reusable else self._open

    @property
    def state(self) -> State:
        """A copy of the state (the CUDA update mutates the live one): a
        ``WeightedState`` in weighted mode, a ``DistinctState`` in distinct
        mode, else a ``ReservoirState``."""
        self._check_open()
        return type(self._state)(*_on(self._state, torch.clone))

    def _check_open(self) -> None:
        if not self._reusable and not self._open:
            raise SamplerClosedError("this engine is single-use, and no longer open")

    # -------------------------------------------------------------- sampling

    def _release_staging(self) -> None:
        while self._staging and self._staging[0][1].query():
            self._staging.popleft()

    def _to_device(self, host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array (already of ``dtype``) as a tensor on the engine's
        device: a snapshot, through a pinned buffer on the card."""
        if self._device.type == "cpu":
            return torch.from_numpy(np.array(host, copy=True))
        self._release_staging()
        pinned = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        pinned.numpy()[...] = host  # the snapshot
        out = pinned.to(self._device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        self._staging.append((pinned, event))
        return out

    def _on_card(self, x: Any, what: str) -> bool:
        """True for a CUDA tensor on the engine's device (used as it is)."""
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            if x.device != self._device:
                raise ValueError(f"{what} is on {x.device}, the engine on {self._device}")
            return True
        return False

    def _tile_to_device(self, tile: Any) -> _dist.Batch:
        """The tile as a contiguous tensor on the engine's device; an 8-byte
        host tile (or its ``(hi, lo)`` planes) as a pair of word planes."""
        if self._on_card(tile, "tile"):
            ok = tile.dtype in _dist.WIDE_DTYPES if self._wide else tile.dtype == self._dtype
            if not ok:
                raise ValueError(f"tile dtype {tile.dtype} != samples dtype {self._dtype}")
            return tile.contiguous()
        if self._wide:
            if not isinstance(tile, tuple):
                tile = _dist.split_values_host(tile.numpy() if isinstance(tile, torch.Tensor) else tile)
            return tuple(self._to_device(plane.view(np.int32), torch.int32) for plane in tile)
        host = tile.numpy() if isinstance(tile, torch.Tensor) else np.asarray(tile)
        if host.dtype != self._np_dtype:
            host = host.astype(self._np_dtype)
        return self._to_device(host, self._dtype)

    def _weights_to_device(
        self, weights: Any, shape: Tuple[int, int], check: bool
    ) -> torch.Tensor:
        """The weights tile as contiguous float32 on the engine's device.
        With ``check``, host weights must be nonnegative (NaN fails the
        check); CUDA weights are taken as they are, with no device-to-host
        sync."""
        if self._on_card(weights, "weights"):
            w = weights.to(torch.float32).contiguous()
        else:
            host = weights.numpy() if isinstance(weights, torch.Tensor) else weights
            host = np.asarray(host, np.float32)
            if check and not np.all(host >= 0):
                raise ValueError("weights must be nonnegative")
            w = host
        if tuple(w.shape) != shape:
            raise ValueError(f"weights must match tile shape {shape}, got {tuple(w.shape)}")
        return w if isinstance(w, torch.Tensor) else self._to_device(w, torch.float32)

    def sample(self, tile: Any, valid: Optional[Any] = None, weights: Optional[Any] = None) -> None:
        """Consume one ``[R, B]`` tile; ``valid`` (``[R]``, host) lets row
        ``r`` take only ``tile[r, :valid[r]]``.  A weighted engine requires
        ``weights``, a nonnegative ``[R, B]`` tile (a zero weight is counted
        and never sampled); an unweighted one rejects them."""
        if isinstance(tile, tuple):
            raise ValueError("tile must be one [num_reservoirs, B] array, not a tuple")
        self._sample(tile, valid, weights, check_weights=True)

    def _sample(self, tile: Any, valid: Optional[Any], weights: Optional[Any],
                check_weights: bool) -> None:
        self._check_open()
        R = self._config.num_reservoirs
        # a tuple is the (hi, lo) word planes of an 8-byte stream's tile
        first = tile[0] if isinstance(tile, tuple) else tile
        shape = tuple(first.shape) if hasattr(first, "shape") else np.shape(first)
        if len(shape) != 2 or shape[0] != R:
            raise ValueError(f"tile must be [num_reservoirs={R}, B], got {shape}")
        if self._config.weighted and weights is None:
            raise ValueError("weighted engine requires a weights tile")
        if not self._config.weighted and weights is not None:
            raise ValueError("weights are only meaningful with weighted=True")
        width = shape[1]
        valid_dev = None
        if valid is not None:
            if isinstance(valid, torch.Tensor):
                valid = valid.cpu().numpy()
            valid_np = np.array(valid, np.int32, copy=True)
            if valid_np.shape != (R,):
                raise ValueError(f"valid must be [{R}], got {valid_np.shape}")
            if np.any(valid_np < 0) or np.any(valid_np > width):
                raise ValueError(
                    f"valid entries must be in [0, {width}], got "
                    f"[{valid_np.min()}, {valid_np.max()}]"
                )
            valid_dev = torch.from_numpy(valid_np).to(self._device)
        w_dev = None
        if self._config.weighted:
            w_dev = self._weights_to_device(weights, (R, width), check_weights)
        batch = self._tile_to_device(tile)
        if self._config.weighted:
            self._state = _wkernel.update_cuda(self._state, batch, w_dev, valid_dev)
        elif self._config.distinct:
            self._state = _dkernel.update_cuda(self._state, batch, valid_dev)
        else:
            steady = self._min_count >= self._config.max_sample_size
            fn = _kernel.update_steady_cuda if steady else _kernel.update_cuda
            self._state = fn(self._state, batch, valid_dev)
        self._min_count += width if valid is None else int(valid_np.min())

    def sample_all(self, tiles: Any) -> None:
        """Consume an iterable of items: ``tile`` or ``(tile, valid)`` when
        unweighted, ``(tile, weights)`` or ``(tile, weights, valid)`` when
        weighted.  An error names the offending item."""
        self._check_open()
        for i, item in enumerate(tiles):
            try:
                if not isinstance(item, tuple):
                    self.sample(item)
                elif self._config.weighted:
                    self.sample(item[0], valid=item[2] if len(item) > 2 else None,
                                weights=item[1] if len(item) > 1 else None)
                else:
                    self.sample(item[0], valid=item[1] if len(item) > 1 else None)
            except (TypeError, ValueError) as e:
                raise type(e)(f"tiles[{i}]: {e}") from None

    def sample_stream(
        self,
        stream: Any,
        tile_width: Optional[int] = None,
        weights: Optional[Any] = None,
        fused: bool = False,
    ) -> None:
        """Feed one ``[R, N]`` array (numpy or a tensor) in tiles of
        ``tile_width`` (default ``config.tile_size``) columns; the ragged
        tail is padded and masked through ``valid``.  A weighted engine
        takes a parallel ``[R, N]`` ``weights`` array, checked whole before
        any tile is consumed; its padding has weight 1.0.  A host stream of
        8-byte distinct keys is split into word planes once, not per tile."""
        self._check_open()
        if fused:
            raise _not_in_slice("sample_stream(fused=True)", "L7")
        if not isinstance(stream, torch.Tensor):
            stream = np.asarray(stream)
        R, N = stream.shape
        planes = None
        if self._wide and not isinstance(stream, torch.Tensor):
            planes = _dist.split_values_host(stream)
        if self._config.weighted:
            if weights is None:
                raise ValueError("weighted engine requires a weights array")
            if not isinstance(weights, torch.Tensor):
                weights = np.asarray(weights, np.float32)
            if tuple(weights.shape) != (R, N):
                raise ValueError(
                    f"weights must match stream shape {(R, N)}, got {tuple(weights.shape)}"
                )
            # the whole array, before any tile: a bad weight in tile i must
            # not leave tiles 0..i-1 already in the state
            if not bool((weights >= 0).all()):
                raise ValueError("weights must be nonnegative")
        elif weights is not None:
            raise ValueError("weights are only meaningful with weighted=True")
        B = tile_width or self._config.tile_size
        for start in range(0, N, B):
            cols = slice(start, start + B)
            chunk = stream[:, cols] if planes is None else tuple(p[:, cols] for p in planes)
            wchunk = weights[:, cols] if weights is not None else None
            w = min(B, N - start)
            valid = None
            if w < B:
                chunk = _pad(chunk, B, 0) if planes is None else tuple(_pad(p, B, 0) for p in chunk)
                if wchunk is not None:
                    # weight 1.0 keeps the contract; valid masks it out
                    wchunk = _pad(wchunk, B, 1)
                valid = np.full((R,), w, np.int32)
            self._sample(chunk, valid, wchunk, check_weights=False)

    def sample_gated(self, tile: Any, nvalid: Any, advance: Any) -> None:
        raise _not_in_slice("sample_gated", "L6")

    def reset_rows(self, rows: Any, key: Any) -> None:
        raise _not_in_slice("reset_rows", "L8")

    def export_rows(self, rows: Any):
        raise _not_in_slice("export_rows", "L8")

    def adopt_rows(self, rows: Any, sub_state: Any) -> None:
        raise _not_in_slice("adopt_rows", "L8")

    # ----------------------------------------------------------- checkpoints

    def save(self, path: str, metadata: Optional[dict] = None) -> None:
        """Checkpoint state and config to ``path`` (atomic ``.npz``, the JAX
        package's format)."""
        from .utils.checkpoint import save_engine

        save_engine(path, self, metadata=metadata)

    @classmethod
    def restore(cls, path: str, *, device: Optional[Any] = None) -> "ReservoirEngine":
        """Rebuild a checkpointed engine (from either package) on ``device``."""
        from .utils.checkpoint import load_engine

        return load_engine(path, engine_cls=cls, device=device)

    # --------------------------------------------------------------- results

    def _host_result(self) -> Tuple[np.ndarray, np.ndarray]:
        samples, sizes = self._ops.result(self._state)
        if self._config.distinct:
            samples = _dist.assemble_values(samples, self._state.value_hi, self._np_dtype)
            return samples, sizes.cpu().numpy()
        return samples.cpu().numpy(), sizes.cpu().numpy()

    def result_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(samples [R, k], sizes [R])`` on the host; entries at or past a
        row's size are zeros.  A weighted row's size is its number of filled
        slots; a distinct row holds its values in hash order, 8-byte keys
        reassembled.  A single-use engine closes and frees its device
        state."""
        self._check_open()
        out = self._host_result()
        if not self._reusable:
            self._open = False
            self._state = None
            self._staging.clear()
        return out

    def peek_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`result_arrays` that leaves the engine open."""
        self._check_open()
        return self._host_result()

    def result(self) -> List[np.ndarray]:
        """Per-reservoir samples, truncated to their fill level."""
        samples, sizes = self.result_arrays()
        return [samples[r, : sizes[r]] for r in range(samples.shape[0])]


def _on(state: State, fn) -> list:
    """``fn`` applied to each field of ``state``; an absent (None) field
    stays None."""
    return [None if t is None else fn(t) for t in state]


def _pad(chunk: Any, width: int, value: int) -> Any:
    """``chunk`` (numpy or a tensor) padded on the right to ``width``
    columns of zeros (``value=0``) or ones (``value=1``)."""
    R, w = chunk.shape
    if isinstance(chunk, torch.Tensor):
        make = torch.ones if value else torch.zeros
        pad = make((R, width - w), dtype=chunk.dtype, device=chunk.device)
        return torch.cat([chunk, pad], dim=1)
    make = np.ones if value else np.zeros
    return np.concatenate([chunk, make((R, width - w), chunk.dtype)], axis=1)
