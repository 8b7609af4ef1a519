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
distinct tile through that of :mod:`~reservoir_tpu_torch.ops.distinct_cuda`,
and every pre-gated candidate tile of the skip gate (:meth:`ReservoirEngine.sample_gated`)
through ``algl_update_gated``; with ``device="cpu"`` the same wrappers run the plain torch versions.  There
is no other path and no fallback: a build or launch failure raises.  In
uniform mode a host-side lower bound on every reservoir's count (no device
read) decides between the fill-capable and the steady update, as in the JAX
engine; a weighted tile always takes the fill-capable kernel, because a
zero-weight item is counted without taking a slot.

Uniform mode takes ``count_dtype="int32"`` or ``"wide"``: WIDE counters are
``[R, 2]`` uint32 (lo, hi) words, so a row's stream can pass 2^31 (where
int32 counters saturate and sampling stops) and 2^32; their tiles go
through ``algl_update_wide``.  ``"uint32"`` and ``"int64"`` raise
``ValueError``: the JAX package's engine cannot build the first, and gives
the second int32 counters unless x64 is on globally.

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

The reference's hooks (:mod:`~reservoir_tpu_torch.ops.hooks`, elementwise
functions on torch tensors): ``map_fn`` applies on accept in uniform and
weighted mode and to every element in distinct mode, and the samples
take its results in the sample dtype, which may then differ from the
element dtype; ``hash_fn`` (distinct mode) gives the pre-scramble hash
words.  A hooked engine ships its tiles in the element dtype, whole (8-byte
keys are not split into planes); on the card the kernel wrappers map the
tile, hash it and launch the kernels on the results (the distinct kernel's
pre-hashed instantiation under either hook), and with ``device="cpu"``
the plain versions apply the hooks as the reference does.

:meth:`ReservoirEngine.sample_stream` takes the reference's ``fused=True``
and feeds the stream tile by tile all the same: one launch a tile, as the
reference's fused scan runs one update a tile, so the same state bit for
bit.

With ``config.mesh_axis`` the reservoirs are sharded over the ranks of a
:class:`~reservoir_tpu_torch.parallel.sharded.Mesh` (default: every
visible card): rank ``i`` of ``n`` holds rows ``[i R/n, (i+1) R/n)`` on its
device.  A host tile is snapshotted once into a pinned buffer and each
rank's row block copied to its card without blocking (the buffer is held
until the copy to every card has run); a tile on a rank's card is split
with ``.to(rank)``; ``valid`` is split by rank, the fill lower bound stays
global.  Each rank's block then goes through the mode's kernel, one launch
a rank a tile.  A meshed engine is bit-identical to the unmeshed one with
the same key, and its rows read back in order.  An unmeshed engine is the
one-rank case of the same code.

A mesh may span the processes of a ``torch.distributed`` group
(:func:`~reservoir_tpu_torch.parallel.make_mesh` after
``multihost.initialize``): every process builds the engine and passes the
same global tiles, and each ships and updates only the rows of the ranks
it owns.  Reading the rows (``state``, ``result``, ``result_arrays``,
``peek_arrays``, ``export_rows``) gathers them onto the process's first
rank and across the group through ``torch.distributed``, so every process
makes the same call and gets every row.  A checkpoint of
such an engine, and a bridge over it, raise ``NotImplementedError`` naming
L4.
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
from .ops import weighted as _wtd
from .ops.rng import key_from_seed
from .parallel.sharded import Mesh, RowSharding, gather_state, make_mesh, not_ported, rank_update, shard_state

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
#: element dtypes a map takes in any mode: 4- and 8-byte words
_ELEMENT_DTYPES = {**_TORCH_DTYPES, **_DISTINCT_DTYPES}

State = Union[_algl.ReservoirState, _wtd.WeightedState, _dist.DistinctState]


class ReservoirEngine:
    """R independent k-reservoirs updated in lockstep on one device, or
    sharded over the ranks of a mesh.

    Args:
      config: engine configuration (k, R, dtypes, tile size); with
        ``weighted=True`` every ``sample`` call takes a ``weights`` tile;
        with ``distinct=True`` the keys are 4- or 8-byte integers.
      key: an int seed (``None`` means 0; the key words of ``jr.key(seed)``)
        or ``[2]`` uint32 key words.
      reusable: single-use engines close on ``result()``; reusable ones
        stay open.
      device: ``None`` means ``"cuda"`` and raises without a card;
        ``"cpu"`` runs the plain torch version.  Not with a mesh.
      mesh: the ranks the reservoirs shard over, with ``config.mesh_axis``
        only; defaults to :func:`~reservoir_tpu_torch.parallel.make_mesh`
        over every visible card.  ``make_mesh(devices=["cpu"] * n)`` runs
        the plain versions on CPU ranks.
      map_fn: an elementwise map on torch tensors
        (:mod:`~reservoir_tpu_torch.ops.hooks`), applied on accept
        (uniform, weighted) or to every element (distinct); its results are
        cast to the sample dtype.
      hash_fn: distinct mode only: an elementwise hash of the mapped keys
        returning ``(hi, lo)`` integer words.
    """

    def __init__(
        self,
        config: SamplerConfig,
        key: Union[int, Any, None] = None,
        reusable: bool = False,
        *,
        device: Optional[Any] = None,
        mesh: Optional[Mesh] = None,
        map_fn: Any = None,
        hash_fn: Any = None,
        _initial_state: Optional[State] = None,
    ) -> None:
        validate_max_sample_size(config.max_sample_size)
        if config.weighted and config.distinct:
            raise ValueError("weighted and distinct modes are mutually exclusive")
        if hash_fn is not None and not config.distinct:
            raise ValueError("hash_fn is only meaningful with distinct=True")
        wide_counts = _check_count_dtype(config.count_dtype)
        if config.impl == "pallas":
            if map_fn is not None:
                raise ValueError("impl='pallas' requires an identity map_fn")
            if wide_counts:
                raise ValueError(
                    "impl='pallas' requires int32 counters (the kernel's "
                    "supports() contract); count_dtype='wide' dispatches "
                    "XLA — use impl='auto'"
                )
            if hash_fn is not None:
                raise ValueError(
                    "impl='pallas' requires the default hash (the kernel "
                    "owns the value-bits embedding); use impl='auto'"
                )
        if config.mesh_axis is not None:
            if device is not None:
                raise ValueError(
                    "device pinning and mesh sharding are mutually exclusive "
                    "(a pinned engine lives on one chip)"
                )
            mesh = mesh if mesh is not None else make_mesh(axis=config.mesh_axis)
            n_shards = mesh.shape[config.mesh_axis]
            if config.num_reservoirs % n_shards != 0:
                raise ValueError(
                    f"num_reservoirs={config.num_reservoirs} must divide "
                    f"evenly over the {n_shards}-device '{config.mesh_axis}' "
                    "mesh axis"
                )
        elif mesh is not None:
            raise ValueError("mesh requires config.mesh_axis to be set")
        if config.impl == "xla":
            raise ValueError(
                "impl='xla' is not a production path of the torch port; "
                "'auto' and 'pallas' both run the CUDA kernel"
            )
        dtype_name = np.dtype(config.resolved_sample_dtype()).name
        elem_name = np.dtype(config.element_dtype).name
        dtypes = _DISTINCT_DTYPES if config.distinct else _TORCH_DTYPES
        if dtype_name not in dtypes or (map_fn is None and elem_name != dtype_name):
            if config.distinct:
                raise ValueError(
                    "distinct mode requires a 32- or 64-bit integer sample dtype, the "
                    f"same for elements and samples without a map_fn: one of {sorted(dtypes)}, "
                    f"got {config.element_dtype!r} / {config.resolved_sample_dtype()!r}"
                )
            raise ValueError(
                "the torch port stores 4-byte words: element and sample dtype "
                f"must both be one of {sorted(dtypes)} (the same without a map_fn), got "
                f"{config.element_dtype!r} / {config.resolved_sample_dtype()!r}"
            )
        if elem_name not in _ELEMENT_DTYPES:
            raise ValueError(
                f"a map_fn takes elements of one of {sorted(_ELEMENT_DTYPES)}, got "
                f"{config.element_dtype!r}"
            )
        self._config = config
        self._map_fn = map_fn
        self._hash_fn = hash_fn
        #: the hooks see whole tiles in the element dtype
        self._hooked = map_fn is not None or hash_fn is not None
        self._dtype = dtypes[dtype_name]
        self._np_dtype = np.dtype(dtype_name)
        self._elem_dtype = _ELEMENT_DTYPES[elem_name]
        self._np_elem = np.dtype(elem_name)
        self._wide = self._np_dtype.itemsize == 8
        self._reusable = reusable
        self._open = True
        self._ops = _dist if config.distinct else (_wtd if config.weighted else _algl)
        self._mesh = mesh
        self._device = None if mesh is not None else resolve_device(device)
        # an unmeshed engine is the one-rank case
        ranks = mesh if mesh is not None else Mesh([self._device])
        #: each rank's device and rows (the ranks this process owns)
        self._blocks = RowSharding(ranks, ranks.axis_names[0]).local_blocks(config.num_reservoirs)
        self._ranks = [b.device for b in self._blocks]
        #: the cards the ranks are on (none on CPU ranks), in rank order
        self._cards = list(dict.fromkeys(d for d in self._ranks if d.type == "cuda"))
        if _initial_state is not None:
            # copies: row operations and the kernels write the state in place
            self._shards = shard_state(_initial_state, ranks, ranks.axis_names[0])
        else:
            state = self._ops.init(
                _key_words(key), config.num_reservoirs, config.max_sample_size,
                sample_dtype=self._dtype, device=self._ranks[0], **self._count_arg(),
            )
            self._shards = [state] if mesh is None else shard_state(state, mesh, mesh.axis_names[0])
        # host-side lower bound on every reservoir's count: exact under
        # full tiles, conservative under ragged ones
        self._min_count = 0
        # (pinned buffer, [copy event a card]) pairs not yet known to be
        # complete
        self._staging: deque = deque()
        #: row resets and adoptions applied so far.  The skip gate keys its
        #: replica's staleness on it.
        self.reset_epochs = 0

    # ------------------------------------------------------------ properties

    @property
    def config(self) -> SamplerConfig:
        return self._config

    @property
    def device(self) -> Optional[torch.device]:
        """The engine's device (``None`` for a meshed engine)."""
        return self._device

    @property
    def mesh(self) -> Optional[Mesh]:
        """The mesh the reservoirs shard over (``None`` unmeshed)."""
        return self._mesh

    @property
    def is_open(self) -> bool:
        """Reusable engines are always open; single-use ones close on
        ``result()``."""
        return True if self._reusable else self._open

    @property
    def _multiprocess(self) -> bool:
        """Whether the mesh spans processes (its rows are read through a
        collective)."""
        return self._mesh is not None and self._mesh.multiprocess

    @property
    def _state(self) -> State:
        """The live state of an unmeshed engine; a meshed engine's rows
        gathered in order onto its first rank's device (over a mesh that
        spans processes, a collective)."""
        if len(self._shards) == 1 and not self._multiprocess:
            return self._shards[0]
        return gather_state(self._shards, self._ranks[0], self._mesh)

    @property
    def state(self) -> State:
        """A copy of the state (the CUDA update mutates the live one), rows
        in order on the engine's (first rank's) device: a ``WeightedState``
        in weighted mode, a ``DistinctState`` in distinct mode, else a
        ``ReservoirState``."""
        self._check_open()
        if len(self._shards) > 1:
            return self._state
        return type(self._state)(*_on(self._state, torch.clone))

    def _count_arg(self) -> dict:
        """The uniform ``init``'s ``count_dtype`` argument (none for the
        other modes, whose counters are int32)."""
        return {"count_dtype": self._config.count_dtype} if self._ops is _algl else {}

    def _synchronize(self) -> None:
        """Wait for the work queued on every rank's card (none on CPU
        ranks)."""
        for card in self._cards:
            torch.cuda.current_stream(card).synchronize()

    def _check_open(self) -> None:
        if not self._reusable and not self._open:
            raise SamplerClosedError("this engine is single-use, and no longer open")

    # -------------------------------------------------------------- sampling

    def _release_staging(self) -> None:
        while self._staging and all(e.query() for e in self._staging[0][1]):
            self._staging.popleft()

    def _to_device(self, host: np.ndarray, dtype: torch.dtype) -> List[torch.Tensor]:
        """A host array (already of ``dtype``) as one row block a rank on
        its device: a snapshot, through a pinned buffer on the card."""
        buf = self._host_buffer(host.shape, dtype)
        buf.numpy()[...] = host  # the snapshot
        return self._ship(buf)

    def _host_buffer(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A fresh host buffer for :meth:`_ship`: pinned on the card."""
        if not self._cards:
            return torch.empty(shape, dtype=dtype)
        self._release_staging()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _ship(self, buf: torch.Tensor, split: bool = True) -> List[torch.Tensor]:
        """A filled :meth:`_host_buffer` as each rank's row block on its
        device (``split=False``: the whole buffer on the one rank's): one
        ``non_blocking`` copy a rank on the card, the buffer held until
        every card has run its copies (an event a card)."""
        cuts = ([(b.device, slice(b.start, b.stop)) for b in self._blocks] if split
                else [(self._ranks[0], slice(None))])
        if not self._cards:
            return [buf[rows] for _, rows in cuts]
        out = [buf[rows].to(dev, non_blocking=True) for dev, rows in cuts]
        events = []
        for card in self._cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(card))
            events.append(event)
        self._staging.append((buf, events))
        return out

    def _on_card(self, x: Any, what: str) -> bool:
        """True for a CUDA tensor on a rank's card (used as it is, split by
        rank)."""
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            if x.device not in self._cards:
                where = self._device if self._mesh is None else [str(c) for c in self._cards]
                raise ValueError(f"{what} is on {x.device}, the engine on {where}")
            return True
        return False

    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A tensor on a rank's card as one contiguous row block a rank,
        each moved to its rank's device (a view where it is there)."""
        return [t[b.start:b.stop].to(b.device).contiguous() for b in self._blocks]

    def _tile_to_device(self, tile: Any) -> List[_dist.Batch]:
        """The tile as one contiguous row block a rank on its device; an
        8-byte host tile (or its ``(hi, lo)`` planes) as pairs of word
        planes.  A hooked engine's tile stays whole, in the element dtype."""
        if self._hooked:
            if self._on_card(tile, "tile"):
                if tile.dtype != self._elem_dtype:
                    raise ValueError(f"tile dtype {tile.dtype} != element dtype {self._elem_dtype}")
                return self._split(tile)
            host = tile.numpy() if isinstance(tile, torch.Tensor) else np.asarray(tile)
            if host.dtype != self._np_elem:
                host = host.astype(self._np_elem)
            return self._to_device(host, self._elem_dtype)
        if self._on_card(tile, "tile"):
            ok = tile.dtype in _dist.WIDE_DTYPES if self._wide else tile.dtype == self._dtype
            if not ok:
                raise ValueError(f"tile dtype {tile.dtype} != samples dtype {self._dtype}")
            return self._split(tile)
        if self._wide:
            if not isinstance(tile, tuple):
                tile = _dist.split_values_host(tile.numpy() if isinstance(tile, torch.Tensor) else tile)
            planes = [self._to_device(plane.view(np.int32), torch.int32) for plane in tile]
            return list(zip(*planes))
        host = tile.numpy() if isinstance(tile, torch.Tensor) else np.asarray(tile)
        if host.dtype != self._np_dtype:
            host = host.astype(self._np_dtype)
        return self._to_device(host, self._dtype)

    def _weights_to_device(
        self, weights: Any, shape: Tuple[int, int], check: bool
    ) -> List[torch.Tensor]:
        """The weights tile as contiguous float32 row blocks, one a rank.
        With ``check``, host weights must be nonnegative (NaN fails the
        check); CUDA weights are taken as they are, with no device-to-host
        sync."""
        if self._on_card(weights, "weights"):
            w = weights.to(torch.float32)
        else:
            host = weights.numpy() if isinstance(weights, torch.Tensor) else weights
            host = np.asarray(host, np.float32)
            if check and not np.all(host >= 0):
                raise ValueError("weights must be nonnegative")
            w = host
        if tuple(w.shape) != shape:
            raise ValueError(f"weights must match tile shape {shape}, got {tuple(w.shape)}")
        return self._split(w) if isinstance(w, torch.Tensor) else self._to_device(w, torch.float32)

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
        valid_dev = [None] * len(self._blocks)
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
            valid_dev = [torch.from_numpy(valid_np[b.start:b.stop]).to(b.device) for b in self._blocks]
        extra = [valid_dev]
        if self._config.weighted:
            extra.insert(0, self._weights_to_device(weights, (R, width), check_weights))
        batch = self._tile_to_device(tile)
        steady = self._ops is _algl and self._min_count >= self._config.max_sample_size
        fn = rank_update(self._ops, steady)
        hooks = {"map_fn": self._map_fn}
        if self._config.distinct:
            hooks["hash_fn"] = self._hash_fn
        # one launch a rank: each rank's block on its own device
        self._shards = [fn(st, *args, **hooks) for st, *args in zip(self._shards, batch, *extra)]
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
        8-byte distinct keys is split into word planes once, not per tile.

        ``fused=True`` (the reference's fused stream, one scan over the
        full tiles) is taken for the reference's signature and runs the
        same per-tile launches, which give the fused scan's state bit for
        bit."""
        self._check_open()
        if isinstance(stream, torch.Tensor) and stream.device.type == "cpu":
            stream = stream.numpy()
        if not isinstance(stream, torch.Tensor):
            stream = np.asarray(stream)
        R, N = stream.shape
        planes = None
        if self._wide and not self._hooked and not isinstance(stream, torch.Tensor):
            planes = _dist.split_values_host(stream)
        if self._config.weighted:
            if weights is None:
                raise ValueError("weighted engine requires a weights array")
            if isinstance(weights, torch.Tensor) and weights.device.type == "cpu":
                weights = weights.numpy()
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
        """Consume one pre-gated ``[R, Bg]`` candidate tile.

        The skip gate (:mod:`reservoir_tpu_torch.stream.gate`) ships only
        the elements that can win: row ``r`` advances by ``advance[r]``
        logical elements, of which the ``nvalid[r]`` candidates in
        ``tile[r, :nvalid[r]]`` (fill prefix, then every acceptance, in
        order) were shipped.  Bit-identical to :meth:`sample` over the
        full tiles (:func:`~.ops.algorithm_l.update_gated`).

        Duplicates mode with int32 counters on an unmeshed engine only, the
        :func:`~reservoir_tpu_torch.stream.gate.gate_ineligible_reason`
        contract.  The host tile (a numpy array, a list or a CPU tensor, of
        the element dtype), ``nvalid`` and ``advance`` are snapshotted into
        one pinned buffer and copied to the card in one ``non_blocking``
        copy, then ``algl_update_gated`` runs once (the plain version with
        ``device="cpu"``), on the candidates mapped by the engine's
        ``map_fn`` where it has one.
        """
        self._check_open()
        if self._ops is not _algl:
            raise ValueError(
                "sample_gated requires duplicates mode (the skip gate "
                "replicates the Algorithm-L recursion only)"
            )
        count = self._shards[0].count
        if count.ndim != 1 or count.dtype != torch.int32:
            raise ValueError("sample_gated requires narrow int32 counters")
        if self._mesh is not None:
            raise ValueError("sample_gated does not support meshed engines")
        R = self._config.num_reservoirs
        host = tile.numpy() if isinstance(tile, torch.Tensor) else tile
        tile_host = np.asarray(host, dtype=self._np_elem)
        if tile_host.ndim != 2 or tile_host.shape[0] != R:
            raise ValueError(f"gated tile must be [num_reservoirs={R}, Bg], got {tile_host.shape}")
        bg = tile_host.shape[1]
        nvalid_np = np.asarray(nvalid, np.int32)
        advance_np = np.asarray(advance, np.int32)
        if nvalid_np.shape != (R,) or advance_np.shape != (R,):
            raise ValueError(
                f"nvalid/advance must be [{R}], got {nvalid_np.shape} / {advance_np.shape}"
            )
        if np.any(nvalid_np < 0) or np.any(nvalid_np > bg):
            raise ValueError(
                f"nvalid entries must be in [0, {bg}], got "
                f"[{nvalid_np.min()}, {nvalid_np.max()}]"
            )
        if np.any(advance_np < 0):
            raise ValueError("advance entries must be nonnegative")
        # one buffer, one copy: nvalid, advance, then the tile's words,
        # written straight into it (the snapshot: the caller may reuse its
        # arrays at once)
        packed_host = self._host_buffer((2 * R + R * bg * self._np_elem.itemsize // 4,), torch.int32)
        words = packed_host.numpy()
        words[:R] = nvalid_np
        words[R:2 * R] = advance_np
        words[2 * R:].view(self._np_elem).reshape(R, bg)[...] = tile_host
        min_advance = int(advance_np.min())
        (packed,) = self._ship(packed_host, split=False)
        nv_dev, adv_dev = packed[:R], packed[R:2 * R]
        batch = packed[2 * R:].view(self._elem_dtype).view(R, bg)
        self._shards[0] = _kernel.update_gated_cuda(self._shards[0], batch, nv_dev, adv_dev, self._map_fn)
        self._min_count += min_advance

    # ------------------------------------------------------------ row leasing

    def _validate_rows(self, rows: Any) -> np.ndarray:
        """``rows`` as a non-empty 1-D int32 index array within ``[0, R)``,
        with the reference's ``ValueError``s."""
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu()
        rows = np.asarray(rows, np.int32)
        if rows.ndim != 1 or rows.size == 0:
            raise ValueError(f"rows must be a non-empty 1-D index array, got shape {rows.shape}")
        R = self._config.num_reservoirs
        if int(rows.min()) < 0 or int(rows.max()) >= R:
            bad = int(rows[np.argmax((rows < 0) | (rows >= R))])
            raise ValueError(f"row {bad} out of range [0, {R})")
        return rows

    def _scatter(self, rows: np.ndarray, part: State) -> None:
        """Write row ``i`` of ``part`` (on any device) over row ``rows[i]``
        of every state field, in place, on the rank that holds it.  Where a
        row repeats, its last occurrence wins (as the reference's scatter
        gives on XLA): only that one is written, so the result does not
        depend on the order of the card's writes."""
        last = rows.size - 1 - np.unique(rows[::-1], return_index=True)[1]
        if last.size == rows.size:  # no repeats: every position, in order
            last = np.arange(rows.size)
        rows = rows[last]
        for b, shard in zip(self._blocks, self._shards):
            mine = (rows >= b.start) & (rows < b.stop)
            if not mine.any():
                continue
            # the part's rows this rank takes, unless it takes all in order
            take = None if mine.all() and last.size == part[0].shape[0] else last[mine]
            idx = torch.from_numpy((rows[mine] - b.start).astype(np.int64)).to(b.device)
            for full, one in zip(shard, part):
                if full is not None:
                    one = _signed(one)
                    if take is not None:
                        one = one.index_select(0, torch.from_numpy(take).to(one.device))
                    _signed(full).index_copy_(0, idx, one.to(b.device))
        self._min_count = 0
        self.reset_epochs += 1

    def reset_rows(self, rows: Any, key: Any) -> None:
        """Re-initialize the given rows to empty reservoirs with fresh
        randomness from ``key`` (an int seed, or ``[2]`` uint32 key words,
        as :meth:`SessionTable.sub_key <reservoir_tpu_torch.serve.sessions.SessionTable.sub_key>`
        derives them): the serving plane's session recycling.

        ``init(key, len(rows), k)`` is scattered over ``rows`` (each on the
        rank that holds it); every other row's stream continues
        bit-identically.  The uniform ``init`` rounds as the reference's
        compiled reset does (``compiled=True``).  The fill lower bound drops
        to 0 and :attr:`reset_epochs` counts the reset.  Single writer, as
        :meth:`sample`: a caller with a pipelined bridge drains it first.
        """
        self._check_open()
        rows = self._validate_rows(rows)
        extra = {"compiled": True, **self._count_arg()} if self._ops is _algl else {}
        part = self._ops.init(
            _key_words(key), int(rows.size), self._config.max_sample_size,
            sample_dtype=self._dtype, device=self._ranks[0], **extra,
        )
        self._scatter(rows, part)

    def export_rows(self, rows: Any) -> State:
        """The whole state of ``rows`` (samples, counters and per-row keys)
        as the mode's state class with leading axis ``len(rows)``, in fresh
        tensors on the engine's (first rank's) device: the source half of a
        live migration.  :meth:`adopt_rows` on an engine of the same config
        continues the rows bit-identically."""
        self._check_open()
        rows = self._validate_rows(rows)
        home = self._ranks[0]
        if self._multiprocess:  # every row, through the collective
            idx = torch.from_numpy(rows.astype(np.int64)).to(home)
            return type(self._shards[0])(*_on(self._state, lambda t: _signed(t).index_select(0, idx).view(t.dtype)))
        if len(self._shards) == 1:
            idx = torch.from_numpy(rows.astype(np.int64)).to(home)
            return type(self._shards[0])(
                *_on(self._shards[0], lambda t: _signed(t).index_select(0, idx).view(t.dtype)))
        per = self._blocks[0].stop
        rank_of = rows // per
        out = [None if t is None else torch.empty((rows.size,) + tuple(t.shape[1:]),
                                                  dtype=_signed(t).dtype, device=home)
               for t in self._shards[0]]
        for r in np.unique(rank_of):
            pos = np.flatnonzero(rank_of == r)
            b = self._blocks[r]
            local = torch.from_numpy((rows[pos] - b.start).astype(np.int64)).to(b.device)
            at = torch.from_numpy(pos.astype(np.int64)).to(home)
            for o, t in zip(out, self._shards[r]):
                if o is not None:
                    o.index_copy_(0, at, _signed(t).index_select(0, local).to(home))
        return type(self._shards[0])(
            *(None if o is None else o.view(t.dtype) for o, t in zip(out, self._shards[0])))

    def adopt_rows(self, rows: Any, sub_state: State) -> None:
        """Scatter an :meth:`export_rows` sub-state (of this or another
        engine of the same config, on any device, or one ``convert.py``
        made from the JAX package's export) over ``rows``.  Like a reset,
        it drops the fill lower bound and counts in :attr:`reset_epochs`,
        so a skip gate re-pulls its replica."""
        self._check_open()
        rows = self._validate_adopt(rows, sub_state)
        self._scatter(rows, sub_state)

    def _validate_adopt(self, rows: Any, sub_state: State) -> np.ndarray:
        """The checks of :meth:`adopt_rows` (the rows, and the sub-state's
        class, leading axis, dtypes and row shapes); returns the rows."""
        rows = self._validate_rows(rows)
        like = self._shards[0]
        if type(sub_state) is not type(like):
            raise ValueError(
                f"sub_state is a {type(sub_state).__name__}; this engine holds a "
                f"{type(like).__name__}"
            )
        lead = {int(t.shape[0]) for t in sub_state if t is not None}
        if lead != {int(rows.size)}:
            raise ValueError(f"sub_state leading axis {sorted(lead)} does not match {rows.size} rows")
        for name, full, one in zip(like._fields, like, sub_state):
            if (full is None) != (one is None) or (
                full is not None and (one.dtype != full.dtype or one.shape[1:] != full.shape[1:])
            ):
                raise ValueError(
                    f"sub_state field {name!r} does not match the engine's: "
                    f"{None if one is None else (one.dtype, tuple(one.shape[1:]))} vs "
                    f"{None if full is None else (full.dtype, tuple(full.shape[1:]))}"
                )
        return rows

    # ----------------------------------------------------------- checkpoints

    def save(self, path: str, metadata: Optional[dict] = None) -> None:
        """Checkpoint state and config to ``path`` (atomic ``.npz``, the JAX
        package's format; a meshed engine's rows in order, so either package
        restores it on any mesh its rows divide over)."""
        from .utils.checkpoint import save_engine

        if self._multiprocess:
            raise not_ported("a checkpoint")
        save_engine(path, self, metadata=metadata)

    @classmethod
    def restore(cls, path: str, *, device: Optional[Any] = None, mesh: Optional[Mesh] = None,
                map_fn: Any = None, hash_fn: Any = None) -> "ReservoirEngine":
        """Rebuild a checkpointed engine (from either package) on ``device``,
        or, for a config with ``mesh_axis``, sharded over ``mesh`` (default
        every visible card).  Hooks are code, not data: pass those the
        engine was saved with, or the reference's ``ValueError`` is
        raised."""
        from .utils.checkpoint import load_engine

        return load_engine(path, engine_cls=cls, device=device, mesh=mesh, map_fn=map_fn,
                           hash_fn=hash_fn)

    # --------------------------------------------------------------- results

    def _host_result(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._multiprocess:  # every row, through the collective
            wide = self._config.distinct and self._wide
            leaves = [(*self._ops.result(st),) + ((st.value_hi,) if wide else ()) for st in self._shards]
            got = [t.cpu().numpy() for t in gather_state(leaves, self._ranks[0], self._mesh)]
            samples, sizes = got[0], got[1]
            if self._config.distinct:
                samples = _dist.assemble_values(samples, got[2] if wide else None, self._np_dtype)
            return samples, sizes
        parts = [self._ops.result(st) for st in self._shards]
        samples = _host_rows([p[0] for p in parts])
        sizes = _host_rows([p[1] for p in parts])
        if self._config.distinct:
            hi = None if not self._wide else _host_rows([st.value_hi for st in self._shards])
            samples = _dist.assemble_values(samples, hi, self._np_dtype)
        return samples, sizes

    def result_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(samples [R, k], sizes [R])`` on the host, rows in order; entries
        at or past a row's size are zeros.  A weighted row's size is its
        number of filled slots; a distinct row holds its values in hash
        order, 8-byte keys reassembled.  A single-use engine closes and
        frees its device state."""
        self._check_open()
        out = self._host_result()
        if not self._reusable:
            self._open = False
            self._shards = None
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


def _check_count_dtype(count_dtype: Any) -> bool:
    """Whether ``count_dtype`` is WIDE; int32 passes, and anything else
    raises ``ValueError``, ``"uint32"`` and ``"int64"`` with the reason."""
    if isinstance(count_dtype, str) and count_dtype == _algl.WIDE:
        return True
    name = np.dtype(count_dtype).name
    if name == "int32":
        return False
    if name == "uint32":
        raise ValueError(
            "count_dtype='uint32' is not a usable count dtype: the JAX package's engine "
            "cannot build that state (its init overflows); use 'int32' or 'wide'"
        )
    if name == "int64":
        raise ValueError(
            "count_dtype='int64' needs global x64 in the JAX package (without it the "
            "counters are silently int32); use count_dtype='wide' for 64-bit counters"
        )
    raise ValueError(f"count_dtype must be 'int32' or 'wide', got {count_dtype!r}")


def _key_words(key: Any) -> torch.Tensor:
    """An int seed (``None`` means 0: the key words of ``jr.key(seed)``) or
    ``[2]`` uint32 key words (a list, an array or a tensor) as the ``[2]``
    int64 key words the ops take."""
    if key is None or isinstance(key, (int, np.integer)):
        return key_from_seed(0 if key is None else key if isinstance(key, int) else int(key))
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    words = np.asarray(key)
    if words.shape != (2,):
        raise ValueError(f"key must be an int seed or [2] uint32 key words, got shape {words.shape}")
    return torch.from_numpy(words.astype(np.uint32).astype(np.int64))


def _host_rows(parts: List[torch.Tensor]) -> np.ndarray:
    """Row blocks (one a rank, in order) as one host array."""
    if len(parts) == 1:
        return parts[0].cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in parts])


def _signed(t: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor (WIDE counters, uint32 samples) as its int32 view,
    which torch's index kernels take; any other tensor as it is."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


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
