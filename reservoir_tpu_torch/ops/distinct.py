"""Distinct-value (salted bottom-k) sampling over R lockstep reservoirs, in
plain torch.

The port of the JAX package's ``ops/distinct.py``.  This is the plain
version: the CPU tests hold it against the JAX package bit for bit, and
``chip_smoke.py`` holds the CUDA kernel of :mod:`.distinct_cuda` against it
on the card.

Each reservoir keeps the k distinct values with the smallest scrambled
hashes (:func:`~.hashing.scramble64` of the value's bits under the row's
salts).  Entries ``[r, i]`` for ``i < size[r]`` are sorted by ``(hash_hi,
hash_lo, value_hi, value_lo)`` ascending; the rest are padding, hash
``(MAX, MAX)`` and value 0.  A tile is merged as a sort: the carried
entries and the tile's lanes are sorted on ``(pad, hash, value)``, equal
runs collapse to one entry, and the first k survivors are kept.

Which lanes a tile may take follows the reference's engine, which routes
a tile either to its Pallas kernel or to its XLA sort-merge, and the two
part on one lane: **a lane whose scrambled hash is exactly (MAX, MAX)**
(the chance is 2^-64 a value).  A full tile with no hook follows the
Pallas kernel, which compares each lane strictly against the row's last
entry: such a lane is never taken.  A ragged tile (``valid`` given) and a
hooked one follow XLA, where the reference's engine sends them
(``reservoir_tpu/engine.py:_pallas_fallback_reason``): such a lane is
kept while its row is not full (``keep_max``).

The hooks (:mod:`.hooks`): ``map_fn`` maps every element, and the stored
keys are the mapped values; ``hash_fn(mapped)`` gives the ``(hi, lo)``
words that are scrambled in place of the value's (:func:`update_prehashed`
with hash planes).  A user hash may give two values one hash; the sort on
``(hash, value)`` keeps both, ordered by value.  Without ``hash_fn`` the
mapped keys' own words are hashed, under the XLA rule.

Keys are 4-byte (narrow: ``values`` holds the sample dtype, the high word
is the sign extension of its bits) or 8-byte integers (wide: ``values`` is
the low word and ``value_hi`` the high word).  Every ``[R, k]`` plane is
stored as 32-bit words: the narrow ``values`` in the sample dtype
(``torch.int32`` or ``torch.uint32``), every other plane, and the salts, as
``torch.int32`` bit patterns of uint32 words.  A wide tile is an int64 (or
uint64) ``[R, B]`` tensor or an ``(hi, lo)`` pair of 32-bit ``[R, B]``
planes.

:func:`merge` combines two states over shards of the same logical streams
(same salts) by the same sort: the union of their entries, deduplicated,
cut to the k smallest hashes.  There padding is told by ``size`` alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .hashing import default_hash64, scramble64, to_i32, words
from .hooks import hash_words, map_values
from .threefry import MASK32, threefry2x32

__all__ = [
    "DistinctState",
    "NARROW_DTYPES",
    "WIDE_DTYPES",
    "init",
    "update",
    "update_prehashed",
    "update_steady",
    "map_keys",
    "join_planes",
    "merge",
    "result",
    "split_values_host",
    "split_values",
    "assemble_values",
    "to_i32",
]

NARROW_DTYPES = (torch.int32, torch.uint32)
WIDE_DTYPES = (torch.int64, torch.uint64)


class DistinctState(NamedTuple):
    """State of R distinct-value reservoirs (the JAX package's fields, in
    its order).

    Attributes:
      values:   ``[R, k]`` the sample dtype (narrow) or the low words as
                int32 bits (wide).
      hash_hi:  ``[R, k]`` int32 bits of the scrambled hash's high words.
      hash_lo:  ``[R, k]`` int32 bits of its low words.
      size:     ``[R]`` int32, entries held.
      count:    ``[R]`` int32, elements seen.
      salts:    ``[R, 4]`` int32 bits of ``(r0_hi, r0_lo, r1_hi, r1_lo)``.
      value_hi: ``[R, k]`` int32 bits of the high words (wide), else None.
    """

    values: torch.Tensor
    hash_hi: torch.Tensor
    hash_lo: torch.Tensor
    size: torch.Tensor
    count: torch.Tensor
    salts: torch.Tensor
    value_hi: Optional[torch.Tensor] = None

    @property
    def wide(self) -> bool:
        """True when the state holds 8-byte keys as two word planes."""
        return self.value_hi is not None


def split_values_host(values) -> Tuple[np.ndarray, np.ndarray]:
    """A host int64/uint64 array as its ``(hi, lo)`` uint32 word planes."""
    v = np.asarray(values)
    if v.dtype.itemsize != 8 or v.dtype.kind not in "iu":
        raise ValueError(f"expected 64-bit integer keys; got dtype {v.dtype}")
    u = v.view(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(MASK32)).astype(np.uint32)


def split_values(values, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host int64/uint64 array as an ``(hi, lo)`` pair of int32-bit
    tensors on ``device``: the wide tile as planes."""
    hi, lo = split_values_host(values)
    return (torch.from_numpy(hi.view(np.int32)).to(device),
            torch.from_numpy(lo.view(np.int32)).to(device))


def assemble_values(values, value_hi, sample_dtype) -> np.ndarray:
    """Host inverse of the word planes: the values of a state (numpy or
    tensors; ``value_hi`` None for narrow keys) in ``sample_dtype``."""
    sample_dtype = np.dtype(sample_dtype)
    lo = values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    if value_hi is None:
        return lo.view(sample_dtype)
    hi = value_hi.cpu().numpy() if isinstance(value_hi, torch.Tensor) else np.asarray(value_hi)
    hi = hi.view(np.uint32).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo.view(np.uint32).astype(np.uint64)).view(sample_dtype)


def init(
    key_words: torch.Tensor,
    num_reservoirs: int,
    k: int,
    sample_dtype: torch.dtype = torch.int32,
    device=None,
) -> DistinctState:
    """R empty reservoirs with salts drawn once: ``jr.bits(key, (R, 4),
    uint32)`` in the partitionable layout (word ``(r, j)`` is the xor of the
    Threefry block ``(0, 4 r + j)``).  An 8-byte integer ``sample_dtype``
    selects wide storage."""
    if sample_dtype not in NARROW_DTYPES + WIDE_DTYPES:
        raise ValueError(
            "distinct mode requires a 32- or 64-bit integer sample dtype (value "
            f"bits feed the hash and dedup key); got {sample_dtype}"
        )
    wide = sample_dtype in WIDE_DTYPES
    kw = torch.as_tensor(key_words, dtype=torch.int64, device=device)
    idx = torch.arange(4 * num_reservoirs, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(kw[0], kw[1], torch.zeros_like(idx), idx)
    plane = lambda fill: torch.full((num_reservoirs, k), fill, dtype=torch.int32, device=device)  # noqa: E731
    return DistinctState(
        values=plane(0) if wide else torch.zeros((num_reservoirs, k), dtype=sample_dtype, device=device),
        hash_hi=plane(-1),
        hash_lo=plane(-1),
        size=torch.zeros(num_reservoirs, dtype=torch.int32, device=device),
        count=torch.zeros(num_reservoirs, dtype=torch.int32, device=device),
        salts=to_i32(b0 ^ b1).reshape(num_reservoirs, 4),
        value_hi=plane(0) if wide else None,
    )


Batch = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _value_planes(state: DistinctState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile's ``(hi, lo)`` value words as uint32 in int64, checked
    against the state's key width."""
    if state.wide:
        if isinstance(batch, tuple):
            hi, lo = batch
            if hi.dtype not in NARROW_DTYPES or lo.dtype not in NARROW_DTYPES or hi.shape != lo.shape:
                raise ValueError("a wide tile's (hi, lo) planes must be 32-bit tensors of one shape")
            return words(hi), words(lo)
        if batch.dtype not in WIDE_DTYPES:
            raise ValueError(f"a wide state takes int64/uint64 tiles or (hi, lo) planes, got {batch.dtype}")
        v = batch.view(torch.int64)
        return (v >> 32) & MASK32, v & MASK32
    if isinstance(batch, tuple) or batch.dtype != state.values.dtype:
        raise ValueError(f"a narrow state takes tiles of its dtype {state.values.dtype}")
    return default_hash64(batch)


def _carried_hi(values: torch.Tensor) -> torch.Tensor:
    """The high words of carried narrow values: their sign extension, as
    for a tile's lanes."""
    return default_hash64(values)[0]


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 words as one int64 in the same order as the unsigned
    64-bit ``(hi, lo)``: the sign bit flipped."""
    return (hi - 2**31) * 2**32 + lo


def _sort_by(key: torch.Tensor, cols: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    order = torch.sort(key, dim=1, stable=True).indices
    return tuple(c.gather(1, order) for c in cols)


def map_keys(state: DistinctState, batch: Batch, map_fn: Optional[Callable]) -> Batch:
    """The keys a tile stores: ``batch`` itself without a map; else
    ``map_fn`` of every element (an 8-byte tile's ``(hi, lo)`` planes are
    first joined into int64), cast to the state's dtype: narrow to the
    values' dtype, wide to int64 (which keeps a uint64 key's bits)."""
    if map_fn is None:
        return batch
    return map_values(map_fn, join_planes(batch), torch.int64 if state.wide else state.values.dtype)


def join_planes(batch: Batch) -> torch.Tensor:
    """A tile as one tensor, as the hooks see it: ``(hi, lo)`` planes
    joined into int64, any other tile as it is."""
    if isinstance(batch, tuple):
        hi, lo = batch
        return (words(hi) << 32) | words(lo)
    return batch


def update(
    state: DistinctState,
    batch: Batch,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
    hash_fn: Optional[Callable] = None,
) -> DistinctState:
    """Merge one ``[R, B]`` tile into the bottom-k state: reservoir ``r``
    takes ``batch[r, :valid[r]]`` (default: the whole row).  Returns a new
    state; the input state is not modified.

    ``map_fn`` maps every element (:func:`map_keys`); ``batch`` is then of
    the element dtype.  ``hash_fn(mapped)`` gives the pre-scramble hash
    words (:func:`.hooks.hash_words`; 8-byte keys are handed to it as
    int64).  A tile with ``valid`` or a hook follows
    the XLA rule for a scrambled hash of (MAX, MAX), a full tile without
    either the Pallas rule (:func:`update_prehashed`)."""
    mapped = map_keys(state, batch, map_fn)
    if hash_fn is None:
        return update_prehashed(state, mapped, None, valid, keep_max=map_fn is not None)
    return update_prehashed(state, mapped, hash_words(hash_fn, join_planes(mapped)), valid)


def update_prehashed(
    state: DistinctState,
    batch: Batch,
    hashes: Optional[Tuple[torch.Tensor, torch.Tensor]],
    valid: Optional[torch.Tensor] = None,
    keep_max: bool = False,
) -> DistinctState:
    """:func:`update` of keys ``batch`` whose pre-scramble hash words are
    ``hashes``, an ``(hi, lo)`` pair of ``[R, B]`` tensors of 32-bit words
    (int32 bits, or uint32 values in int64): the plain version of the
    kernel's three instantiations.  ``None`` hashes the keys' own words.
    The rule for a lane whose scrambled hash is (MAX, MAX): given hashes,
    ``valid`` or ``keep_max`` follow the XLA sort-merge's, which keeps such
    a lane while the row is not full (the keep-max and pre-hashed
    kernels); a full tile of the keys' own words without ``keep_max``
    follows the Pallas kernel's, which never takes it (the default one)."""
    R, k = state.values.shape
    bhi, blo = _value_planes(state, batch)
    if bhi.ndim != 2 or bhi.shape[0] != R:
        raise ValueError(f"batch must be [R={R}, B], got {tuple(bhi.shape)}")
    B = bhi.shape[1]
    dev = bhi.device
    if valid is not None and (valid.shape != (R,) or valid.dtype != torch.int32):
        raise ValueError(f"valid must be an int32 [R={R}] tensor, got {valid.dtype} {tuple(valid.shape)}")
    v = valid if valid is not None else torch.full((R,), B, dtype=torch.int32, device=dev)
    s = words(state.salts)
    if hashes is None:
        pre_hi, pre_lo = bhi, blo
    else:
        pre_hi, pre_lo = (h & MASK32 if h.dtype == torch.int64 else words(h) for h in hashes)
        if pre_hi.shape != bhi.shape or pre_lo.shape != bhi.shape:
            raise ValueError(f"hashes must be two [R={R}, B={B}] planes, got {tuple(pre_hi.shape)} "
                             f"and {tuple(pre_lo.shape)}")
    hhi, hlo = scramble64(pre_hi, pre_lo, s[:, 0:1], s[:, 1:2], s[:, 2:3], s[:, 3:4])
    lane = torch.arange(B, device=dev)
    tile_pad = lane[None, :] >= v[:, None]
    if hashes is None and valid is None and not keep_max:
        # the Pallas rule: a lane whose hash is (MAX, MAX) is padding
        tile_pad = tile_pad | ((hhi == MASK32) & (hlo == MASK32))
    carried_pad = torch.arange(k, device=dev)[None, :] >= state.size[:, None]
    cvlo = words(state.values)
    cvhi = words(state.value_hi) if state.wide else _carried_hi(state.values)

    new = _bottom_k(
        torch.cat([carried_pad, tile_pad], 1),
        torch.cat([words(state.hash_hi), hhi], 1),
        torch.cat([words(state.hash_lo), hlo], 1),
        torch.cat([cvhi, bhi], 1),
        torch.cat([cvlo, blo], 1),
        k,
    )
    return _state_of(new, state, to_i32((state.count.to(torch.int64) + v) & MASK32))


def _bottom_k(pad, h_hi, h_lo, v_hi, v_lo, k: int):
    """The sort, dedup and cut shared by :func:`update` and :func:`merge`:
    ``[R, n]`` lanes (``pad`` bool, the rest uint32 words in int64) sorted
    on ``(pad, hash, value)``, equal runs collapsed to their first lane,
    padding dropped, the first k survivors kept.  Returns ``(hash_hi,
    hash_lo, value_hi, value_lo, size)`` as int32 planes ``[R, k]`` and
    int32 ``[R]``; slots past ``size`` hold hash ``(MAX, MAX)``, value 0."""
    R = pad.shape[0]
    dev = pad.device
    # a lexicographic sort on (pad, hash, value) by stable sorts, last key first
    cols = (pad.to(torch.int64), h_hi, h_lo, v_hi, v_lo)
    cols = _sort_by(_key64(v_hi, v_lo), cols)
    cols = _sort_by(_key64(cols[1], cols[2]), cols)
    pad, h_hi, h_lo, v_hi, v_lo = _sort_by(cols[0], cols)
    # equal runs collapse to their first entry; padding goes
    same = torch.ones_like(pad, dtype=torch.bool)
    for c in (pad, h_hi, h_lo, v_hi, v_lo):
        same[:, 1:] &= c[:, 1:] == c[:, :-1]
    same[:, 0] = False
    keep = ~same & (pad == 0)
    rank = torch.cumsum(keep.to(torch.int64), 1) - 1
    dest = torch.where(keep & (rank < k), rank, k)  # column k collects what drops

    def compact(col: torch.Tensor, fill: int) -> torch.Tensor:
        out = torch.full((R, k + 1), fill, dtype=torch.int64, device=dev)
        return to_i32(out.scatter(1, dest, col)[:, :k])

    size = torch.clamp(keep.sum(1), max=k).to(torch.int32)
    return compact(h_hi, MASK32), compact(h_lo, MASK32), compact(v_hi, 0), compact(v_lo, 0), size


def _state_of(new, like: DistinctState, count: torch.Tensor) -> DistinctState:
    """:func:`_bottom_k`'s planes as a state of ``like``'s key width, dtype
    and salts."""
    h_hi, h_lo, v_hi, v_lo, size = new
    return DistinctState(
        values=v_lo if like.wide else v_lo.view(like.values.dtype),
        hash_hi=h_hi,
        hash_lo=h_lo,
        size=size,
        count=count,
        salts=like.salts,
        value_hi=v_hi if like.wide else None,
    )


def merge(state_a: DistinctState, state_b: DistinctState) -> DistinctState:
    """Merge two states over shards of the same logical streams: the union
    of their entries, deduplicated, cut to the k smallest hashes (exact, by
    the mergeable-summary property of bottom-k sketches).  Both states must
    share salts (the same ``init`` key); A's are carried.  ``count`` adds.
    A slot is padding when it lies at or past its state's ``size``, whatever
    its hash."""
    if state_a.wide != state_b.wide:
        raise ValueError("cannot merge narrow and wide distinct states")
    if state_a.values.shape != state_b.values.shape or state_a.values.dtype != state_b.values.dtype:
        raise ValueError(
            f"both states must hold [R, k] values of one dtype, got {state_a.values.dtype} "
            f"{tuple(state_a.values.shape)} and {state_b.values.dtype} {tuple(state_b.values.shape)}"
        )
    k = state_a.values.shape[1]
    slot = torch.arange(k, device=state_a.values.device)[None, :]

    def both(plane) -> torch.Tensor:
        return torch.cat([plane(state_a), plane(state_b)], 1)

    new = _bottom_k(
        both(lambda s: slot >= s.size[:, None]),
        both(lambda s: words(s.hash_hi)),
        both(lambda s: words(s.hash_lo)),
        both(lambda s: words(s.value_hi) if s.wide else _carried_hi(s.values)),
        both(lambda s: words(s.values)),
        k,
    )
    count = to_i32((words(state_a.count) + words(state_b.count)) & MASK32)
    return _state_of(new, state_a, count)


#: distinct mode has no fill/steady split: the merge is one code path
update_steady = update


def result(state: DistinctState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [R, k], size [R])`` in hash order; a wide state gives its
    low words (reassemble with :func:`assemble_values` and ``value_hi``)."""
    return state.values, state.size
