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

One rule on top of the sort, that of the JAX package's Pallas kernel, which
compares each lane strictly against the row's last entry: **a lane whose
scrambled hash is exactly (MAX, MAX) is never taken** (the XLA sort-merge
would keep it while the row is not full; the chance is 2^-64 a value).

Keys are 4-byte (narrow: ``values`` holds the sample dtype, the high word
is the sign extension of its bits) or 8-byte integers (wide: ``values`` is
the low word and ``value_hi`` the high word).  Every ``[R, k]`` plane is
stored as 32-bit words: the narrow ``values`` in the sample dtype
(``torch.int32`` or ``torch.uint32``), every other plane, and the salts, as
``torch.int32`` bit patterns of uint32 words.  A wide tile is an int64 (or
uint64) ``[R, B]`` tensor or an ``(hi, lo)`` pair of 32-bit ``[R, B]``
planes.  ``merge`` is not ported yet (ROADMAP.md, L8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .hashing import default_hash64, scramble64, words
from .threefry import MASK32, threefry2x32

__all__ = [
    "DistinctState",
    "NARROW_DTYPES",
    "WIDE_DTYPES",
    "init",
    "update",
    "update_steady",
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


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values carried in int64 as int32 bit patterns (exact, with no
    out-of-range cast)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


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


def update(state: DistinctState, batch: Batch, valid: Optional[torch.Tensor] = None) -> DistinctState:
    """Merge one ``[R, B]`` tile into the bottom-k state: reservoir ``r``
    takes ``batch[r, :valid[r]]`` (default: the whole row).  Returns a new
    state; the input state is not modified."""
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
    hhi, hlo = scramble64(bhi, blo, s[:, 0:1], s[:, 1:2], s[:, 2:3], s[:, 3:4])
    # a masked lane, or one whose hash is (MAX, MAX), is padding
    lane = torch.arange(B, device=dev)
    tile_pad = (lane[None, :] >= v[:, None]) | ((hhi == MASK32) & (hlo == MASK32))
    carried_pad = torch.arange(k, device=dev)[None, :] >= state.size[:, None]
    cvlo = words(state.values)
    cvhi = words(state.value_hi) if state.wide else _carried_hi(state.values)

    pad = torch.cat([carried_pad, tile_pad], 1).to(torch.int64)
    h_hi = torch.cat([words(state.hash_hi), hhi], 1)
    h_lo = torch.cat([words(state.hash_lo), hlo], 1)
    v_hi = torch.cat([cvhi, bhi], 1)
    v_lo = torch.cat([cvlo, blo], 1)
    # a lexicographic sort on (pad, hash, value) by stable sorts, last key first
    cols = (pad, h_hi, h_lo, v_hi, v_lo)
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

    new_vlo = compact(v_lo, 0)
    return DistinctState(
        values=new_vlo if state.wide else new_vlo.view(state.values.dtype),
        hash_hi=compact(h_hi, MASK32),
        hash_lo=compact(h_lo, MASK32),
        size=torch.clamp(keep.sum(1), max=k).to(torch.int32),
        count=to_i32((state.count.to(torch.int64) + v) & MASK32),
        salts=state.salts,
        value_hi=compact(v_hi, 0) if state.wide else None,
    )


#: distinct mode has no fill/steady split: the merge is one code path
update_steady = update


def result(state: DistinctState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [R, k], size [R])`` in hash order; a wide state gives its
    low words (reassemble with :func:`assemble_values` and ``value_hi``)."""
    return state.values, state.size
