"""The reference library's user hooks on tiles: ``map_fn`` and ``hash_fn``.

The port of ``Sampler.scala``'s ``map`` (applied on accept, ``:116``; to
every element in distinct mode, ``:155``) and its ``hash`` (``:173``), as
the JAX package's engine takes them: functions on tiles.  Here a hook is a
function on torch tensors, and it must be **elementwise**: it is called on
a whole ``[R, B]`` tile (the card's path maps a tile before its kernel
runs) or on the gathered elements of the accepted lanes (a ``[n]``
tensor, the plain versions' map on accept), and element ``i`` of its
result may depend on element ``i`` of its input alone.  The JAX
package calls its hooks on a row ``[B]`` and on a 0-d element; an
elementwise hook gives the same values either way.

- ``map_fn(elements)`` returns the mapped values, which are cast to the
  sample dtype (``Tensor.to``, as the reference's ``jnp.asarray(value,
  samples.dtype)``).  A float-to-int cast of NaN or of a value out of the
  integer's range is implementation-defined in both frameworks: keep a
  map's results in range.
- ``hash_fn(mapped)`` (distinct mode) returns a ``(hi, lo)`` pair of
  integer tensors of the tile's shape (or broadcastable to it): the
  pre-scramble hash words.  Their low 32 bits are taken, as the
  reference's ``astype(uint32)`` takes them.

8-byte keys are handed to the hooks as tensors of their own dtype (int64 or
uint64; torch does little arithmetic on uint64 on the CPU, so int64 keys
are the practical ones), and mapped 8-byte keys are int64, where the JAX
package hands its hooks ``(hi, lo)`` uint32 word planes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .hashing import to_i32, words
from .threefry import MASK32

__all__ = ["map_values", "stored_words", "hash_words", "hash_planes"]


def map_values(map_fn: Callable, elements: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``map_fn(elements)`` cast to ``dtype``, of the elements' shape, on
    their device and contiguous."""
    out = map_fn(elements)
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(out, device=elements.device)
    if tuple(out.shape) != tuple(elements.shape):
        raise ValueError(
            f"map_fn must be elementwise: it gave shape {tuple(out.shape)} for elements of "
            f"shape {tuple(elements.shape)}"
        )
    if out.dtype != dtype:
        out = out.to(dtype)
    return out.contiguous()


def stored_words(batch: torch.Tensor, map_fn: Optional[Callable], dtype: torch.dtype, index) -> torch.Tensor:
    """The 32-bit words a plain update stores for ``batch[index]``: the
    elements' own bits, or with ``map_fn`` those of their mapped values in
    the sample ``dtype`` (the reference maps on accept, and a fill's whole
    row)."""
    if map_fn is None:
        return batch.view(torch.int32)[index]
    return map_values(map_fn, batch[index], dtype).view(torch.int32)


def _low_words(x, like: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor (or scalar) broadcast to
    ``like``'s shape, as uint32 values in int64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=like.device)
    if x.dtype in (torch.int32, torch.uint32):
        w = words(x)
    elif x.dtype in (torch.int64, torch.uint64):
        w = x.view(torch.int64) & MASK32
    elif x.dtype.is_floating_point or x.dtype == torch.bool:
        raise ValueError(f"hash_fn must return integer words, got {x.dtype}")
    else:
        w = x.to(torch.int64) & MASK32
    return torch.broadcast_to(w, like.shape)


def _pair(hash_fn: Callable, mapped: torch.Tensor) -> tuple:
    out = hash_fn(mapped)
    if not isinstance(out, (tuple, list)) or len(out) != 2:
        raise ValueError("hash_fn must return a (hi, lo) pair of integer words")
    return out


def hash_words(hash_fn: Callable, mapped: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hash_fn(mapped)`` as its ``(hi, lo)`` words: uint32 values in
    int64, of ``mapped``'s shape."""
    hi, lo = _pair(hash_fn, mapped)
    return _low_words(hi, mapped), _low_words(lo, mapped)


def _i32_plane(x, like: torch.Tensor) -> torch.Tensor:
    """One ``hash_fn`` word as the int32 ``[R, B]`` plane a kernel reads: a
    32-bit tensor of ``like``'s shape as an int32 view (copied only if it
    is not contiguous), anything else through :func:`_low_words`."""
    if isinstance(x, torch.Tensor) and x.dtype in (torch.int32, torch.uint32) and x.shape == like.shape:
        return x.view(torch.int32).contiguous()
    return to_i32(_low_words(x, like)).contiguous()


def hash_planes(hash_fn: Callable, mapped: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hash_fn(mapped)`` as the pre-hashed kernel's ``(hi, lo)`` int32
    planes of ``mapped``'s shape: :func:`hash_words`' low 32 bits, as
    int32 bits."""
    hi, lo = _pair(hash_fn, mapped)
    return _i32_plane(hi, mapped), _i32_plane(lo, mapped)
