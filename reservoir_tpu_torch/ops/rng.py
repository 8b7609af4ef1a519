"""Counter-based draws and key handling (the port of ``ops/rng.py``).

Every acceptance draws from ``fold_in(key, idx)``, where ``idx`` is the
absolute 1-based stream index of the accepted element, so a reservoir's
draws depend only on its key and the index — never on how the stream was
cut into tiles.

Keys are ``[..., 2]`` int64 tensors of uint32 words, the layout of
``jax.random.key_data``.
"""

from __future__ import annotations

import torch

from .threefry import MASK32, counter_bits, counter_bits_pair, threefry2x32

__all__ = [
    "uniform_from_bits",
    "accept_draws_words",
    "accept_draws_pair",
    "uniforms",
    "key_from_seed",
    "split_keys",
]

_INV_2_24 = float(2.0**-24)


def uniform_from_bits(bits: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
    """uint32 words onto the float32 grid ``(i + offset) * 2^-24`` (exact):
    ``offset=1.0`` gives ``(0, 1]``."""
    return ((bits >> 8).to(torch.int32).float() + offset) * _INV_2_24


def accept_draws_words(k1, k2, idx, k: int):
    """``(slot, u1, u2)`` for the acceptance at absolute index ``idx``:
    ``slot = w2 % k`` on uint32, ``u1`` and ``u2`` uniforms in ``(0, 1]``."""
    w0, w1, w2 = counter_bits(k1, k2, idx, 3)
    u1 = uniform_from_bits(w0)
    u2 = uniform_from_bits(w1)
    slot = (w2 % k).to(torch.int32)
    return slot, u1, u2


def accept_draws_pair(k1, k2, idx_hi, idx_lo, k: int):
    """:func:`accept_draws_words` for an absolute index carried as its
    ``(hi, lo)`` uint32 words (WIDE counters): the same draws as the
    64-bit index."""
    w0, w1, w2 = counter_bits_pair(k1, k2, idx_hi, idx_lo, 3)
    slot = (w2 % k).to(torch.int32)
    return slot, uniform_from_bits(w0), uniform_from_bits(w1)


def uniforms(k1, k2, idx, n: int):
    """The first ``n`` channels of ``(0, 1]`` uniforms for the counter key
    ``fold_in(key, idx)``, as a tuple of float32 tensors: channel ``j`` is
    word ``j`` of ``jr.bits(fold_in(key, idx), (n,))`` on the uniform grid.
    The weighted update draws three per absolute index: the fill key, the
    conditional key and the jump."""
    return tuple(uniform_from_bits(w) for w in counter_bits(k1, k2, idx, n))


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """Key words of ``jr.key(seed)`` with x64 off: ``[0, seed mod 2^32]``."""
    if not isinstance(seed, int) or isinstance(seed, bool):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def split_keys(words: torch.Tensor, num: int) -> torch.Tensor:
    """``jr.key_data(jr.split(key, num))`` in the partitionable layout: key
    ``i`` is the Threefry hash of the block ``(0, i)``.  ``words`` is one
    key ``[2]`` (giving ``[num, 2]``) or a batch ``[P, 2]`` (giving
    ``[P, num, 2]``, each key split on its own)."""
    words = torch.as_tensor(words, dtype=torch.int64)
    if words.ndim not in (1, 2) or words.shape[-1] != 2:
        raise ValueError(f"key words must have shape (2,) or (P, 2), got {tuple(words.shape)}")
    lo = torch.arange(num, dtype=torch.int64, device=words.device)
    b0, b1 = threefry2x32(words[..., 0:1], words[..., 1:2], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)
