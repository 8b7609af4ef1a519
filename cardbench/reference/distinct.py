"""Distinct-value (salted bottom-k) sampling in plain PyTorch: the reference
that the distinct cells are held to, word for word.

A row keeps the k distinct keys with the smallest salted 64-bit hashes, in
hash order; the hash of a 4-byte key is a keyed 6-round Feistel permutation
(murmur3's ``fmix32`` as the round function, the row's salts ``r0`` xored
in before the first round and ``r1`` before the fourth) of the key's bits
(low word) and their sign extension (high word).  The configuration's full
tiles never take a key whose hash is exactly ``(MAX, MAX)``.  Being a
permutation, the hash never gives two keys one value, so a row's sample
after any prefix of its stream is the k smallest hashes of the set of keys
seen, whatever the order and the tiles: this module works it out as that
set's bottom k, and a merge of shards as the bottom k of their union.

Written from that definition; it shares no code with the program.  Words
ride as uint32 values in int64 tensors (torch has no uint32 arithmetic on
every device); any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .common import salts_words

__all__ = ["Hasher", "bottom_k", "planes", "MASK32", "PAD"]

MASK32 = 0xFFFFFFFF
#: the sort key of the hash (MAX, MAX): padding, never taken
PAD = 2**63 - 1
_ROUND_CONSTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B1)


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` with every product below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _scramble(hi, lo, s):
    hi, lo = hi ^ s[0], lo ^ s[1]
    for c in _ROUND_CONSTS[:3]:
        hi, lo = lo, hi ^ _fmix32((lo + c) & MASK32)
    hi, lo = hi ^ s[2], lo ^ s[3]
    for c in _ROUND_CONSTS[3:]:
        hi, lo = lo, hi ^ _fmix32((lo + c) & MASK32)
    return hi, lo


class Hasher:
    """The rows' salted hashes, as int64 sort keys in unsigned 64-bit order.

    Args:
      key_words: the engine's ``[2]`` uint32 key words (its salts are
        ``bits(key, (R, 4))``).
      num_rows: R.
      device: where the hashing runs.
      precision: ``"int32"`` as configured, or ``"int16"`` (the control:
        every key cut to its low 16 bits, sign-extended, so keys that
        share them are taken for one).
    """

    def __init__(self, key_words, num_rows: int, device, precision: str = "int32") -> None:
        if precision not in ("int32", "int16"):
            raise ValueError(f"precision is int32 or int16, got {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.salts = salts_words(key_words, num_rows)  # [R, 4] uint32

    def salts_i32(self) -> np.ndarray:
        return self.salts.view(np.int32)

    def narrow(self, values: torch.Tensor) -> torch.Tensor:
        """The keys as this precision holds them, on the hasher's device."""
        values = values.to(self.device)
        if self.precision == "int16":
            values = ((values & 0xFFFF) ^ 0x8000) - 0x8000
        return values

    def keys(self, values: torch.Tensor, rows=None) -> torch.Tensor:
        """Sort keys ``[n, B]`` of the int32 ``values`` of rows ``rows``
        (all by default), on the hasher's device."""
        salts = self.salts if rows is None else self.salts[np.asarray(rows)]
        s = torch.from_numpy(salts.astype(np.int64)).to(self.device)
        s = [s[:, j: j + 1] for j in range(4)]
        lo = values.to(self.device).to(torch.int64) & MASK32
        hi = (lo >> 31) * MASK32
        hhi, hlo = _scramble(hi, lo, s)
        return (hhi - 2**31) * 2**32 + hlo


def bottom_k(keys: torch.Tensor, values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k smallest distinct sort keys (``PAD`` dropped), ascending,
    with their values; ``[n, k]`` each, padded with ``PAD`` and 0."""
    order = torch.sort(keys, dim=1).indices
    keys = keys.gather(1, order)
    values = values.to(keys.device).to(torch.int64).gather(1, order)
    keep = keys != PAD
    keep[:, 1:] &= keys[:, 1:] != keys[:, :-1]
    rank = torch.cumsum(keep.to(torch.int64), 1) - 1
    dest = torch.where(keep & (rank < k), rank, k)
    n = keys.shape[0]
    out_k = torch.full((n, k + 1), PAD, dtype=torch.int64, device=keys.device).scatter(1, dest, keys)
    out_v = torch.zeros((n, k + 1), dtype=torch.int64, device=keys.device).scatter(1, dest, values)
    return out_k[:, :k], out_v[:, :k]


def union(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bottom k of the union of several ``(keys, values)`` bottoms."""
    return bottom_k(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1), k)


def _i32(x: torch.Tensor) -> np.ndarray:
    x = x.cpu()
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).numpy()


def planes(keys: torch.Tensor, values: torch.Tensor) -> dict:
    """A bottom's state planes as the engine stores them: ``values``,
    ``hash_hi``, ``hash_lo`` (int32 bit patterns; padding hash (MAX, MAX)
    and value 0) and ``size``."""
    hi = (keys >> 32) + 2**31
    lo = keys & MASK32
    return {"values": _i32(values & MASK32), "hash_hi": _i32(hi), "hash_lo": _i32(lo),
            "size": (keys != PAD).sum(1).to(torch.int32).cpu().numpy()}
