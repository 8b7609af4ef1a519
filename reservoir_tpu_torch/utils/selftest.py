"""The card's parity selftest: every hand-written kernel against its plain
version, bit for bit, as one cheap callable.

The port's counterpart of the JAX package's ``utils/selftest.py``, whose
four checks hold each Pallas kernel against XLA on the live backend.  Here
the nine kernels of ``csrc/`` are held against the plain torch versions in
their own modules, on the same inputs (one key each):

- ``algl``: ``algl_update``, a steady tile (the reference's ``algl``);
- ``algl_fill``: ``algl_update`` across the life-cycle boundary, B < k < 2B,
  so tile 2 enters mid-fill and completes it mid-tile (``algl_fill``);
- ``algl_wide``: ``algl_update_wide``, a fill tile, then steady tiles with
  every row's count past 2^32;
- ``algl_gated``: ``algl_update_gated`` on the skip gate's candidate tiles,
  across the fill's end and steady;
- ``weighted``: ``weighted_update`` with zero-weight lanes (``weighted``);
- ``distinct``: ``distinct_update`` over duplicated keys, 3 chained steps,
  int32 and int64 keys (``distinct``);
- ``distinct_hashed``: ``distinct_update_hashed`` under a ``hash_fn``;
- ``merge_ring``: ``merge_ring_gather`` at 1, 4 and 8 ranks of the card,
  against ``gather_parts_plain``;
- ``merge_draws``: ``algl_merge_draws`` and ``algl_merge_draws_wide``.

``kernel_parity`` is the AND of the nine.  The composite checks follow
under the reference's keys: ``gated_parity`` (a gated bridge against an
ungated one), ``merge_parity`` (the merge over the ranks against the host
tree, in all three modes, over 5 parts) and the three KS gates at the
reference's shapes and at :data:`~.stats.KS_GATE` (``ks_uniform`` /
``ks_ok``, ``ks_distinct`` / ``ks_distinct_ok``, ``ks_weighted`` /
``ks_weighted_ok``), which run the engine's kernels on the card.

The four checks the reference also has draw the reference's inputs: its
keys and its ``jax.random`` tiles, made here by the port's Threefry
(:func:`jax_bits`, :func:`jax_uniform`, :func:`jax_randint`), so the plain
side of each is the reference's XLA side bit for bit.

Shapes: on the card those the engine launches (R = 64 rows, B = 256, as the
reference's hardware shapes); on the CPU the reference's interpret shapes
(R = 8, B = 64), where the wrappers run the plain versions, so the checks
test only the plumbing there.  Callers that must never hang run the
selftest in a child process with a hard timeout:
:func:`device_selftest_subprocess`.  Run it as ``python -m
reservoir_tpu_torch.utils.selftest [--device cpu]``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "KERNELS",
    "KERNEL_CHECKS",
    "device_selftest",
    "device_selftest_subprocess",
    "jax_bits",
    "jax_randint",
    "jax_uniform",
    "launch_counts",
]

#: the keys of the kernel checks, whose AND is ``kernel_parity``
KERNEL_CHECKS = ("algl", "algl_fill", "algl_wide", "algl_gated", "weighted", "distinct",
                 "distinct_hashed", "merge_ring", "merge_draws")
#: the hand-written kernels, by the name ``chip_smoke.py`` lists them under
KERNELS = ("algl_update", "algl_update_wide", "algl_update_gated", "weighted_update", "distinct_update",
           "distinct_update_hashed", "merge_ring_gather", "algl_merge_draws", "algl_merge_draws_wide")
#: the ranks of the ``merge_ring`` check
GATHER_RANKS = (1, 4, 8)

Pairs = List[Tuple[Any, Any]]


def _shapes(on_card: bool) -> Tuple[int, int]:
    """``(R, B)``: the engine's launch shape on the card, the reference's
    interpret shape on the CPU."""
    return (64, 256) if on_card else (8, 64)


# ----------------------------------------------- the reference's jax.random


def jax_bits(key_words: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jr.bits(key, shape, uint32)`` (partitionable Threefry): word ``j``
    of the row-major flat index is ``out0 ^ out1`` of the block ``(j >> 32,
    j & 0xFFFFFFFF)``.  uint32 values in int64, on the key's device."""
    from ..ops.threefry import MASK32, threefry2x32

    kw = torch.as_tensor(key_words, dtype=torch.int64)
    n = int(np.prod(shape))
    j = torch.arange(n, dtype=torch.int64, device=kw.device)
    b0, b1 = threefry2x32(kw[0], kw[1], j >> 32, j & MASK32)
    return (b0 ^ b1).view(tuple(shape))


def jax_uniform(key_words: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jr.uniform(key, shape)`` in float32 on ``[0, 1)``: the top 23 bits
    of each word as a mantissa of 1.0, less 1.0."""
    bits = (jax_bits(key_words, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def jax_randint(key_words: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jr.randint(key, shape, minval, maxval, int32)``: two words a draw,
    from the two keys of ``split(key)``, combined modulo the span as jax
    combines them (uint32 arithmetic)."""
    from ..ops.rng import split_keys
    from ..ops.threefry import MASK32

    span = maxval - minval
    if not 0 < span < 2**32:
        raise ValueError(f"jax_randint takes a span in [1, 2^32), got {span}")
    k1, k2 = split_keys(torch.as_tensor(key_words, dtype=torch.int64), 2)
    higher, lower = jax_bits(k1, shape), jax_bits(k2, shape)
    multiplier = (((2**16 % span) ** 2) & MASK32) % span  # the square wraps in uint32
    offset = (((higher % span) * multiplier) & MASK32) + lower % span
    offset = (offset & MASK32) % span
    return (offset + minval).to(torch.int32)


def _fold_in(key_words: torch.Tensor, data: int) -> torch.Tensor:
    """``jr.key_data(jr.fold_in(key, data))`` for a 32-bit ``data``."""
    from ..ops.threefry import threefry2x32

    kw = torch.as_tensor(key_words, dtype=torch.int64)
    b0, b1 = threefry2x32(kw[0], kw[1], torch.zeros((), dtype=torch.int64), torch.tensor(int(data)))
    return torch.stack([b0, b1])


def _iota(rows: int, width: int, device, start: int = 0) -> torch.Tensor:
    """``start + lax.broadcasted_iota(int32, (rows, width), 1)``."""
    return (start + torch.arange(width, dtype=torch.int32, device=device)).expand(rows, width).contiguous()


# ---------------------------------------------------------------- helpers


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's words as a signed integer view (floats and unsigned words
    compared by their bits)."""
    if t.dtype.is_floating_point or t.dtype in (torch.uint32, torch.uint64):
        return t.view({4: torch.int32, 8: torch.int64}[t.dtype.itemsize])
    return t


def same(a, b) -> bool:
    """Two states, or tuples of tensors, equal leaf by leaf, bit for bit
    (dtype and shape included)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not torch.equal(_bits(x), _bits(y.to(x.device))):
            return False
    return True


def _clone(state):
    """A copy of a state (the kernels update theirs in place)."""
    return type(state)(*(None if t is None else t.clone() for t in state))


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by kernel name."""
    from ..ops import algorithm_l_cuda as kern
    from ..ops import distinct_cuda as dkern
    from ..ops import merge_cuda as mkern
    from ..ops import weighted_cuda as wkern

    return {"algl_update": kern.launches, "algl_update_wide": kern.wide_launches,
            "algl_update_gated": kern.gated_launches, "weighted_update": wkern.launches,
            "distinct_update": dkern.launches, "distinct_update_hashed": dkern.prehashed_launches,
            "merge_ring_gather": mkern.launches, "algl_merge_draws": kern.merge_launches,
            "algl_merge_draws_wide": kern.wide_merge_launches}


# -------------------------------------------------------- the kernel checks
#
# Each check returns its (plain version's result, kernel's result) pairs on
# the same inputs; it passes when every pair is the same bit for bit.


def algl_inputs(dev, on_card: bool):
    """The ``algl`` check's state (filled by the plain ``update`` over an
    iota tile, as the reference fills it) and steady tile."""
    from ..ops import algorithm_l as plain
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 128 if on_card else 16
    state = plain.init(key_from_seed(0), R, k, device=dev)
    state = plain.update(state, _iota(R, max(B, k), dev))
    return state, _iota(R, B, dev, 10_000)


def check_algl(dev, on_card: bool) -> Pairs:
    """``algl_update``'s steady tile against ``update_steady``."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern

    state, batch = algl_inputs(dev, on_card)
    return [(plain.update_steady(_clone(state), batch), kern.update_steady_cuda(_clone(state), batch))]


def algl_fill_inputs(dev, on_card: bool):
    """The ``algl_fill`` check's empty state (B < k < 2B) and two tiles."""
    from ..ops import algorithm_l as plain
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 384 if on_card else 96
    state = plain.init(key_from_seed(8), R, k, device=dev)
    return state, [_iota(R, B, dev, 1 + t * B) for t in range(2)]


def check_algl_fill(dev, on_card: bool) -> Pairs:
    """The fill-capable ``algl_update`` across the life-cycle boundary,
    against ``update`` after each tile."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern

    ref, tiles = algl_fill_inputs(dev, on_card)
    got = _clone(ref)
    out = []
    for batch in tiles:
        ref = plain.update(ref, batch)
        got = kern.update_cuda(got, batch)
        out.append((ref, _clone(got)))
    return out


def check_algl_wide(dev, on_card: bool) -> Pairs:
    """``algl_update_wide``: a fill tile from empty, then every row's count
    lifted past 2^32 with an imminent accept and two steady tiles, the
    second ragged."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern
    from ..ops import u64e
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 128 if on_card else 16
    rng = np.random.default_rng(9)
    state = plain.init(key_from_seed(9), R, k, count_dtype=plain.WIDE, device=dev)
    tile = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (R, B), dtype=np.int32)).to(dev)
    ref = plain.update(_clone(state), tile)
    out = [(ref, kern.update_cuda(_clone(state), tile))]
    count = u64e.add_u32(u64e.from_int(2**32, (R,), dev), torch.from_numpy(rng.integers(0, 7 * B, R)).to(dev))
    nxt = u64e.add_u32(count, torch.from_numpy(1 + rng.integers(0, 3 * B, R)).to(dev))
    ref = ref._replace(count=u64e.to_u32(count), nxt=u64e.to_u32(nxt))
    got = _clone(ref)
    for t in range(2):
        tile = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (R, B), dtype=np.int32)).to(dev)
        valid = None if t == 0 else torch.from_numpy(rng.integers(0, B + 1, R, dtype=np.int32)).to(dev)
        ref = plain.update_steady(ref, tile, valid)
        got = kern.update_steady_cuda(got, tile, valid)
        out.append((ref, _clone(got)))
    return out


class _EngineView:
    """What the skip gate's ``resync`` reads of an engine: its state."""

    def __init__(self, state) -> None:
        self._state = state
        self.reset_epochs = 0


def gated_candidates(state, tile: torch.Tensor, m: np.ndarray):
    """The skip gate's candidate tile for ``tile[r, :m[r]]`` from ``state``,
    built by the port's torch replica: ``(tile, nvalid, advance)`` on the
    state's device."""
    from ..stream.gate import SkipGate

    R, B = tile.shape
    gate = SkipGate(R, state.k, B, np.int32, cap=B, native=False)
    gate.resync(_EngineView(state))
    m = np.asarray(m, np.int32)
    ev = gate.evaluate(m)
    gate.append(tile.cpu().numpy(), m, ev)
    gtile, nvalid, advance, _ = gate.take()
    dev = state.samples.device
    return torch.from_numpy(gtile).to(dev), torch.from_numpy(nvalid).to(dev), torch.from_numpy(advance).to(dev)


def check_algl_gated(dev, on_card: bool) -> Pairs:
    """``algl_update_gated`` against ``update_gated`` on the skip gate's
    candidates, from a state 20 short of its fill and from a steady one
    (every 7th row takes nothing)."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 128 if on_card else 16
    rng = np.random.default_rng(24)

    def tile():
        return torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (R, B), dtype=np.int32)).to(dev)

    s0 = plain.init(key_from_seed(3), R, k, device=dev)
    near = plain.update(s0, tile(), torch.full((R,), k - 20, dtype=torch.int32, device=dev))
    steady = plain.update(s0, tile())
    for _ in range(3):
        steady = plain.update_steady(steady, tile())
    out = []
    for state in (near, steady):
        m = rng.integers(0, B + 1, R).astype(np.int32)
        m[::7] = 0
        cand = gated_candidates(state, tile(), m)
        out.append((plain.update_gated(_clone(state), *cand), kern.update_gated_cuda(_clone(state), *cand)))
    return out


def weighted_inputs(dev, on_card: bool):
    """The ``weighted`` check's empty state, iota elements and weights in
    {1, ..., 4} with about a fifth of the lanes zero."""
    from ..ops import weighted as plain
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 64 if on_card else 8
    state = plain.init(key_from_seed(3), R, k, device=dev)
    elems = _iota(R, B, dev)
    weights = jax_randint(key_from_seed(4), (R, B), 1, 5).to(torch.float32)
    weights = (weights * (jax_uniform(key_from_seed(5), (R, B)) > 0.2)).to(dev)
    return state, elems, weights


def check_weighted(dev, on_card: bool) -> Pairs:
    """``weighted_update`` against ``update``."""
    from ..ops import weighted as plain
    from ..ops import weighted_cuda as wkern

    state, elems, weights = weighted_inputs(dev, on_card)
    return [(plain.update(_clone(state), elems, weights), wkern.update_cuda(_clone(state), elems, weights))]


def distinct_inputs(dev, on_card: bool, wide: bool = False):
    """The ``distinct`` check's empty state and three tiles of keys in
    [0, 500) (many repeats); ``wide`` carries each key to an int64 key
    ``(v << 33) + 3 v - 2^40``, one to one, its high word in use."""
    from ..ops import distinct as plain
    from ..ops.rng import key_from_seed

    R, B = _shapes(on_card)
    k = 64 if on_card else 8
    dtype = torch.int64 if wide else torch.int32
    state = plain.init(key_from_seed(6), R, k, sample_dtype=dtype, device=dev)
    tiles = []
    for step in range(3):
        batch = jax_randint(_fold_in(key_from_seed(7), step), (R, B), 0, 500)
        if wide:
            v = batch.to(torch.int64)
            batch = (v << 33) + 3 * v - 2**40
        tiles.append(batch.to(dev))
    return state, tiles


def check_distinct(dev, on_card: bool) -> Pairs:
    """``distinct_update`` against ``update``, three chained steps, int32
    and then int64 keys."""
    from ..ops import distinct as plain
    from ..ops import distinct_cuda as dkern

    out = []
    for wide in (False, True):
        ref, tiles = distinct_inputs(dev, on_card, wide)
        got = _clone(ref)
        for batch in tiles:
            ref = plain.update(ref, batch)
            got = dkern.update_cuda(got, batch)
            out.append((ref, _clone(got)))
    return out


def _user_hash(v: torch.Tensor):
    """The ``distinct_hashed`` check's ``hash_fn``: ``(v >> 16, 31 v)``."""
    return v >> 16, v * 31


def check_distinct_hashed(dev, on_card: bool) -> Pairs:
    """``distinct_update_hashed`` under a ``hash_fn`` against the plain
    ``update`` with it, the ``distinct`` check's int32 tiles."""
    from ..ops import distinct as plain
    from ..ops import distinct_cuda as dkern

    ref, tiles = distinct_inputs(dev, on_card)
    got = _clone(ref)
    out = []
    for batch in tiles:
        ref = plain.update(ref, batch, hash_fn=_user_hash)
        got = dkern.update_cuda(got, batch, hash_fn=_user_hash)
        out.append((ref, _clone(got)))
    return out


def check_merge_ring(dev, on_card: bool) -> Pairs:
    """``merge_ring_gather`` against ``gather_parts_plain`` at 1, 4 and 8
    ranks of the device: a rank's samples ``[R / 8, k]``, sizes and counts
    (``sharded_result``'s leaves), and an unaligned float leaf."""
    from ..ops import merge_cuda as mkern

    R, _ = _shapes(on_card)
    k = 128 if on_card else 16
    rng = np.random.default_rng(43)
    out = []
    for d in GATHER_RANKS:
        comm = mkern.RingCommunicator([dev] * d)
        b = R // 8
        parts = []
        for _ in range(d):
            parts.append(tuple(torch.from_numpy(a).to(dev) for a in (
                rng.integers(-(2**31), 2**31 - 1, (b, k), dtype=np.int32),
                rng.integers(0, k + 1, b, dtype=np.int32),
                rng.integers(0, 2**31 - 1, b, dtype=np.int32),
                rng.standard_normal((b, 3)).astype(np.float32),
            )))
        want = mkern.gather_parts_plain(parts, comm)
        got = mkern.gather_parts(parts, comm)
        out.extend(zip(want, got))
    return out


def check_merge_draws(dev, on_card: bool) -> Pairs:
    """``algl_merge_draws`` (uint32 counts, some past 2^31 and 2^32 - 1)
    and ``algl_merge_draws_wide`` (WIDE counts past 2^32) against
    ``merge_draws``."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern
    from ..ops import u64e
    from ..ops.rng import key_from_seed, split_keys

    R, _ = _shapes(on_card)
    k = 128 if on_card else 16
    rng = np.random.default_rng(17)
    keys = split_keys(key_from_seed(1), R).to(dev)
    pool = np.array([0, 1, k - 1, k, k + 1, 3 * k, 2**31 - 1, 2**31 + 1, 2**32 - 1], np.int64)
    narrow = np.concatenate([rng.integers(0, 6 * k, (2, R // 2)), rng.choice(pool, (2, R - R // 2))], axis=1)
    ca, cb = (torch.from_numpy(c.astype(np.uint32)).to(dev) for c in narrow)
    out = [(plain.merge_draws(ca, cb, keys, k), kern.merge_draws_cuda(ca, cb, keys, k))]
    wide = rng.integers(0, 2**40, (2, R)) + np.array([[2**32], [0]])
    ca, cb = (u64e.to_u32(u64e.make(torch.from_numpy(c & 0xFFFFFFFF), torch.from_numpy(c >> 32))).to(dev)
              for c in wide)
    out.append((plain.merge_draws(ca, cb, keys, k), kern.merge_draws_cuda(ca, cb, keys, k)))
    return out


_KERNEL_CHECKS: Dict[str, Callable[[Any, bool], Pairs]] = {
    "algl": check_algl,
    "algl_fill": check_algl_fill,
    "algl_wide": check_algl_wide,
    "algl_gated": check_algl_gated,
    "weighted": check_weighted,
    "distinct": check_distinct,
    "distinct_hashed": check_distinct_hashed,
    "merge_ring": check_merge_ring,
    "merge_draws": check_merge_draws,
}


# ------------------------------------------------------- composite checks


def check_gated(dev, on_card: bool) -> bool:
    """A gated bridge against an ungated one on the same pushes (the
    reference's ``gated_parity``)."""
    from ..config import SamplerConfig
    from ..stream.bridge import DeviceStreamBridge

    S, k, B = (64, 16, 256) if on_card else (8, 8, 64)
    rounds = 8
    rng = np.random.default_rng(12)
    data = rng.integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    results = []
    for gated in (False, True):
        cfg = SamplerConfig(max_sample_size=k, num_reservoirs=S, tile_size=B)
        bridge = DeviceStreamBridge(cfg, key=5, gated=gated, gate_tile=32, device=dev)
        for s in range(S):
            bridge.push(s, data[s])
        results.append(bridge.complete())
    return all(np.array_equal(a, b) for a, b in zip(*results))


def check_merge(dev, on_card: bool) -> bool:
    """The merge over 5 ranks of the device against the host tree, in all
    three modes (the reference's ``merge_parity``)."""
    from ..ops import distinct as dplain
    from ..ops import weighted as wplain
    from ..ops.rng import key_from_seed
    from ..parallel.merge import merge_samples_device, merge_samples_host

    del on_card  # the same shapes everywhere, as the reference's
    k, n_parts = 8, 5
    ranks = [dev] * n_parts
    rng = np.random.default_rng(21)
    uparts = [(rng.integers(0, 1 << 30, k).astype(np.int32), int(rng.integers(k, 6 * k)))
              for _ in range(n_parts)]
    want, wt = merge_samples_host(uparts, 17, max_sample_size=k)
    got, gt = merge_samples_device(uparts, 17, max_sample_size=k, devices=ranks)
    if gt != wt or not np.array_equal(got, want):
        return False
    wparts = []
    for p in range(n_parts):
        st = wplain.update(
            wplain.init(key_from_seed(200 + p), 1, k),
            torch.from_numpy(p * 1000 + np.arange(3 * k, dtype=np.int32))[None],
            torch.from_numpy(1.0 + np.arange(3 * k, dtype=np.float32) % 7)[None],
        )
        wparts.append((st.samples[0].numpy(), st.lkeys[0].numpy(), int(st.count[0])))
    dparts = []
    for p in range(n_parts):
        st = dplain.update(dplain.init(key_from_seed(77), 1, k),  # shared salts: one logical stream
                           torch.from_numpy(p * 1000 + np.arange(4 * k, dtype=np.int32))[None])
        dparts.append((st.values[0].numpy(), st.hash_hi[0].numpy(), st.hash_lo[0].numpy(), int(st.size[0]),
                       int(st.count[0]), st.salts[0].numpy()))
    for mode, parts in (("weighted", wparts), ("distinct", dparts)):
        on_ranks = merge_samples_device(parts, max_sample_size=k, mode=mode, devices=ranks)
        host = merge_samples_device(parts, max_sample_size=k, mode=mode, impl="host")
        if not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(on_ranks, host)):
            return False
    return True


def _ks(ops, wrapper, dev, R: int, k: int, n: int, B: int, seed: int, repeats: int = 1,
        weighted: bool = False) -> Tuple[float, bool]:
    """A KS gate: ``R`` reservoirs of ``k`` fed the positions ``0..n-1`` in
    tiles of ``B`` through the mode's kernel wrapper (``repeats`` times
    over), every row full; the pooled KS distance of the samples against
    the uniform law on ``[0, n)``, and whether it is below ``KS_GATE``."""
    from ..ops.rng import key_from_seed
    from .stats import KS_GATE, ks_one_sample_uniform

    state = ops.init(key_from_seed(seed), R, k, device=dev)
    ones = torch.ones((R, B), dtype=torch.float32, device=dev)
    for _ in range(repeats):
        for start in range(0, n, B):
            batch = _iota(R, B, dev, start)
            state = wrapper(state, batch, ones) if weighted else wrapper(state, batch)
    samples, sizes = ops.result(state)
    if int(sizes.min()) != k:
        raise AssertionError(f"a reservoir holds {int(sizes.min())} samples, not {k}")
    ks = ks_one_sample_uniform(samples.cpu().numpy().ravel(), n)
    return ks, bool(ks < KS_GATE)


def check_ks(dev) -> Tuple[float, bool]:
    """The uniform KS gate at the reference's shape (N = R k = 131,072)."""
    from ..ops import algorithm_l as plain
    from ..ops import algorithm_l_cuda as kern

    return _ks(plain, kern.update_cuda, dev, 2048, 64, 8192, 512, seed=0)


def check_ks_distinct(dev) -> Tuple[float, bool]:
    """Distinct mode's KS gate: inclusion uniform over the distinct values
    of a stream that repeats every value twice."""
    from ..ops import distinct as plain
    from ..ops import distinct_cuda as dkern

    return _ks(plain, dkern.update_cuda, dev, 2048, 32, 2048, 256, seed=2, repeats=2)


def check_ks_weighted(dev) -> Tuple[float, bool]:
    """Weighted mode's KS gate: equal weights make A-ExpJ uniform."""
    from ..ops import weighted as plain
    from ..ops import weighted_cuda as wkern

    return _ks(plain, wkern.update_cuda, dev, 2048, 32, 4096, 512, seed=3, weighted=True)


# ------------------------------------------------------------ the selftest


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:500]


def device_selftest(emit_partial: Optional[Callable[[dict], Any]] = None,
                    device: Optional[str] = None) -> Dict[str, Any]:
    """Run every check on the card (``device="cpu"``: on the CPU, where the
    wrappers run the plain versions, for the tests).

    Returns ``{"platform", "device_name", "algl", ..., "merge_draws",
    "kernel_parity", "gated_parity", "merge_parity", "ks_ok",
    ["ks_uniform"], "ks_distinct_ok", ["ks_distinct"], "ks_weighted_ok",
    ["ks_weighted"], "launches", "seconds", ["<name>_error"]}``.  It never
    raises: a crash in a check is ``False`` under that check's key with the
    message under ``<name>_error``.  ``kernel_parity`` is the AND of the
    nine kernel checks.  ``launches`` counts each kernel's launches over
    the run.  Without a card (and without ``device="cpu"``) nothing runs:
    ``kernel_parity`` is ``False`` and ``error`` says there is no CUDA
    device.

    ``emit_partial`` is called with a copy of the dict after each stage
    (the kernel checks, then each composite check), so a caller that
    prints them keeps the stages that completed if a later one hangs."""
    t0 = time.perf_counter()
    if device not in (None, "cuda", "cpu"):
        raise ValueError(f"device must be None, 'cuda' or 'cpu', got {device!r}")
    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        return {"platform": None, "kernel_parity": False,
                "error": "no CUDA device is available: the selftest holds the kernels on the card "
                         "(device='cpu' runs the plain versions, for the tests)",
                "seconds": time.perf_counter() - t0}
    dev = torch.device("cuda" if on_card else "cpu")
    out: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    before = launch_counts()

    def stage_done() -> None:
        out["launches"] = {name: n - before[name] for name, n in launch_counts().items()}
        out["seconds"] = time.perf_counter() - t0
        if emit_partial is not None:
            try:
                emit_partial(dict(out))
            except Exception:
                pass  # progress reports never stop the checks

    ok = True
    for name, check in _KERNEL_CHECKS.items():
        try:
            pairs = check(dev, on_card)
            if on_card:
                torch.cuda.synchronize()
            out[name] = bool(pairs) and all(same(ref, got) for ref, got in pairs)
        except Exception as e:  # a build, launch or shape fault: recorded
            out[name] = False
            out[f"{name}_error"] = _error(e)
        ok = ok and out[name]
    out["kernel_parity"] = ok
    stage_done()
    for name, check in (("gated_parity", check_gated), ("merge_parity", check_merge)):
        try:
            out[name] = bool(check(dev, on_card))
        except Exception as e:
            out[name] = False
            out[f"{name}_error"] = _error(e)
        stage_done()
    for name, ok_key, check in (("ks_uniform", "ks_ok", check_ks),
                                ("ks_distinct", "ks_distinct_ok", check_ks_distinct),
                                ("ks_weighted", "ks_weighted_ok", check_ks_weighted)):
        try:
            out[name], out[ok_key] = check(dev)
        except Exception as e:
            out[ok_key] = False
            out[f"{'ks' if name == 'ks_uniform' else name}_error"] = _error(e)
        stage_done()
    return out


def _child_code(device: Optional[str]) -> str:
    """The child of :func:`device_selftest_subprocess`: one JSON line a
    completed stage, then the whole dict.  It imports only this package."""
    return (
        "import json, sys\n"
        "from reservoir_tpu_torch.utils.selftest import device_selftest\n"
        "def _p(d):\n"
        "    sys.stdout.write(json.dumps(d) + '\\n'); sys.stdout.flush()\n"
        f"_p(device_selftest(emit_partial=_p, device={device!r}))\n"
    )


def _last_json(text) -> Optional[dict]:
    """The last line of ``text`` that parses as a JSON object."""
    import json

    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    for line in reversed((text or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def device_selftest_subprocess(timeout_s: float = 900.0, skip_probe: bool = False,
                               device: Optional[str] = None) -> Dict[str, Any]:
    """Run :func:`device_selftest` in a throwaway child process.

    A card can hang a process in its first context or in a kernel, and
    nothing in that process can end it: a hang here costs ``timeout_s`` and
    is recorded, never inherited.  The liveness probe
    (:func:`~.probe.probe_backend_proc`, 60 s) runs first unless
    ``skip_probe``.  The child prints a JSON line after each completed
    stage and the parent keeps the last: on a timeout it is returned with
    ``partial`` set; a child that crashes after a stage gives that stage
    with ``partial`` and the tail of its stderr; a child that printed no
    stage gives ``{"kernel_parity": False, "error": ...}``.  ``device``
    pins the child (and its probe) as :func:`device_selftest` takes it."""
    import os
    import subprocess
    import sys

    from .probe import probe_backend_proc

    if not skip_probe and probe_backend_proc(60.0, device) is None:
        return {"kernel_parity": False, "error": "card unreachable (the probe failed or hung)"}
    # the checkout holding this package: the child imports it from there
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        proc = subprocess.run([sys.executable, "-c", _child_code(device)], capture_output=True,
                              timeout=timeout_s, text=True, cwd=root)
    except subprocess.TimeoutExpired as e:
        salvaged = _last_json(e.stdout)
        if salvaged is not None:
            salvaged["partial"] = f"timed out after {timeout_s:.0f} s; the last completed stage kept"
            return salvaged
        return {"kernel_parity": False, "error": f"the selftest's child timed out after {timeout_s:.0f} s"}
    parsed = _last_json(proc.stdout)
    if parsed is not None:
        if proc.returncode != 0:
            # the child died after this stage: keep its evidence, never as
            # a clean run
            parsed["partial"] = (f"the child crashed (rc {proc.returncode}) after its last stage: "
                                 + proc.stderr[-300:])
        return parsed
    return {"kernel_parity": False, "error": f"the selftest's child rc {proc.returncode}: " + proc.stderr[-300:]}


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the card's parity selftest, one JSON line")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    print(json.dumps(device_selftest(device=ap.parse_args().device)))
