"""Weighted reservoir sampling (A-ExpJ) over R lockstep reservoirs, in plain torch.

The port of the JAX package's ``ops/weighted.py``.  This is the plain
version: the CPU tests hold it against the JAX package bit for bit, and
``chip_smoke.py`` holds the CUDA kernel of :mod:`.weighted_cuda` against it
on the card.

Each reservoir keeps the k items with the largest Efraimidis-Spirakis keys
``u^(1/w)``, in log space (``lkeys``; ``-inf`` marks an empty slot).  While
slots are empty, positive-weight items take them in arrival order with the
key ``log(u0) / w``.  After that, ``xw`` is the weight still to skip: a
blocked prefix sum of the tile's weights (:mod:`.prefix`) finds the first
positive item whose prefix weight reaches ``base + xw``; it replaces the
minimum key with ``log(t + u1 (1 - t)) / w`` (``t = exp(w lt)``, ``lt`` the
minimum log key) and the jump is redrawn as ``log(u2) / lt``.  The unused
jump is carried over the tile's end.  Every draw is keyed on the item's
absolute index (three channels: fill key, conditional key, jump; the draw
that completes the fill is keyed on index k).

Zero-weight items are counted and never sampled.  Every float step rounds
as XLA CPU's does: the port's own ``log``/``exp`` (:mod:`.fmath`), denormal
inputs read as zero and denormal results flushed (so a subnormal weight is a
zero weight), and ``t + u1 (1 - t)`` contracted into one fused multiply-add,
as XLA compiles it.

Rows are updated in lockstep: one round of tensor operations per
acceptance depth, as in :mod:`.algorithm_l`.  Samples and elements move as
32-bit words, so float ``-0.0`` and NaN payloads survive.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import fmath
from .algorithm_l import SAMPLE_DTYPES
from .fmath import flush
from .hooks import stored_words as _stored
from .prefix import lane_cumsum
from .rng import split_keys, uniforms

__all__ = [
    "WeightedState",
    "init",
    "update",
    "update_steady",
    "update_accepts",
    "merge_parts",
    "merge",
    "result",
]

_NEG_INF = float("-inf")
#: ``jnp.finfo(jnp.float32).min``: keys are clamped to it, so ``-inf`` only
#: ever marks an empty slot
_F32_MIN = float(torch.finfo(torch.float32).min)


class WeightedState(NamedTuple):
    """State of R weighted reservoirs.

    Attributes:
      samples: ``[R, k]`` stored samples (int32, float32 or uint32).
      lkeys:   ``[R, k]`` float32 log keys; ``-inf`` is an empty slot, and
               filled slots form a prefix.
      count:   ``[R]`` int32, items consumed per reservoir.
      xw:      ``[R]`` float32, weight still to skip before the next
               acceptance; ``+inf`` while the reservoir fills.
      key:     ``[R, 2]`` int64, each reservoir's Threefry key words.
    """

    samples: torch.Tensor
    lkeys: torch.Tensor
    count: torch.Tensor
    xw: torch.Tensor
    key: torch.Tensor

    @property
    def num_reservoirs(self) -> int:
        return self.samples.shape[0]

    @property
    def k(self) -> int:
        return self.samples.shape[1]


def init(
    key_words: torch.Tensor,
    num_reservoirs: int,
    k: int,
    sample_dtype: torch.dtype = torch.int32,
    device=None,
) -> WeightedState:
    """R empty reservoirs; the seed key ``[2]`` is split into R keys (the
    partitionable ``jr.split`` layout)."""
    if sample_dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample dtype must be one of {SAMPLE_DTYPES}, got {sample_dtype}")
    keys = split_keys(torch.as_tensor(key_words, device=device), num_reservoirs)
    return WeightedState(
        samples=torch.zeros((num_reservoirs, k), dtype=sample_dtype, device=device),
        lkeys=torch.full((num_reservoirs, k), _NEG_INF, dtype=torch.float32, device=device),
        count=torch.zeros(num_reservoirs, dtype=torch.int32, device=device),
        xw=torch.full((num_reservoirs,), float("inf"), dtype=torch.float32, device=device),
        key=keys,
    )


def _draw_xw(u3: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
    """The jump ``log(u3) / lt`` in log space; ``+inf`` (never accept) when
    the threshold key is 1 or more."""
    return torch.where(lt >= 0.0, float("inf"), flush(fmath.log(u3) / lt))


def _conditional(u1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``r2 = t + u1 * (1 - t)``, uniform on ``(t, 1]``, as XLA compiles it:
    contracted into one fused multiply-add ``fma(u1, 1 - t, t)``.  The
    unfused expression rounds differently on about a tenth of inputs."""
    return fmath.fma(u1, 1.0 - t, t)


def _check(state: WeightedState, elems: torch.Tensor, weights: torch.Tensor, valid,
           mapped: bool = False) -> None:
    R = state.samples.shape[0]
    if elems.ndim != 2 or elems.shape[0] != R or elems.shape[1] < 1:
        raise ValueError(f"elems must be [R={R}, B >= 1], got {tuple(elems.shape)}")
    if not mapped and elems.dtype != state.samples.dtype:
        raise ValueError(f"elems dtype {elems.dtype} != samples dtype {state.samples.dtype}")
    if tuple(weights.shape) != tuple(elems.shape):
        raise ValueError(f"weights {tuple(weights.shape)} must match elems {tuple(elems.shape)}")
    if valid is not None and (valid.shape != (R,) or valid.dtype != torch.int32):
        raise ValueError(f"valid must be an int32 [R={R}] tensor, got {valid.dtype} {tuple(valid.shape)}")


def _update(
    state: WeightedState,
    elems: torch.Tensor,
    weights: torch.Tensor,
    valid: Optional[torch.Tensor],
    fill: bool,
    map_fn: Optional[Callable] = None,
) -> Tuple[WeightedState, int]:
    _check(state, elems, weights, valid, mapped=map_fn is not None)
    R, k = state.samples.shape
    B = elems.shape[1]
    dev = elems.device
    dtype = state.samples.dtype
    samples = state.samples.clone()
    out = samples.view(torch.int32)
    lkeys = state.lkeys.clone()
    xw = state.xw.clone()
    count = state.count
    k1, k2 = state.key[:, 0], state.key[:, 1]
    v = valid if valid is not None else torch.full((R,), B, dtype=torch.int32, device=dev)
    has = v > 0
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    in_tile = lane[None, :] < v[:, None]
    wf = flush(weights.to(torch.float32))  # a denormal weight is a zero weight
    positive = in_tile & (wf > 0.0)
    cw = lane_cumsum(torch.where(in_tile, wf, 0.0))
    total_w = torch.where(has, cw[:, B - 1], 0.0)
    n_filled = (lkeys > _NEG_INF).sum(1, dtype=torch.int32)
    need = torch.clamp(k - n_filled, min=0)
    prank = torch.cumsum(positive.to(torch.int32), dim=1, dtype=torch.int32)  # 1-based

    if fill:
        # positive items take the free slots in arrival order
        r_f, j_f = torch.nonzero(positive & (prank <= need[:, None]), as_tuple=True)
        if r_f.numel():
            idx = count[r_f] + j_f.to(torch.int32) + 1
            (u0,) = uniforms(k1[r_f], k2[r_f], idx, 1)
            lk = torch.clamp(flush(fmath.log(u0) / wf[r_f, j_f]), min=_F32_MIN)
            dest = (n_filled[r_f] + prank[r_f, j_f] - 1).to(torch.int64)
            out[r_f, dest] = _stored(elems, map_fn, dtype, (r_f, j_f))
            lkeys[r_f, dest] = lk
        # the fill completing in this tile draws the first jump, keyed on
        # index k, against the just-filled reservoir's minimum key
        n_pos = torch.where(has, prank[:, B - 1], 0)
        done = torch.nonzero((n_filled < k) & (n_filled + n_pos >= k)).flatten()
        if done.numel():
            at_k = torch.full((done.numel(),), k, dtype=torch.int32, device=dev)
            u3 = uniforms(k1[done], k2[done], at_k, 3)[2]
            xw[done] = _draw_xw(u3, lkeys[done].min(1).values)

    # acceptances start after the fill-completing item (searchsorted(prank,
    # need, 'left') + 1); an unfinished fill leaves start == B
    j0 = (prank < need[:, None]).sum(1, dtype=torch.int32)
    start = torch.where(need > 0, torch.clamp(j0 + 1, max=B), 0)
    base = torch.where(
        start > 0, cw.gather(1, torch.clamp(start - 1, min=0).to(torch.int64)[:, None])[:, 0], 0.0
    )
    cur = start

    def next_j(rows: torch.Tensor) -> torch.Tensor:
        # the first positive lane at or past cur whose prefix weight reaches
        # base + xw, as an integer min (B when there is none)
        target = flush(base[rows] + xw[rows])
        mask = positive[rows] & (cw[rows] >= target[:, None]) & (lane[None, :] >= cur[rows][:, None])
        return torch.where(mask, lane[None, :], B).min(1).values

    rows = torch.arange(R, device=dev)
    j = next_j(rows)
    accepts = 0
    while True:
        keep = j < B
        rows, j = rows[keep], j[keep]
        if not rows.numel():
            break
        accepts += rows.numel()
        jl = j.to(torch.int64)
        w_c = wf[rows, jl]
        _, u1, u2 = uniforms(k1[rows], k2[rows], count[rows] + 1 + j, 3)
        lk_rows = lkeys[rows]
        lt = lk_rows.min(1).values
        slot = lk_rows.argmin(1)  # the first minimum
        t = fmath.exp(flush(w_c * lt))
        r2 = _conditional(u1, t)
        lkey_new = torch.clamp(flush(fmath.log(r2) / w_c), min=_F32_MIN)
        out[rows, slot] = _stored(elems, map_fn, dtype, (rows, jl))
        lkeys[rows, slot] = lkey_new
        xw[rows] = _draw_xw(u2, lkeys[rows].min(1).values)
        base[rows] = cw[rows, jl]
        cur[rows] = j + 1
        j = next_j(rows)

    # carry the unconsumed jump across the tile's end
    xw = flush(xw - flush(total_w - base))
    return WeightedState(samples, lkeys, count + v, xw, state.key), accepts


def update(
    state: WeightedState,
    elems: torch.Tensor,
    weights: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
) -> WeightedState:
    """Consume one ``[R, B]`` (elements, weights) tile pair: reservoir ``r``
    takes ``elems[r, :valid[r]]`` (default: the whole row).  Returns a new
    state; the input state is not modified.  ``map_fn`` (elementwise,
    :mod:`.hooks`) applies on the fill and on accept, its results cast to
    the sample dtype, as in :func:`.algorithm_l.update`."""
    return _update(state, elems, weights, valid, True, map_fn)[0]


def update_steady(
    state: WeightedState,
    elems: torch.Tensor,
    weights: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
) -> WeightedState:
    """:func:`update` without the fill scatter (every reservoir full).  Kept
    for parity with the JAX package; no engine path calls it, because
    zero-weight items leave a host-side count unable to prove the fill is
    over."""
    return _update(state, elems, weights, valid, False, map_fn)[0]


def update_accepts(
    state: WeightedState,
    elems: torch.Tensor,
    weights: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    fill: bool = True,
    map_fn: Optional[Callable] = None,
) -> Tuple[WeightedState, int]:
    """:func:`update` (or :func:`update_steady` with ``fill=False``) that
    also returns the number of acceptances over all rows — the data-dependent
    work a kernel's bound is reckoned from."""
    return _update(state, elems, weights, valid, fill, map_fn)


def merge_parts(
    samples_a: torch.Tensor,
    lkeys_a: torch.Tensor,
    count_a: torch.Tensor,
    samples_b: torch.Tensor,
    lkeys_b: torch.Tensor,
    count_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k-of-union merge on raw ``(samples [R, k], lkeys [R, k], count
    [R])`` triples: the k largest log keys of A's slots followed by B's.
    Exact, because the keys are independent draws per item, however the
    stream was sharded.

    The order is that of a stable ascending sort of the negated keys, as the
    JAX package's ``argsort(-lkeys)``: equal keys keep the order A then B,
    ``-0.0`` and ``0.0`` are equal, empty slots (``-inf``) come after every
    key and NaN after those.  The sort key is made canonical (one zero, one
    NaN) so that every sort algorithm orders it alike; the keys returned are
    the inputs' own bits."""
    R, k = samples_a.shape
    if samples_b.shape != (R, k) or samples_a.dtype != samples_b.dtype:
        raise ValueError(
            f"both sides must be [R, k] samples of one dtype, got {samples_a.dtype} "
            f"{tuple(samples_a.shape)} and {samples_b.dtype} {tuple(samples_b.shape)}"
        )
    for name, lk in (("lkeys_a", lkeys_a), ("lkeys_b", lkeys_b)):
        if lk.shape != (R, k) or lk.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{R}, {k}], got {lk.dtype} {tuple(lk.shape)}")
    m_s = torch.cat([samples_a.view(torch.int32), samples_b.view(torch.int32)], 1)
    m_lk = torch.cat([lkeys_a, lkeys_b], 1)
    neg = -m_lk
    neg = torch.where(neg == 0.0, 0.0, neg)
    neg = torch.where(torch.isnan(neg), float("nan"), neg)
    order = torch.argsort(neg, dim=1, stable=True)[:, :k]
    return m_s.gather(1, order).view(samples_a.dtype), m_lk.gather(1, order), count_a + count_b


def merge(state_a: WeightedState, state_b: WeightedState) -> WeightedState:
    """:func:`merge_parts` on two states.  The merged ``xw`` is not
    meaningful (A's is kept, with A's keys, for result-only use): go on
    streaming on the per-shard states."""
    samples, lkeys, count = merge_parts(
        state_a.samples, state_a.lkeys, state_a.count,
        state_b.samples, state_b.lkeys, state_b.count,
    )
    return WeightedState(samples, lkeys, count, state_a.xw, state_a.key)


def result(state: WeightedState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(samples [R, k], size [R])``: ``size`` is the number of filled slots
    (a zero-weight item is counted but takes no slot); entries at or past
    ``size`` are zeros."""
    size = (state.lkeys > _NEG_INF).sum(1).to(state.count.dtype)
    mask = torch.arange(state.k, device=state.samples.device)[None, :] < size[:, None]
    bits = torch.where(mask, state.samples.view(torch.int32), 0)
    return bits.view(state.samples.dtype), size
