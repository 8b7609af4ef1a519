"""Algorithm-L reservoir sampling over R lockstep reservoirs, in plain torch.

The port of the JAX package's ``ops/algorithm_l.py`` (uniform mode, int32
counters).  This is the plain version: the CPU tests hold it against the
JAX package bit for bit, and ``chip_smoke.py`` holds the CUDA kernel of
:mod:`.algorithm_l_cuda` against it on the card.

Reservoir ``r`` consumes ``batch[r, :valid[r]]`` of its own stream.  The
fill phase stores the first k elements in arrival order; after that, an
element is accepted only at the absolute 1-based index ``nxt``, where it
overwrites a uniform slot and ``_advance_words`` draws the next ``nxt``
from the counter-keyed Threefry draws of that index.  Skipped elements are
never read.  Because every draw is keyed on the absolute index, any split
of a stream into tiles gives the same state.

Every array moves as 32-bit words: samples and batch are handled through
their int32 view, so float ``-0.0`` and NaN payloads survive untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import fmath
from .rng import accept_draws_words, split_keys

__all__ = [
    "ReservoirState",
    "SAMPLE_DTYPES",
    "init",
    "update",
    "update_steady",
    "update_accepts",
    "result",
]

_INT32_MAX = 2**31 - 1
#: ``float(INT32_MAX // 2)`` rounded to float32 (2^30): the skip clamp
_SKIP_CLAMP = 1073741824.0
#: sample dtypes the engine and the kernel take (all 4-byte words)
SAMPLE_DTYPES = (torch.int32, torch.float32, torch.uint32)


class ReservoirState(NamedTuple):
    """State of R reservoirs.

    Attributes:
      samples: ``[R, k]`` stored samples (int32, float32 or uint32).
      count:   ``[R]`` int32, elements consumed per reservoir.
      nxt:     ``[R]`` int32, absolute 1-based index of the next
               acceptance; saturates at ``2^31 - 1``.
      log_w:   ``[R]`` float32, log of Algorithm L's ``W``.
      key:     ``[R, 2]`` int64, each reservoir's Threefry key words.
    """

    samples: torch.Tensor
    count: torch.Tensor
    nxt: torch.Tensor
    log_w: torch.Tensor
    key: torch.Tensor

    @property
    def num_reservoirs(self) -> int:
        return self.samples.shape[0]

    @property
    def k(self) -> int:
        return self.samples.shape[1]


def _to_int32_sat(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN to 0 (inputs here are finite
    and at most 2^30 otherwise)."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x).to(torch.int32)


def reciprocal_f32(k: int) -> float:
    """``1 / k`` rounded once to float32, with ``k`` itself rounded to
    float32 first (what XLA folds ``x / k`` into)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(float(k), dtype=torch.float32)).item()


def _advance_words(
    log_w: torch.Tensor,
    nxt: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    idx: torch.Tensor,
    k: int,
    compiled: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Algorithm-L skip recomputation with the draws of accept index
    ``idx``: ``W *= u1^(1/k)`` in log space, then
    ``nxt += floor(log(u2) / log(1 - W)) + 1``, saturating at int32 max.
    Returns ``(slot, log_w, nxt)``.

    ``compiled`` follows how the reference rounds ``log_w + log(u1) / k``.
    Inside a compiled XLA computation (every update, and the Pallas kernel)
    XLA rewrites the division by the constant k into a multiplication by its
    float32 reciprocal and contracts that with the add into one FMA.  The
    reference's ``init`` runs op by op and divides."""
    slot, u1, u2 = accept_draws_words(k1, k2, idx, k)
    if compiled:
        log_w = fmath.fma(fmath.log(u1), reciprocal_f32(k), log_w)
    else:
        log_w = log_w + fmath.log(u1) / torch.full_like(u1, float(k))
    w = fmath.exp(log_w)
    # w rounding to exactly 1.0 gives log1p(-1) = -inf -> skip 0
    skip_f = torch.floor(fmath.log(u2) / fmath.log1p(-w))
    skip_f = torch.minimum(skip_f, torch.full_like(skip_f, _SKIP_CLAMP))
    skip = _to_int32_sat(skip_f)
    headroom = _INT32_MAX - skip - 1
    nxt = torch.where(nxt > headroom, torch.full_like(nxt, _INT32_MAX), nxt + skip + 1)
    return slot, log_w, nxt


def init(
    key_words: torch.Tensor,
    num_reservoirs: int,
    k: int,
    sample_dtype: torch.dtype = torch.int32,
    device=None,
) -> ReservoirState:
    """R empty reservoirs: the seed key ``[2]`` is split into R keys (the
    partitionable ``jr.split`` layout) and each draws its first ``nxt`` and
    ``log_w`` from accept index 0."""
    if sample_dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample dtype must be one of {SAMPLE_DTYPES}, got {sample_dtype}")
    keys = split_keys(torch.as_tensor(key_words, device=device), num_reservoirs)
    log_w0 = torch.zeros(num_reservoirs, dtype=torch.float32, device=device)
    nxt0 = torch.full((num_reservoirs,), k, dtype=torch.int32, device=device)
    zero = torch.zeros(num_reservoirs, dtype=torch.int32, device=device)
    _, log_w, nxt = _advance_words(log_w0, nxt0, keys[:, 0], keys[:, 1], zero, k, compiled=False)
    return ReservoirState(
        samples=torch.zeros((num_reservoirs, k), dtype=sample_dtype, device=device),
        count=torch.zeros(num_reservoirs, dtype=torch.int32, device=device),
        nxt=nxt,
        log_w=log_w,
        key=keys,
    )


def _check(state: ReservoirState, batch: torch.Tensor, valid) -> None:
    R, _ = state.samples.shape
    if batch.ndim != 2 or batch.shape[0] != R:
        raise ValueError(f"batch must be [R={R}, B], got {tuple(batch.shape)}")
    if batch.dtype != state.samples.dtype:
        raise ValueError(
            f"batch dtype {batch.dtype} != samples dtype {state.samples.dtype}"
        )
    if valid is not None and (valid.shape != (R,) or valid.dtype != torch.int32):
        raise ValueError(f"valid must be an int32 [R={R}] tensor, got {valid.dtype} {tuple(valid.shape)}")


def _update(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor],
    fill: bool,
) -> Tuple[ReservoirState, int]:
    _check(state, batch, valid)
    R, k = state.samples.shape
    B = batch.shape[1]
    dev = batch.device
    bits = batch.view(torch.int32)
    samples = state.samples.clone()
    out = samples.view(torch.int32)
    count = state.count
    v = valid if valid is not None else torch.full((R,), B, dtype=torch.int32, device=dev)
    end = count + v
    if fill:
        # element j has absolute index count + j + 1; index <= k goes to
        # slot index - 1, in arrival order
        lane = torch.arange(B, dtype=torch.int64, device=dev)
        dest = count.to(torch.int64)[:, None] + lane[None, :]
        take = (dest < k) & (lane[None, :] < v.to(torch.int64)[:, None])
        rows = torch.arange(R, device=dev)[:, None].expand(R, B)
        out[rows[take], dest[take]] = bits[take]
    nxt = state.nxt.clone()
    log_w = state.log_w.clone()
    k1, k2 = state.key[:, 0], state.key[:, 1]
    # lockstep acceptance loop: each round advances every lane whose next
    # acceptance lies inside this tile
    rows = torch.nonzero(nxt <= end).flatten()
    accepts = 0
    while rows.numel():
        accepts += rows.numel()
        n = nxt[rows]
        pos = (n - count[rows] - 1).to(torch.int64)
        # the reference's gather index rule (wrap negatives, then clamp)
        pos = torch.where(pos < 0, pos + B, pos).clamp(0, B - 1)
        slot, lw, n_new = _advance_words(log_w[rows], n, k1[rows], k2[rows], n, k)
        out[rows, slot.to(torch.int64)] = bits[rows, pos]
        nxt[rows] = n_new
        log_w[rows] = lw
        rows = rows[n_new <= end[rows]]
    return ReservoirState(samples, end, nxt, log_w, state.key), accepts


def update(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> ReservoirState:
    """Consume one ``[R, B]`` tile, fill phase included: reservoir ``r``
    takes ``batch[r, :valid[r]]`` (default: the whole row).  Returns a new
    state; the input state is not modified."""
    return _update(state, batch, valid, fill=True)[0]


def update_steady(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> ReservoirState:
    """:func:`update` without the fill-phase copy, for tiles where every
    reservoir already holds k elements."""
    return _update(state, batch, valid, fill=False)[0]


def update_accepts(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    fill: bool = True,
) -> Tuple[ReservoirState, int]:
    """:func:`update` (or :func:`update_steady` with ``fill=False``) that
    also returns the number of acceptances over all rows — the data-dependent
    work a kernel's bound is reckoned from."""
    return _update(state, batch, valid, fill)


def result(state: ReservoirState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(samples [R, k], size [R])`` with ``size = min(count, k)``; entries
    at or past ``size`` are zeros."""
    size = torch.clamp(state.count, max=state.k)
    mask = torch.arange(state.k, device=state.samples.device)[None, :] < size[:, None]
    bits = torch.where(mask, state.samples.view(torch.int32), 0)
    return bits.view(state.samples.dtype), size
