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

:func:`update_gated` consumes a pre-gated ``[R, Bg]`` tile of candidates
(the skip gate's dispatch): the same state as :func:`update` over the full
tiles, from the shipped fill prefixes and acceptances alone.

:func:`merge_samples` combines two sets of reservoirs over disjoint streams
into one exact sample of their union (a hypergeometric draw, then uniform
subsets of the two sides); :func:`merge_samples_keyed` is the same with one
key per row, so that a whole level of a merge tree runs as one call.  Its
draws (:func:`merge_draws`: the scan :func:`merge_scan` and the two
permutations' keys) are the merge kernel's function: on the card
:func:`merge_samples_keyed` draws them with that kernel, and
:func:`merge_from_draws` over :func:`merge_draws` is the plain merge on any
device.  Narrow counts are int32 or uint32 in, uint32 out.

WIDE counters (``count_dtype=WIDE``) carry ``count`` and ``nxt`` as
``[R, 2]`` uint32 (lo, hi) words (:mod:`.u64e`), so a row's stream can pass
2^31 and 2^32: the draws are keyed on the 64-bit index's Threefry block
``(hi, lo)`` (:func:`_advance_pair`), the skip is added exactly through a
float32 hi/lo split, and a WIDE state with a zero high word evolves as the
int32 one.  WIDE merges draw with 64-bit rejection and return WIDE
counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import fmath, u64e
from .hashing import to_i32, words
from .hooks import stored_words as _stored
from .rng import accept_draws_pair, accept_draws_words, split_keys
from .threefry import MASK32, bits_words, fold_in_words, threefry2x32

__all__ = [
    "ReservoirState",
    "SAMPLE_DTYPES",
    "WIDE",
    "init",
    "update",
    "update_steady",
    "update_accepts",
    "update_gated",
    "result",
    "MergeDraws",
    "merge_scan",
    "merge_keys",
    "merge_draws",
    "merge_from_draws",
    "merge_samples",
    "merge_samples_keyed",
    "merge",
]

_INT32_MAX = 2**31 - 1
#: ``float(INT32_MAX // 2)`` rounded to float32 (2^30): the skip clamp
_SKIP_CLAMP = 1073741824.0
#: the skip clamp of WIDE counters (2^62: headroom for the 64-bit adds)
_SKIP_CLAMP_WIDE = float(2.0**62)
#: sample dtypes the engine and the kernel take (all 4-byte words)
SAMPLE_DTYPES = (torch.int32, torch.float32, torch.uint32)
#: ``count_dtype`` of emulated 64-bit counters: ``count`` and ``nxt`` as
#: ``[R, 2]`` uint32 (lo, hi) words
WIDE = "wide"


class ReservoirState(NamedTuple):
    """State of R reservoirs.

    Attributes:
      samples: ``[R, k]`` stored samples (int32, float32 or uint32).
      count:   ``[R]`` int32, elements consumed per reservoir; or, with
               WIDE counters, ``[R, 2]`` uint32 (lo, hi) words.
      nxt:     ``[R]`` int32, absolute 1-based index of the next
               acceptance, saturating at ``2^31 - 1``; or ``[R, 2]``
               uint32 words (WIDE), which never saturate.
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

    @property
    def wide(self) -> bool:
        """Whether the counters are WIDE ``[R, 2]`` words."""
        return self.count.ndim == 2


def _to_int32_sat(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN to 0 (inputs here are finite
    and at most 2^30 otherwise)."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x).to(torch.int32)


def reciprocal_f32(k: int) -> float:
    """``1 / k`` rounded once to float32, with ``k`` itself rounded to
    float32 first (what XLA folds ``x / k`` into)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(float(k), dtype=torch.float32)).item()


def _skip_draw(log_w, u1, u2, k: int, compiled: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One acceptance's ``W *= u1^(1/k)`` in log space (rounded as
    :func:`_advance_words` says) and its unclamped float skip
    ``floor(log(u2) / log(1 - W))``; returns ``(log_w, skip_f)``."""
    if compiled:
        log_w = fmath.fma(fmath.log(u1), reciprocal_f32(k), log_w)
    else:
        log_w = log_w + fmath.log(u1) / torch.full_like(u1, float(k))
    w = fmath.exp(log_w)
    # w rounding to exactly 1.0 gives log1p(-1) = -inf -> skip 0
    return log_w, torch.floor(fmath.log(u2) / fmath.log1p(-w))


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
    log_w, skip_f = _skip_draw(log_w, u1, u2, k, compiled)
    skip_f = torch.minimum(skip_f, torch.full_like(skip_f, _SKIP_CLAMP))
    skip = _to_int32_sat(skip_f)
    headroom = _INT32_MAX - skip - 1
    nxt = torch.where(nxt > headroom, torch.full_like(nxt, _INT32_MAX), nxt + skip + 1)
    return slot, log_w, nxt


def _advance_pair(
    log_w: torch.Tensor,
    nxt: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    idx_hi: torch.Tensor,
    idx_lo: torch.Tensor,
    k: int,
    compiled: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_advance_words` for WIDE counters: ``nxt`` is a ``[..., 2]``
    logical uint64 (:mod:`.u64e` words) and the draws are keyed on the
    index ``(idx_hi, idx_lo)``.  The skip is clamped at 2^62 and added
    through :func:`.u64e.add_f32`, which is exact, so ``nxt`` never
    saturates.  ``compiled`` rounds ``log_w`` as :func:`_advance_words`
    does.  Returns ``(slot, log_w, nxt)``, ``nxt`` as int64 words."""
    slot, u1, u2 = accept_draws_pair(k1, k2, idx_hi, idx_lo, k)
    log_w, skip_f = _skip_draw(log_w, u1, u2, k, compiled)
    skip_f = torch.minimum(skip_f, torch.full_like(skip_f, _SKIP_CLAMP_WIDE))
    return slot, log_w, u64e.add_f32(u64e.add_u32(nxt, 1), skip_f)


def _is_wide(count_dtype) -> bool:
    """``count_dtype`` as :func:`init` takes it: ``WIDE``, or int32."""
    if isinstance(count_dtype, str) and count_dtype == WIDE:
        return True
    if count_dtype in (torch.int32, "int32"):
        return False
    raise ValueError(f"count_dtype must be 'int32' or {WIDE!r}, got {count_dtype!r}")


def init(
    key_words: torch.Tensor,
    num_reservoirs: int,
    k: int,
    sample_dtype: torch.dtype = torch.int32,
    device=None,
    compiled: bool = False,
    count_dtype="int32",
) -> ReservoirState:
    """R empty reservoirs: the seed key ``[2]`` is split into R keys (the
    partitionable ``jr.split`` layout) and each draws its first ``nxt`` and
    ``log_w`` from accept index 0.

    ``compiled`` rounds that first draw as the reference's compiled code
    does (see :func:`_advance_words`): ``False`` for the engine's
    construction, whose reference ``init`` runs op by op; ``True`` for a
    row reset, whose reference ``init`` runs inside ``jax.jit``.  The two
    differ in ``log_w`` for a k that is not a power of two.

    ``count_dtype`` is ``"int32"`` or :data:`WIDE` (``[R, 2]`` uint32
    counters whose first draw is keyed on the index pair ``(0, 0)``)."""
    if sample_dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample dtype must be one of {SAMPLE_DTYPES}, got {sample_dtype}")
    wide = _is_wide(count_dtype)
    keys = split_keys(torch.as_tensor(key_words, device=device), num_reservoirs)
    log_w0 = torch.zeros(num_reservoirs, dtype=torch.float32, device=device)
    if wide:
        zero = torch.zeros(num_reservoirs, dtype=torch.int64, device=device)
        _, log_w, nxt = _advance_pair(log_w0, u64e.from_int(k, (num_reservoirs,), device),
                                      keys[:, 0], keys[:, 1], zero, zero, k, compiled=compiled)
        return ReservoirState(
            samples=torch.zeros((num_reservoirs, k), dtype=sample_dtype, device=device),
            count=u64e.to_u32(u64e.from_int(0, (num_reservoirs,), device)),
            nxt=u64e.to_u32(nxt),
            log_w=log_w,
            key=keys,
        )
    nxt0 = torch.full((num_reservoirs,), k, dtype=torch.int32, device=device)
    zero = torch.zeros(num_reservoirs, dtype=torch.int32, device=device)
    _, log_w, nxt = _advance_words(log_w0, nxt0, keys[:, 0], keys[:, 1], zero, k, compiled=compiled)
    return ReservoirState(
        samples=torch.zeros((num_reservoirs, k), dtype=sample_dtype, device=device),
        count=torch.zeros(num_reservoirs, dtype=torch.int32, device=device),
        nxt=nxt,
        log_w=log_w,
        key=keys,
    )


def _check(state: ReservoirState, batch: torch.Tensor, valid, mapped: bool = False) -> None:
    R, _ = state.samples.shape
    if batch.ndim != 2 or batch.shape[0] != R:
        raise ValueError(f"batch must be [R={R}, B], got {tuple(batch.shape)}")
    if not mapped and batch.dtype != state.samples.dtype:
        raise ValueError(
            f"batch dtype {batch.dtype} != samples dtype {state.samples.dtype}"
        )
    if valid is not None and (valid.shape != (R,) or valid.dtype != torch.int32):
        raise ValueError(f"valid must be an int32 [R={R}] tensor, got {valid.dtype} {tuple(valid.shape)}")


def _update_wide(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor],
    fill: bool,
    map_fn: Optional[Callable] = None,
) -> Tuple[ReservoirState, int]:
    """:func:`_update` for WIDE counters (the reference's ``_update_one``
    with 64-bit pair arithmetic)."""
    R, k = state.samples.shape
    B = batch.shape[1]
    dev = batch.device
    dtype = state.samples.dtype
    samples = state.samples.clone()
    out = samples.view(torch.int32)
    count = u64e.words(state.count)
    v = valid.to(torch.int64) if valid is not None else torch.full((R,), B, dtype=torch.int64, device=dev)
    end = u64e.add_u32(count, v)
    if fill:
        # a fill exists only while count < k, so the low word decides
        c_lo = count[:, 0]
        lane = torch.arange(B, dtype=torch.int64, device=dev)
        dest = c_lo[:, None] + lane[None, :]
        take = (((count[:, 1] == 0) & (c_lo < k))[:, None] & (dest < k)
                & (lane[None, :] < v[:, None]))
        rows = torch.arange(R, device=dev)[:, None].expand(R, B)
        out[rows[take], dest[take]] = _stored(batch, map_fn, dtype, take)
    nxt = u64e.words(state.nxt)
    log_w = state.log_w.clone()
    k1, k2 = state.key[:, 0], state.key[:, 1]
    rows = torch.nonzero(u64e.le(nxt, end)).flatten()
    accepts = 0
    while rows.numel():
        accepts += rows.numel()
        n = nxt[rows]
        # the tile-local position: the low words' difference in int32, less 1
        # (wrapping), then the reference's gather index rule
        pos = u64e.diff_small(u64e.sub_u32(n, 1), count[rows]).to(torch.int64)
        pos = torch.where(pos < 0, pos + B, pos).clamp(0, B - 1)
        slot, lw, n_new = _advance_pair(log_w[rows], n, k1[rows], k2[rows], n[:, 1], n[:, 0], k)
        out[rows, slot.to(torch.int64)] = _stored(batch, map_fn, dtype, (rows, pos))
        nxt[rows] = n_new
        log_w[rows] = lw
        rows = rows[u64e.le(n_new, end[rows])]
    return ReservoirState(samples, u64e.to_u32(end), u64e.to_u32(nxt), log_w, state.key), accepts


def _update(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor],
    fill: bool,
    map_fn: Optional[Callable] = None,
) -> Tuple[ReservoirState, int]:
    _check(state, batch, valid, mapped=map_fn is not None)
    if state.wide:
        return _update_wide(state, batch, valid, fill, map_fn)
    R, k = state.samples.shape
    B = batch.shape[1]
    dev = batch.device
    dtype = state.samples.dtype
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
        out[rows[take], dest[take]] = _stored(batch, map_fn, dtype, take)
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
        out[rows, slot.to(torch.int64)] = _stored(batch, map_fn, dtype, (rows, pos))
        nxt[rows] = n_new
        log_w[rows] = lw
        rows = rows[n_new <= end[rows]]
    return ReservoirState(samples, end, nxt, log_w, state.key), accepts


def update(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
) -> ReservoirState:
    """Consume one ``[R, B]`` tile, fill phase included: reservoir ``r``
    takes ``batch[r, :valid[r]]`` (default: the whole row).  Returns a new
    state; the input state is not modified.

    ``map_fn`` (elementwise, :mod:`.hooks`) is applied on accept, as the
    reference applies it: to the fill's elements and to each accepted
    element, its results cast to the sample dtype; ``batch`` is then of the
    element dtype.  Acceptance depends on the draws alone, so the map never
    moves the skip chain."""
    return _update(state, batch, valid, True, map_fn)[0]


def update_steady(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    map_fn: Optional[Callable] = None,
) -> ReservoirState:
    """:func:`update` without the fill-phase copy, for tiles where every
    reservoir already holds k elements."""
    return _update(state, batch, valid, False, map_fn)[0]


def update_accepts(
    state: ReservoirState,
    batch: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    fill: bool = True,
    map_fn: Optional[Callable] = None,
) -> Tuple[ReservoirState, int]:
    """:func:`update` (or :func:`update_steady` with ``fill=False``) that
    also returns the number of acceptances over all rows — the data-dependent
    work a kernel's bound is reckoned from."""
    return _update(state, batch, valid, fill, map_fn)


def update_gated(
    state: ReservoirState,
    batch: torch.Tensor,
    nvalid: torch.Tensor,
    advance: torch.Tensor,
    map_fn: Optional[Callable] = None,
) -> ReservoirState:
    """Consume one pre-gated ``[R, Bg]`` candidate tile (the port of the
    reference's ``update_gated``, which is XLA, not Pallas).

    Reservoir ``r`` advances by ``advance[r]`` logical elements, of which
    only the ``nvalid[r]`` candidates in ``batch[r, :nvalid[r]]`` were
    shipped, in stream order: first the fill prefix (its first
    ``f = clip(k - count, 0, advance)`` entries go to slots
    ``count .. count + f - 1``), then every acceptance in
    ``(count, count + advance]``, each at the absolute index ``nxt`` it
    is drawn for.  The skip gate (:mod:`reservoir_tpu_torch.stream.gate`)
    proved that no acceptance lands on an element it did not ship, so the
    state equals :func:`update` over the full tiles.  The reference is
    always compiled, so the chain takes the fused ``log_w`` update.  A
    lockstep loop over the candidates: the plain version, for the CPU and
    as the kernel's reference.  ``map_fn`` applies on accept, as in
    :func:`update`.  Returns a new state."""
    R, k = state.samples.shape
    if state.wide:
        raise ValueError("update_gated requires narrow (non-WIDE) counters")
    _check(state, batch, None, mapped=map_fn is not None)
    for name, t in (("nvalid", nvalid), ("advance", advance)):
        if t.shape != (R,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 [R={R}] tensor, got {t.dtype} {tuple(t.shape)}")
    bg = batch.shape[1]
    dev = batch.device
    dtype = state.samples.dtype
    samples = state.samples.clone()
    out = samples.view(torch.int32)
    count = state.count
    # k - count wraps in int32, as the reference's does
    f = torch.minimum(torch.clamp(k - count, min=0), advance).to(torch.int64)
    lane = torch.arange(bg, dtype=torch.int64, device=dev)
    dest = count.to(torch.int64)[:, None] + lane[None, :]
    take = (lane[None, :] < f[:, None]) & (dest >= 0) & (dest < k)
    rows = torch.arange(R, device=dev)[:, None].expand(R, bg)
    out[rows[take], dest[take]] = _stored(batch, map_fn, dtype, take)
    nxt = state.nxt.clone()
    log_w = state.log_w.clone()
    k1, k2 = state.key[:, 0], state.key[:, 1]
    nv = nvalid.to(torch.int64)
    # candidate j >= f of row r is the acceptance at absolute index nxt
    j = f.clone()
    rows = torch.nonzero(j < nv).flatten()
    while rows.numel():
        n = nxt[rows]
        slot, lw, n_new = _advance_words(log_w[rows], n, k1[rows], k2[rows], n, k)
        out[rows, slot.to(torch.int64)] = _stored(batch, map_fn, dtype, (rows, j[rows]))
        nxt[rows] = n_new
        log_w[rows] = lw
        j[rows] += 1
        rows = rows[j[rows] < nv[rows]]
    return ReservoirState(samples, count + advance, nxt, log_w, state.key)


def _wide_size(count, k: int) -> torch.Tensor:
    """``min(count, k)`` as int32 for WIDE ``[..., 2]`` counts."""
    c = u64e.words(count)
    return torch.where((c[..., 1] > 0) | (c[..., 0] >= k), k, c[..., 0]).to(torch.int32)


def result(state: ReservoirState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(samples [R, k], size [R])`` with ``size = min(count, k)``; entries
    at or past ``size`` are zeros.  ``size`` is int32 for WIDE states too."""
    size = _wide_size(state.count, state.k) if state.wide else torch.clamp(state.count, max=state.k)
    mask = torch.arange(state.k, device=state.samples.device)[None, :] < size[:, None]
    bits = torch.where(mask, state.samples.view(torch.int32), 0)
    return bits.view(state.samples.dtype), size


# ------------------------------------------------------------------- merge


class MergeDraws(NamedTuple):
    """What a uniform merge draws, row by row: the function the merge
    kernel computes (``csrc/algl_merge.cu``).

    Attributes:
      j_a: ``[R]`` int32, how many of the merged samples come from A.
      u_a: ``[R, k]`` float32, A's permutation keys: word ``j`` of
           ``bits(fold_in(key, k))`` as ``(w >> 9) * 2^-23``, ``+inf`` at
           or past A's size.
      u_b: ``[R, k]`` float32, B's, from ``fold_in(key, k + 1)``.
    """

    j_a: torch.Tensor
    u_a: torch.Tensor
    u_b: torch.Tensor


def _randint_tries(
    f1: torch.Tensor, f2: torch.Tensor, denom: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_randint_exact` that also returns each lane's number of
    Threefry draws up to the accepted one (1 where the first is
    accepted)."""
    if bool(((denom < 1) | (denom > MASK32)).any()):
        raise ValueError("a draw's denominator must lie in [1, 2^32): the merge carries its "
                         "counts modulo 2^32, as the reference's uint32 arithmetic does")
    space_mod = ((MASK32 % denom) + 1) % denom
    # 0 - space_mod wraps in uint32; 0 means denom divides 2^32: accept all
    thresh = (-space_mod) & MASK32
    bits = torch.zeros_like(f1)
    tries = torch.zeros_like(f1)
    lanes = torch.arange(f1.shape[0], device=f1.device)
    a = 0
    while lanes.numel():
        b0, b1 = threefry2x32(f1[lanes], f2[lanes], 1, torch.full_like(lanes, a))
        words_ = b0 ^ b1
        ok = (space_mod[lanes] == 0) | (words_ < thresh[lanes])
        bits[lanes[ok]] = words_[ok]
        tries[lanes] += 1
        lanes = lanes[~ok]
        a += 1
    return bits % denom, tries


def _randint_exact(f1: torch.Tensor, f2: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """An exact uniform integer in ``[0, denom)`` for each lane's folded key
    ``(f1, f2)``: every argument an int64 tensor of uint32 values.  Raises
    ``ValueError`` on a ``denom`` outside ``[1, 2^32)``, where the draw
    could never be accepted.

    Rejection over fresh 32-bit draws: attempt ``a`` is ``b0 ^ b1`` of the
    Threefry block ``(1, a)``, accepted when it lies below the largest
    multiple of ``denom`` in the word space, then reduced mod ``denom``.
    The lanes run in lockstep until every one has accepted (fewer than two
    attempts each on average)."""
    return _randint_tries(f1, f2, denom)[0]


def _randint_tries_u64e(
    f1: torch.Tensor, f2: torch.Tensor, denom: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_randint_tries` on WIDE ``[L, 2]`` denominators (>= 1), the
    reference's ``_randint_exact_u64e``: attempt ``a`` is the 64-bit word
    ``(b0 << 32) | b1`` of the Threefry block ``(1, a)``, accepted below
    ``2^64 - (2^64 mod denom)``, then reduced mod ``denom``; both
    remainders are :func:`.u64e.mod64`'s.  Returns ``(x [L, 2] words,
    tries [L])``."""
    zero = torch.zeros_like(denom)
    space_mod = u64e.mod64(u64e.sub64(zero, denom), denom)
    accept_all = u64e.is_zero(space_mod)
    thresh = u64e.sub64(zero, space_mod)
    bits = torch.zeros_like(denom)
    tries = torch.zeros_like(f1)
    lanes = torch.arange(f1.shape[0], device=f1.device)
    a = 0
    while lanes.numel():
        b0, b1 = threefry2x32(f1[lanes], f2[lanes], 1, torch.full_like(lanes, a))
        drawn = u64e.make(b1, b0)
        ok = accept_all[lanes] | u64e.lt(drawn, thresh[lanes])
        bits[lanes[ok]] = drawn[ok]
        tries[lanes] += 1
        lanes = lanes[~ok]
        a += 1
    return u64e.mod64(bits, denom), tries


def _merge_counts(count_a: torch.Tensor, count_b: torch.Tensor, k: int):
    """The counts as uint32 values in int64, and ``m = min(total, k)`` of
    their total, which wraps modulo 2^32 as the reference's uint32 sum.
    WIDE ``[R, 2]`` counts give their int64 words, a 64-bit total (wrapping
    modulo 2^64) and ``m`` in int32."""
    if count_a.ndim == 2:
        c_a, c_b = u64e.words(count_a), u64e.words(count_b)
        total = u64e.add64(c_a, c_b)
        return c_a, c_b, total, _wide_size(total, k)
    c_a, c_b = words(count_a), words(count_b)
    total = (c_a + c_b) & MASK32
    return c_a, c_b, total, torch.clamp(total, max=k)


def _signed_rows(count_a: torch.Tensor, count_b: torch.Tensor) -> torch.Tensor:
    """The merge's ``signed`` mask that the counts' dtypes give: bit 0 set
    where ``count_a`` is int32, bit 1 where ``count_b`` is."""
    flags = int(count_a.dtype == torch.int32) | int(count_b.dtype == torch.int32) << 1
    return torch.full(count_a.shape, flags, dtype=torch.uint8, device=count_a.device)


def _merge_size(count: torch.Tensor, is_signed: torch.Tensor, k: int) -> torch.Tensor:
    """A side's size ``min(count, k)``, the count read per row as int32
    where ``is_signed`` and as uint32 elsewhere, as the reference reads a
    count in its own dtype: an int32 count past 2^31 - 1 is negative and
    leaves every slot of its permutation at ``+inf``."""
    c = words(count)
    return torch.clamp(torch.where(is_signed & (c >= 2**31), c - 2**32, c), max=k)


def merge_scan(
    count_a: torch.Tensor, count_b: torch.Tensor, row_keys: torch.Tensor, k: int
) -> Tuple[torch.Tensor, int]:
    """The merge's hypergeometric scan (the reference's ``lax.scan``, its
    step at ``reservoir_tpu/ops/algorithm_l.py:547``): per row, ``j_a ~
    Hypergeometric(total, count_a, m)`` by m draws without replacement,
    step ``t`` keyed on ``fold_in(key, t)``.  Steps at or past a row's m
    change nothing, so the scan stops there.

    The remaining counts, their sum and the denominator are carried modulo
    2^32, as the reference's uint32 arithmetic carries them: where the
    total passes 2^32 the draws are the reference's, not a wider sum's.
    Returns ``(j_a [R] int32, draws)``, ``draws`` the words the active
    steps' rejection draws took, one Threefry block each, every rejected
    attempt counted (the data-dependent work a kernel's bound is reckoned
    from).  The plain version: a lockstep loop over t that syncs with the
    host.

    WIDE ``[R, 2]`` counts take the reference's ``one_wide`` step: the
    remainders, their sum and the denominator are 64-bit (wrapping modulo
    2^64), and each draw is 64-bit (:func:`_randint_tries_u64e`)."""
    wide = count_a.ndim == 2
    c_a, c_b, _, m = _merge_counts(count_a, count_b, k)
    R = c_a.shape[0]
    dev = c_a.device
    kw1, kw2 = row_keys[:, 0], row_keys[:, 1]
    rem_a, rem_b = c_a.clone(), c_b.clone()
    j_a = torch.zeros(R, dtype=torch.int64, device=dev)
    draws = 0
    steps = int(m.max().item()) if R else 0
    one = u64e.from_int(1, (R,), dev)
    for t in range(steps):
        f1, f2 = fold_in_words(kw1, kw2, torch.full((R,), t, dtype=torch.int32, device=dev))
        active = t < m
        if wide:
            denom = u64e.add64(rem_a, rem_b)
            denom = torch.where(u64e.is_zero(denom)[:, None], one, denom)
            r, tries = _randint_tries_u64e(f1, f2, denom)
            pick_a = u64e.lt(r, rem_a)
        else:
            denom = torch.clamp((rem_a + rem_b) & MASK32, min=1)
            r, tries = _randint_tries(f1, f2, denom)
            pick_a = r < rem_a
        draws += int(tries[active].sum().item())
        take_a = (active & pick_a).to(torch.int64)
        take_b = (active & ~pick_a).to(torch.int64)
        if wide:
            rem_a, rem_b = u64e.sub_u32(rem_a, take_a), u64e.sub_u32(rem_b, take_b)
        else:
            rem_a, rem_b = (rem_a - take_a) & MASK32, (rem_b - take_b) & MASK32
        j_a = j_a + take_a
    return j_a.to(torch.int32), draws


def _perm_keys(f1: torch.Tensor, f2: torch.Tensor, k: int, size: torch.Tensor) -> torch.Tensor:
    """The k uniforms of ``jr.uniform(key, (k,))`` for each row's key
    ``(f1, f2)`` (word ``j`` onto ``[0, 1)`` as ``(w >> 9) * 2^-23``), with
    slots at or past ``size`` pushed to ``+inf``."""
    w = torch.stack(bits_words(f1, f2, k), dim=1)
    u = (w >> 9).to(torch.float32) * float(2.0**-23)
    slot = torch.arange(k, device=u.device)
    return torch.where(slot[None, :] < size[:, None], u, float("inf"))


def _masked_perm(f1: torch.Tensor, f2: torch.Tensor, k: int, size: torch.Tensor) -> torch.Tensor:
    """Per row, a random permutation of ``[0, size)`` padded into k slots:
    a stable argsort of :func:`_perm_keys`."""
    return torch.argsort(_perm_keys(f1, f2, k, size), dim=1, stable=True)


def merge_keys(
    count_a: torch.Tensor,
    count_b: torch.Tensor,
    row_keys: torch.Tensor,
    k: int,
    signed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two permutations' keys of a merge (the uniforms of the
    reference's ``_masked_perm``, ``reservoir_tpu/ops/algorithm_l.py:718``):
    A's from ``fold_in(key, k)``, B's from ``fold_in(key, k + 1)``, each
    side masked at its size (``signed`` as :func:`merge_samples_keyed`
    takes it).  The draw indices k and k + 1 are disjoint from the scan's
    t < k.  A WIDE side's size is :func:`_wide_size` of its count, and
    ``signed`` is not read."""
    R = row_keys.shape[0]
    dev = row_keys.device
    if count_a.ndim == 2:
        size_a, size_b = _wide_size(count_a, k), _wide_size(count_b, k)
    else:
        if signed is None:
            signed = _signed_rows(count_a, count_b)
        size_a = _merge_size(count_a, (signed & 1) != 0, k)
        size_b = _merge_size(count_b, (signed & 2) != 0, k)
    kw1, kw2 = row_keys[:, 0], row_keys[:, 1]
    at = lambda i: torch.full((R,), i, dtype=torch.int32, device=dev)  # noqa: E731
    u_a = _perm_keys(*fold_in_words(kw1, kw2, at(k)), k, size_a)
    u_b = _perm_keys(*fold_in_words(kw1, kw2, at(k + 1)), k, size_b)
    return u_a, u_b


def merge_draws(
    count_a: torch.Tensor,
    count_b: torch.Tensor,
    row_keys: torch.Tensor,
    k: int,
    signed: Optional[torch.Tensor] = None,
) -> MergeDraws:
    """Every draw of a uniform merge (:class:`MergeDraws`): the scan's
    ``j_a`` (:func:`merge_scan`) and the two permutations' keys
    (:func:`merge_keys`).  The plain version of the merge kernel, on any
    device; counts int32 or uint32 ``[R]`` (or both WIDE ``[R, 2]``
    words), ``row_keys`` int64 ``[R, 2]`` key words, ``signed`` as
    :func:`merge_samples_keyed` takes it."""
    return MergeDraws(merge_scan(count_a, count_b, row_keys, k)[0],
                      *merge_keys(count_a, count_b, row_keys, k, signed))


def _check_counts(count_a: torch.Tensor, count_b: torch.Tensor, R: int) -> None:
    """Both counts narrow (int32 or uint32 ``[R]``) or both WIDE (``[R, 2]``
    32-bit words); a mixed pair raises the reference's ``ValueError``."""
    if (count_a.ndim == 2) != (count_b.ndim == 2):
        raise ValueError(
            "merge_samples: both counts must be WIDE [R, 2] planes or both "
            "narrow [R] — mixed-width merges are ambiguous; promote the "
            "narrow side with u64e.make(count, 0) first"
        )
    shape = (R, 2) if count_a.ndim == 2 else (R,)
    for name, c in (("count_a", count_a), ("count_b", count_b)):
        if tuple(c.shape) != shape or c.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"{name} must be int32 or uint32 {list(shape)}, got {c.dtype} "
                             f"{tuple(c.shape)}")


def _check_merge(samples_a, count_a, samples_b, count_b, row_keys, signed) -> None:
    R, k = samples_a.shape
    if samples_b.shape != (R, k) or samples_a.dtype != samples_b.dtype:
        raise ValueError(
            f"both sides must be [R, k] samples of one dtype, got {samples_a.dtype} "
            f"{tuple(samples_a.shape)} and {samples_b.dtype} {tuple(samples_b.shape)}"
        )
    if samples_a.dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample dtype must be one of {SAMPLE_DTYPES}, got {samples_a.dtype}")
    _check_counts(count_a, count_b, R)
    if row_keys.shape != (R, 2) or row_keys.dtype != torch.int64:
        raise ValueError(f"row_keys must be int64 [R={R}, 2] key words, got {row_keys.dtype} "
                         f"{tuple(row_keys.shape)}")
    if signed is not None and (signed.shape != (R,) or signed.dtype != torch.uint8):
        raise ValueError(f"signed must be uint8 [R={R}], got {signed.dtype} {tuple(signed.shape)}")


def merge_from_draws(
    samples_a: torch.Tensor,
    count_a: torch.Tensor,
    samples_b: torch.Tensor,
    count_b: torch.Tensor,
    draws: MergeDraws,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rest of a uniform merge once its :class:`MergeDraws` are drawn:
    a uniform ``j_a``-subset of A (the first ``j_a`` of A's keys in a
    stable argsort, ties by slot, as the reference's sort breaks them), then
    an ``(m - j_a)``-subset of B, gathered as 32-bit words; entries at or
    past m are zeros.  Returns ``(samples [R, k], count [R] uint32)``, or
    for WIDE counts the 64-bit totals as ``[R, 2]`` uint32 words."""
    R, k = samples_a.shape
    _, _, total, m = _merge_counts(count_a, count_b, k)
    j_a = draws.j_a.to(torch.int64)
    perm_a = torch.argsort(draws.u_a, dim=1, stable=True)
    perm_b = torch.argsort(draws.u_b, dim=1, stable=True)
    pos = torch.arange(k, device=samples_a.device)[None, :].expand(R, k)
    from_a = pos < j_a[:, None]
    idx = torch.where(from_a, perm_a, perm_b.gather(1, torch.clamp(pos - j_a[:, None], min=0)))
    bits_a, bits_b = samples_a.view(torch.int32), samples_b.view(torch.int32)
    merged = torch.where(from_a, bits_a.gather(1, idx), bits_b.gather(1, idx))
    merged = torch.where(pos < m[:, None], merged, 0)
    count = u64e.to_u32(total) if count_a.ndim == 2 else to_i32(total).view(torch.uint32)
    return merged.view(samples_a.dtype), count


def merge_samples_keyed(
    samples_a: torch.Tensor,
    count_a: torch.Tensor,
    samples_b: torch.Tensor,
    count_b: torch.Tensor,
    row_keys: torch.Tensor,
    signed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`merge_samples` with row ``r`` drawing from its own key
    ``row_keys[r]`` (``[R, 2]`` int64 key words).  The rows are independent,
    so the pairs of one level of a merge tree, stacked along the rows with
    their keys, merge in one call with the bits of one call a pair.

    ``signed`` (uint8 ``[R]``, default from the counts' dtypes) says per
    row how the reference would read the counts: bit 0 set reads
    ``count_a`` as int32, bit 1 ``count_b``, clear as uint32.  The reading
    only decides a side's size, ``min(count, k)``: an int32 count past
    2^31 - 1 is negative, and its side gives no sample.  A tree level whose
    rows hold both an input's count and a merged one passes it.

    The draws go through
    :func:`~reservoir_tpu_torch.ops.algorithm_l_cuda.merge_draws_cuda`: on
    CUDA tensors the merge kernel (one launch, no host sync), on CPU
    tensors the plain :func:`merge_draws`."""
    from .algorithm_l_cuda import merge_draws_cuda  # the wrapper imports this module

    _check_merge(samples_a, count_a, samples_b, count_b, row_keys, signed)
    if signed is not None:
        signed = signed.contiguous()
    draws = merge_draws_cuda(count_a.contiguous(), count_b.contiguous(), row_keys.contiguous(),
                             samples_a.shape[1], signed)
    return merge_from_draws(samples_a, count_a, samples_b, count_b, draws)


def merge_samples(
    samples_a: torch.Tensor,
    count_a: torch.Tensor,
    samples_b: torch.Tensor,
    count_b: torch.Tensor,
    key_words: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact merge of two reservoir sets over disjoint streams: row ``r`` of
    the result is a uniform ``min(k, nA + nB)``-subset of the union of the
    two rows' streams.

    Args are ``(samples [R, k], count [R])`` pairs as sampling produces them
    (entries past ``min(count, k)`` are ignored; counts int32, or the uint32
    of an earlier merge) and the merge key's ``[2]`` words, split into one
    key a row.  Returns ``(samples [R, k], count [R])``; the count is
    ``torch.uint32``, exact for any combined total below 2^32 (past it the
    count and the scan wrap modulo 2^32, as the reference's uint32
    arithmetic does), and the merged size is ``min(count, k)``.  Two WIDE
    ``[R, 2]`` counts merge exactly at any magnitude and give WIDE totals;
    a narrow and a WIDE count raise ``ValueError``.  The merge is terminal: it yields a
    sample, not a resumable Algorithm-L state."""
    key_words = torch.as_tensor(key_words, device=samples_a.device)
    return merge_samples_keyed(
        samples_a, count_a, samples_b, count_b, split_keys(key_words, samples_a.shape[0])
    )


def merge(
    state_a: ReservoirState, state_b: ReservoirState, key_words: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`merge_samples` on two states: ``(samples [R, k], size [R]
    int32, count [R] uint32)``; WIDE states give ``[R, 2]`` counts."""
    samples, count = merge_samples(
        state_a.samples, state_a.count, state_b.samples, state_b.count, key_words
    )
    if count.ndim == 2:
        return samples, _wide_size(count, state_a.k), count
    size = torch.clamp(words(count), max=state_a.k).to(torch.int32)
    return samples, size, count
