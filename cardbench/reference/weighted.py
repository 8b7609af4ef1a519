"""Weighted reservoir sampling (A-ExpJ) in NumPy: the reference that the
weighted cells are held to, word for word.

Each reservoir keeps the k items with the largest Efraimidis-Spirakis keys,
in log space (``lkeys``, ``-inf`` an empty slot).  While slots are empty,
positive-weight items take them in arrival order with the key ``log(u0) /
w``.  After that, ``xw`` is the weight still to skip: the first positive
item whose blocked prefix weight reaches ``base + xw`` replaces the minimum
key with ``log(t + u1 (1 - t)) / w`` (``t = exp(w lt)``, one fused
multiply-add), and the jump is redrawn as ``log(u2) / lt``; the unused jump
is carried over the tile's end.  Every draw is keyed on the item's absolute
index, three channels a draw (fill key, conditional key, jump); the draw
that completes the fill is keyed on index k.

Every float step rounds as the configuration states: float32, denormal
inputs and results flushed to zero, ``log``/``exp`` as the Cephes
polynomials with contracted multiply-adds, the weights' prefix sum in blocks
of 128 lanes by log-step shifted adds.  This module is written from that
definition in NumPy and shares no code with the program.

:class:`Streams` replays many independent streams (one a reservoir row) in
lockstep, one tile a step.  A full row whose tile has no positive lane at or
past its skip target only carries its jump over the tile, which is the whole
update; only rows that accept or fill run the general step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .common import uniforms
from .scalar32 import accept_row

__all__ = ["Streams", "lane_cumsum", "flush", "log", "exp", "fma", "round_bfloat16"]

F32 = np.float32


def _f(word: int) -> np.float32:
    return np.array([word], np.uint32).view(np.float32)[0]


_P = [_f(w) for w in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                      0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LOG_Q1 = _f(0xB95E8083)
_LOG_Q2 = _f(0x3F318000)
_SQRTHF = _f(0x3F3504F3)
_FLT_MIN = _f(0x00800000)
_EXP_LO = _f(0xC2AF999A)
_EXP_HI = _f(0x42B1999A)
_LOG2E = _f(0x3FB8AA3B)
_E = [_f(w) for w in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)]
_NAN = _f(0xFFFFFFFF)
_ZERO, _HALF, _ONE = F32(0.0), F32(0.5), F32(1.0)
_NEG_INF = F32(-np.inf)
#: the lowest finite float32: keys are clamped to it, so -inf marks only
#: an empty slot
_F32_MIN = F32(np.finfo(np.float32).min)
#: the prefix sum's block
CUMSUM_BLOCK = 128
#: a tile in which at most this many full rows accept runs them one by one
#: in Python scalars (:mod:`.scalar32`), cheaper than NumPy's calls
_SCALAR_ROWS = 8


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def flush(x) -> np.ndarray:
    """Denormals to signed zero."""
    x = _a(x)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) < _FLT_MIN, x * _ZERO, x)


def fma(a, b, c) -> np.ndarray:
    """``a*b + c`` on float32, rounded once: the product is exact in
    float64, the float64 sum is rounded to odd (the TwoSum error decides the
    sticky bit), and the cast to float32 then rounds correctly."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32).astype(np.float64)
    cd = np.asarray(c, np.float32).astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        s = np.asarray(p + cd)
        bp = s - cd
        err = (p - bp) + (cd - (s - bp))
        even = (s.view(np.int64) & 1) == 0
        sticky = np.isfinite(err) & (err != 0) & even
        s = np.where(sticky, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return s.astype(np.float32)


def log(x) -> np.ndarray:
    """float32 ``log``: Cephes' polynomial with contracted multiply-adds;
    denormal inputs flush (to ``-inf``), every NaN result all ones."""
    x = flush(x)
    with np.errstate(invalid="ignore", over="ignore"):
        xc = np.maximum(x, _FLT_MIN)
        b = xc.view(np.int32)
        e = ((b >> 23) - 127).astype(np.float32) + _ONE
        m = ((b & np.int32(0x807FFFFF - (1 << 32))) | np.int32(0x3F000000)).view(np.float32)
        small = m < _SQRTHF
        e = np.where(small, e - _ONE, e)
        xm = np.where(small, (m - _ONE) + m, m - _ONE)
        x2 = xm * xm
        x3 = x2 * xm
        y = fma(xm, _P[0], _P[1])
        y1 = fma(xm, _P[3], _P[4])
        y2 = fma(xm, _P[6], _P[7])
        y = fma(y, xm, _P[2])
        y1 = fma(y1, xm, _P[5])
        y2 = fma(y2, xm, _P[8])
        y = fma(y, x3, y1)
        y = fma(y, x3, y2)
        y = fma(y, x3, _LOG_Q1 * e)
        r = fma(-_HALF, x2, xm)
        r = r + y
        r = fma(_LOG_Q2, e, r)
        r = np.where(x < _FLT_MIN, _NEG_INF, r)
        r = np.where(x == np.inf, F32(np.inf), r)
        return np.where((x < 0) | np.isnan(x), _NAN, r).astype(np.float32)


def exp(x) -> np.ndarray:
    """float32 ``exp``: Cephes' polynomial with contracted multiply-adds;
    results below the normal range flush to 0."""
    with np.errstate(invalid="ignore", over="ignore"):
        x = np.clip(_a(x), _EXP_LO, _EXP_HI)
        n = np.clip(np.floor(fma(x, _LOG2E, _HALF)), F32(-127.0), F32(127.0))
        r = fma(-_LOG_Q2, n, x)
        r = fma(-_LOG_Q1, n, r)
        y = fma(r, _E[0], _E[1])
        y = fma(y, r, _E[2])
        y = fma(y, r, _E[3])
        y = fma(y, r, _E[4])
        y = fma(y, r, _HALF)
        y = fma(y, r * r, r)
        y = y + _ONE
        scale = ((n.astype(np.int32) + 127) << 23).view(np.float32)
        return flush(y * scale)


def lane_cumsum(x) -> np.ndarray:
    """Inclusive prefix sum along the last axis in blocks of 128 lanes:
    log-step shifted adds in a block (lanes below the shift add +0.0), then
    the previous block's last lane added to every lane; each add flushed."""
    x = _a(x)
    n = x.shape[-1]
    if n > 1:
        x = flush(x)
    parts, carry = [], None
    for off in range(0, n, CUMSUM_BLOCK):
        h = x[..., off: off + CUMSUM_BLOCK]
        width, d = h.shape[-1], 1
        while d < width:
            shifted = np.concatenate([np.zeros_like(h[..., :d]), h[..., : width - d]], axis=-1)
            h = flush(h + shifted)
            d *= 2
        if carry is not None:
            h = flush(h + carry)
        parts.append(h)
        carry = h[..., -1:]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)


def round_bfloat16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32: the control's weights."""
    bits = _a(x).view(np.uint32).astype(np.uint64)
    lsb = (bits >> np.uint64(16)) & np.uint64(1)
    rounded = ((bits + np.uint64(0x7FFF) + lsb) >> np.uint64(16)) << np.uint64(16)
    nan = np.isnan(_a(x))
    out = rounded.astype(np.uint32).view(np.float32)
    return np.where(nan, _a(x), out)


def _draw_xw(u3, lt):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(lt >= _ZERO, F32(np.inf), flush(log(u3) / lt)).astype(np.float32)


def _wrap32(x) -> np.ndarray:
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _step(st: Dict[str, np.ndarray], elems, wf, cw, positive) -> None:
    """One tile through rows ``st`` (arrays of those rows, updated in place):
    the fill of free slots, the acceptances, the jump carried out."""
    samples, lkeys, count, xw, key = st["samples"], st["lkeys"], st["count"], st["xw"], st["key"]
    n, k = samples.shape
    B = elems.shape[1]
    lane = np.arange(B, dtype=np.int64)
    total_w = cw[:, B - 1]
    n_filled = (lkeys > _NEG_INF).sum(1)
    need = np.maximum(k - n_filled, 0)
    prank = np.cumsum(positive, axis=1)  # 1-based rank among positive lanes

    r_f, j_f = np.nonzero(positive & (prank <= need[:, None]))
    if r_f.size:
        (u0,) = uniforms(key[r_f], count[r_f].astype(np.int64) + j_f + 1, (0,))
        with np.errstate(divide="ignore"):
            lk = np.maximum(flush(log(u0) / wf[r_f, j_f]), _F32_MIN)
        dest = n_filled[r_f] + prank[r_f, j_f] - 1
        samples[r_f, dest] = elems[r_f, j_f]
        lkeys[r_f, dest] = lk
    done = np.nonzero((n_filled < k) & (n_filled + prank[:, B - 1] >= k))[0]
    if done.size:
        (u3,) = uniforms(key[done], np.full(done.size, k), (2,))
        xw[done] = _draw_xw(u3, lkeys[done].min(1))

    j0 = (prank < need[:, None]).sum(1)
    start = np.where(need > 0, np.minimum(j0 + 1, B), 0)
    base = np.where(start > 0, cw[np.arange(n), np.maximum(start - 1, 0)], _ZERO).astype(np.float32)
    cur = start.copy()

    def next_j(rows):
        target = flush(base[rows] + xw[rows])
        mask = positive[rows] & (cw[rows] >= target[:, None]) & (lane[None, :] >= cur[rows][:, None])
        return np.where(mask.any(1), mask.argmax(1), B)

    rows = np.arange(n)
    j = next_j(rows)
    while True:
        keep = j < B
        rows, j = rows[keep], j[keep]
        if not rows.size:
            break
        w_c = wf[rows, j]
        u1, u2 = uniforms(key[rows], count[rows].astype(np.int64) + 1 + j, (1, 2))
        lk_rows = lkeys[rows]
        lt = lk_rows.min(1)
        slot = lk_rows.argmin(1)
        t = exp(flush(w_c * lt))
        r2 = fma(u1, _ONE - t, t)
        with np.errstate(divide="ignore"):
            lkey_new = np.maximum(flush(log(r2) / w_c), _F32_MIN)
        samples[rows, slot] = elems[rows, j]
        lkeys[rows, slot] = lkey_new
        xw[rows] = _draw_xw(u2, lkeys[rows].min(1))
        base[rows] = cw[rows, j]
        cur[rows] = j + 1
        j = next_j(rows)

    st["xw"] = flush(xw - flush(total_w - base))
    st["count"] = _wrap32(count.astype(np.int64) + B)


class Streams:
    """Independent weighted streams replayed tile by tile.

    Args:
      keys: ``[n, 2]`` uint32 key words, one a stream (a reservoir row's
        key, as ``split(engine_key, R)`` gives it).
      k: the sample size.
      elems: ``[n, P, B]`` int32, each stream's row of each pool tile.
      weights: ``[n, P, B]`` float32, the same for the weights.
      precision: ``"float32"`` as configured, or ``"bfloat16"`` (the
        weights rounded to it first): the control.
    """

    def __init__(self, keys, k: int, elems, weights, precision: str = "float32") -> None:
        weights = _a(weights)
        if precision == "bfloat16":
            weights = round_bfloat16(weights)
        elif precision != "float32":
            raise ValueError(f"precision is float32 or bfloat16, got {precision!r}")
        n, P, B = weights.shape
        self.k, self.B = k, B
        self.elems = np.asarray(elems, np.int32)
        self.wf = flush(weights)
        self.positive = self.wf > _ZERO
        self.cw = lane_cumsum(self.wf)
        # a full row with no positive lane at or past its target only carries
        # its jump: flush(xw - flush(total))
        self.total = flush(self.cw[..., B - 1])
        self.max_cw = np.where(self.positive, self.cw, _NEG_INF).max(-1)
        self.state = {
            "samples": np.zeros((n, k), np.int32),
            "lkeys": np.full((n, k), _NEG_INF, np.float32),
            "count": np.zeros(n, np.int32),
            "xw": np.full(n, np.inf, np.float32),
            "key": np.asarray(keys, np.uint32).reshape(n, 2),
        }
        self.filled = np.zeros(n, np.int64)

    def step(self, pool_index) -> None:
        """Every stream takes its row of pool tile ``pool_index[i]`` (an int
        for all)."""
        st = self.state
        n = self.filled.shape[0]
        ar = np.arange(n)
        p = np.broadcast_to(np.asarray(pool_index, np.int64), (n,))
        target = flush(_ZERO + st["xw"])
        fast = (self.filled == self.k) & (self.max_cw[ar, p] < target)
        if fast.all():
            st["xw"] = flush(st["xw"] - self.total[ar, p])
            st["count"] = _wrap32(st["count"].astype(np.int64) + self.B)
            return
        slow = np.nonzero(~fast)[0]
        fast_rows = np.nonzero(fast)[0]
        if fast_rows.size:
            fp = p[fast_rows]
            st["xw"][fast_rows] = flush(st["xw"][fast_rows] - self.total[fast_rows, fp])
            st["count"][fast_rows] = _wrap32(st["count"][fast_rows].astype(np.int64) + self.B)
        if slow.size <= _SCALAR_ROWS and (self.filled[slow] == self.k).all():
            for r in slow:
                q = p[r]
                st["xw"][r] = accept_row(st["samples"][r], st["lkeys"][r], int(st["count"][r]),
                                         float(st["xw"][r]), st["key"][r], self.elems[r, q],
                                         self.wf[r, q], self.cw[r, q], self.positive[r, q])
            st["count"][slow] = _wrap32(st["count"][slow].astype(np.int64) + self.B)
            return
        sp = p[slow]
        sub = {name: arr[slow].copy() for name, arr in st.items()}
        _step(sub, self.elems[slow, sp], self.wf[slow, sp], self.cw[slow, sp], self.positive[slow, sp])
        for name, arr in sub.items():
            st[name][slow] = arr
        self.filled[slow] = (sub["lkeys"] > _NEG_INF).sum(1)

    def snapshot(self) -> Dict[str, np.ndarray]:
        """A copy of the state."""
        return {name: arr.copy() for name, arr in self.state.items()}


def result(state: Dict[str, np.ndarray]):
    """``(samples, size)`` as the engine reads them: ``size`` the filled
    slots, samples past it zeros."""
    size = (state["lkeys"] > _NEG_INF).sum(1).astype(np.int32)
    mask = np.arange(state["samples"].shape[1])[None, :] < size[:, None]
    return np.where(mask, state["samples"], 0).astype(np.int32), size
