"""One full weighted row's acceptances in Python scalars, for the rows that
accept in a tile: the same rounding as :mod:`.weighted`'s arrays, without
NumPy's cost a call, which dominates when only a row or two accept.

A float32 value rides as a Python float.  Each ``+ - * /`` runs in float64
and is rounded to float32 once (the float64 result of two float32 operands
rounds to the correctly rounded float32: 53 >= 2 * 24 + 2); ``fma`` rounds
to odd in float64 first, as :func:`.weighted.fma` does.
"""

from __future__ import annotations

import math
import struct

import numpy as np

__all__ = ["accept_row"]

_F = struct.Struct("<f")
_I = struct.Struct("<I")
_D = struct.Struct("<d")
_Q = struct.Struct("<Q")
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def f32(x: float) -> float:
    """``x`` rounded to float32 (to nearest, ties to even)."""
    try:
        return _F.unpack(_F.pack(x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)


def _bits(x: float) -> int:
    return _I.unpack(_F.pack(x))[0]


def _from_bits(b: int) -> float:
    return _F.unpack(_I.pack(b & _M))[0]


_FLT_MIN = _from_bits(0x00800000)
_F32_MIN = float(np.finfo(np.float32).min)
_P = [_from_bits(w) for w in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                              0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LOG_Q1 = _from_bits(0xB95E8083)
_LOG_Q2 = _from_bits(0x3F318000)
_SQRTHF = _from_bits(0x3F3504F3)
_EXP_LO = _from_bits(0xC2AF999A)
_EXP_HI = _from_bits(0x42B1999A)
_LOG2E = _from_bits(0x3FB8AA3B)
_E = [_from_bits(w) for w in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)]
_NAN = _from_bits(0xFFFFFFFF)


def flush(x: float) -> float:
    return x * 0.0 if abs(x) < _FLT_MIN else x


def fma(a: float, b: float, c: float) -> float:
    p = a * b  # exact: 24 + 24 bits
    s = p + c
    if math.isfinite(s):
        bp = s - c
        err = (p - bp) + (c - (s - bp))
        if err != 0 and math.isfinite(err) and not _Q.unpack(_D.pack(s))[0] & 1:
            s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return f32(s)


def log(x: float) -> float:
    x = flush(x)
    xc = _FLT_MIN if x < _FLT_MIN else x
    b = _bits(xc)
    b = b - (1 << 32) if b >= 1 << 31 else b
    e = f32(float((b >> 23) - 127) + 1.0)
    m = _from_bits((b & 0x807FFFFF) | 0x3F000000)
    if m < _SQRTHF:
        e = f32(e - 1.0)
        xm = f32(f32(m - 1.0) + m)
    else:
        xm = f32(m - 1.0)
    x2 = f32(xm * xm)
    x3 = f32(x2 * xm)
    y = fma(xm, _P[0], _P[1])
    y1 = fma(xm, _P[3], _P[4])
    y2 = fma(xm, _P[6], _P[7])
    y = fma(y, xm, _P[2])
    y1 = fma(y1, xm, _P[5])
    y2 = fma(y2, xm, _P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, f32(_LOG_Q1 * e))
    r = fma(-0.5, x2, xm)
    r = f32(r + y)
    r = fma(_LOG_Q2, e, r)
    if x < _FLT_MIN:
        r = -math.inf
    if x == math.inf:
        r = math.inf
    return _NAN if x < 0 or x != x else r


def exp(x: float) -> float:
    x = min(max(x, _EXP_LO), _EXP_HI)
    n = float(min(max(math.floor(fma(x, _LOG2E, 0.5)), -127), 127))
    r = fma(-_LOG_Q2, n, x)
    r = fma(-_LOG_Q1, n, r)
    y = fma(r, _E[0], _E[1])
    y = fma(y, r, _E[2])
    y = fma(y, r, _E[3])
    y = fma(y, r, _E[4])
    y = fma(y, r, 0.5)
    y = fma(y, f32(r * r), r)
    y = f32(y + 1.0)
    return flush(f32(y * _from_bits((int(n) + 127) << 23)))


def _threefry(k1: int, k2: int, x0: int, x1: int):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & _M
    x1 = (x1 + k2) & _M
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) & _M) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _M
    return x0, x1


def _uniforms(k1: int, k2: int, idx: int, channels):
    f1, f2 = _threefry(k1, k2, 0, idx & _M)
    out = []
    for j in channels:
        b0, b1 = _threefry(f1, f2, 0, j)
        out.append((((b0 ^ b1) >> 8) + 1) * 2.0**-24)
    return out


def _draw_xw(u: float, lt: float) -> float:
    return math.inf if lt >= 0.0 else flush(f32(log(u) / lt))


def accept_row(samples: np.ndarray, lkeys: np.ndarray, count: int, xw: float, key, elems, wf, cw,
               positive) -> float:
    """One tile through a full row: ``samples`` and ``lkeys`` (the row's
    ``[k]`` arrays) are updated in place; returns the row's new ``xw``.  The
    count (before the tile) keys the draws; the caller adds the tile."""
    k1, k2 = int(key[0]), int(key[1])
    lk = [float(v) for v in lkeys]
    B = cw.shape[0]
    base, cur = 0.0, 0
    while True:
        target = flush(f32(base + xw))
        hits = np.flatnonzero(positive[cur:] & (cw[cur:] >= np.float32(target)))
        if not hits.size:
            break
        j = cur + int(hits[0])
        w_c = float(wf[j])
        u1, u2 = _uniforms(k1, k2, count + 1 + j, (1, 2))
        lt = min(lk)
        slot = lk.index(lt)
        t = exp(flush(f32(w_c * lt)))
        r2 = fma(u1, f32(1.0 - t), t)
        lkey = flush(f32(log(r2) / w_c))
        lk[slot] = lkey if lkey != lkey else max(lkey, _F32_MIN)
        samples[slot] = elems[j]
        xw = _draw_xw(u2, min(lk))
        base = float(cw[j])
        cur = j + 1
    lkeys[:] = lk
    return flush(f32(xw - flush(f32(float(cw[B - 1]) - base))))
