"""Port-owned float32 ``log`` / ``exp`` / ``log1p``, bit-identical to XLA CPU.

One ulp decides an Algorithm-L skip: ``floor(log(u2) / log1p(-w))`` moves
every later acceptance when its argument crosses an integer, so the port
cannot use ``torch.log`` (it differs from XLA's ``log`` on about 14% of the
uniform grid).  Instead it owns the three functions, written exactly as
XLA's CPU backend evaluates them: Cephes polynomials whose multiply-add
pairs are contracted into fused multiply-adds.

Every step below is one exactly rounded IEEE operation on float32 tensors.
PyTorch never contracts across separate ops, so the same formulas give the
same bits on any device; the CUDA kernel (``csrc/fmath.cuh``) spells them
with ``__fmaf_rn`` and is compiled with ``--fmad=false``.

:func:`fma` rounds ``a*b + c`` once: the product of two floats is exact in
float64, the float64 sum is rounded to odd (a TwoSum error term decides the
sticky bit), and the final cast to float32 then rounds correctly because
53 >= 2*24 + 2.
"""

from __future__ import annotations

import struct

import torch

__all__ = ["fma", "flush", "log", "exp", "log1p", "f32_from_bits"]


def f32_from_bits(word: int) -> float:
    """The float32 value whose IEEE bit pattern is ``word``."""
    return struct.unpack("<f", struct.pack("<I", word))[0]


_P = [f32_from_bits(w) for w in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
    0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA,
)]
_LOG_Q1 = f32_from_bits(0xB95E8083)
_LOG_Q2 = f32_from_bits(0x3F318000)
_SQRTHF = f32_from_bits(0x3F3504F3)
_FLT_MIN = f32_from_bits(0x00800000)
_EXP_LO = f32_from_bits(0xC2AF999A)
_EXP_HI = f32_from_bits(0x42B1999A)
_LOG2E = f32_from_bits(0x3FB8AA3B)
_E = [f32_from_bits(w) for w in (
    0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA,
)]
_L1P_Q = [f32_from_bits(w) for w in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982,
)]
_L1P_P = [f32_from_bits(w) for w in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101,
)]
_L1P_CUT = f32_from_bits(0x3ED413CD)
#: 0x807FFFFF (sign and mantissa bits) as an int32
_SIGN_MANT = 0x807FFFFF - (1 << 32)


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` on float32 tensors (or floats), rounded once."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    p = a.double() * b.double()  # exact: 24 + 24 bits fit in 53
    cd = c.double()
    s = p + cd
    # TwoSum: s + err == p + cd exactly
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    sticky = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(sticky, torch.nextafter(s, toward), s)
    return s.float()


def flush(x: torch.Tensor) -> torch.Tensor:
    """Denormals to signed zero, as XLA CPU does with every float input and
    result (it runs with denormals-are-zero and flush-to-zero set)."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log``; denormal inputs flush to signed zero (so
    give ``-inf``) and every NaN result is XLA's all-ones NaN."""
    x = flush(x)
    xc = torch.maximum(x, _c(_FLT_MIN, x))
    b = xc.view(torch.int32)
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & _SIGN_MANT) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = torch.where(small, e - 1.0, e)
    xm = torch.where(small, (m - 1.0) + m, m - 1.0)
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
    y = fma(y, x3, _c(_LOG_Q1, x) * e)
    r = fma(-0.5, x2, xm)
    r = r + y
    r = fma(_LOG_Q2, e, r)
    r = torch.where(x < _FLT_MIN, -torch.inf, r)  # zeros
    r = torch.where(x == torch.inf, torch.inf, r)
    nan = torch.tensor(-1, dtype=torch.int32, device=x.device).view(torch.float32)
    return torch.where((x < 0) | torch.isnan(x), nan, r)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``exp``; results below the normal range flush to 0."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-_LOG_Q2, n, x)
    r = fma(-_LOG_Q1, n, r)
    y = fma(r, _E[0], _E[1])
    y = fma(y, r, _E[2])
    y = fma(y, r, _E[3])
    y = fma(y, r, _E[4])
    y = fma(y, r, 0.5)
    y = fma(y, r * r, r)
    y = y + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush(y * scale)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p``; denormal inputs flush to signed zero."""
    x = flush(x)
    z = x * 0.0
    q = z + 1.0
    for c in _L1P_Q:
        q = fma(q, x, c)
    p = z + _L1P_P[0]
    for c in _L1P_P[1:]:
        p = fma(p, x, c)
    x2 = x * x
    small = x + fma(-0.5, x2, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _L1P_CUT, small, log(x + 1.0))
