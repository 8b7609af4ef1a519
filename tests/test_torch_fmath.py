"""The port's float32 log/exp/log1p against XLA CPU's, bit for bit
(``reservoir_tpu_torch.ops.fmath``), and its fused multiply-add against the
exactly rounded result."""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reservoir_tpu_torch.ops import fmath

_CHUNK = 2**22


def _mismatches(jfn, tfn, x: np.ndarray) -> int:
    want = np.asarray(jax.jit(jfn)(x))
    got = tfn(torch.from_numpy(x)).numpy()
    return int((want.view(np.int32) != got.view(np.int32)).sum())


def test_log_equals_xla_on_the_whole_uniform_grid():
    # every value log(u1) and log(u2) can see: (i + 1) * 2^-24
    bad = 0
    for start in range(0, 2**24, _CHUNK):
        i = np.arange(start + 1, start + _CHUNK + 1, dtype=np.float64)
        bad += _mismatches(jnp.log, fmath.log, (i * 2.0**-24).astype(np.float32))
    assert bad == 0


@pytest.mark.parametrize("lo, hi", [(-30.0, 0.0), (-88.5, -86.5), (-87.0, 88.0)])
def test_exp_equals_xla(lo, hi):
    x = np.random.default_rng(int(-lo)).uniform(lo, hi, 2**21).astype(np.float32)
    assert _mismatches(jnp.exp, fmath.exp, x) == 0


@pytest.mark.parametrize("scale", ["unit", "tiny"])
def test_log1p_equals_xla_on_minus_w(scale):
    rng = np.random.default_rng(11)
    if scale == "unit":
        w = rng.uniform(0.0, 1.0, 2**21)
    else:  # W far below 1, down into the denormals XLA flushes
        w = 10.0 ** rng.uniform(-45.0, -1.0, 2**21)
    x = np.concatenate([-w.astype(np.float32), np.float32([-1.0, -0.0, 0.0])])
    assert _mismatches(jnp.log1p, fmath.log1p, x) == 0


@pytest.mark.parametrize("fn", ["log", "exp", "log1p"])
def test_special_values_equal_xla(fn):
    x = np.float32([0.0, -0.0, 1e-40, -1e-40, -1.0, 1.0, np.inf, -np.inf, np.nan,
                    1.17549435e-38, 3.4e38, -3.4e38, 0.5, -0.5])
    assert _mismatches(getattr(jnp, fn), getattr(fmath, fn), x) == 0


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to ``q``, ties to even (exact)."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(
        cands,
        key=lambda c: (abs(Fraction(float(c)) - q), int(np.array(c).view(np.int32)) & 1),
    )
    return np.float32(best)


def test_fma_is_rounded_once():
    rng = np.random.default_rng(12)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    # near-cancellations: c close to -a*b
    c[: n // 3] = -(a[: n // 3].astype(np.float64) * b[: n // 3]).astype(np.float32)
    got = fmath.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array(
        [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
         for x, y, z in zip(a, b, c)],
        np.float32,
    )
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_avoids_double_rounding():
    # 1 + 2^-24 + 2^-60 lies just above the midpoint between 1 and
    # 1 + 2^-23: a float64 sum rounds it onto the midpoint, and a second
    # rounding to float32 then ties to 1.0; rounded once it is 1 + 2^-23
    a = np.float32(1 + 2.0**-12)
    b = np.float32(2.0**-24 * (1 - 2.0**-12 + 2.0**-24))
    c = np.float32(1.0)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive == np.float32(1.0)
    got = fmath.fma(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    assert got.item() == float(np.float32(1 + 2.0**-23))
    assert _round_f32(Fraction(float(a)) * Fraction(float(b)) + 1) == got.item()
