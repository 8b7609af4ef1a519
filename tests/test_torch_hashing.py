"""The port's distinct-mode hashing against the JAX package's, bit for bit:
``reservoir_tpu_torch.ops.hashing`` (``fmix32``, ``scramble64``,
``default_hash64``, on torch tensors and on numpy uint32 arrays) against
``reservoir_tpu.ops.hashing`` on jax arrays, and the port's salts against
``reservoir_tpu.ops.distinct.init``.  The tolerance is zero."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import hashing as JH
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import hashing as TH
from reservoir_tpu_torch.ops.rng import key_from_seed

_EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF,
                   0x85EBCA6B, 0x0000FFFF, 0xFFFF0000], np.uint32)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([_EDGES, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)])


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_fmix32_equals_jax():
    x = _words(1 << 14, 0)
    want = np.asarray(jax.jit(JH.fmix32)(jnp.asarray(x)))
    np.testing.assert_array_equal(TH.fmix32(_t(x)).numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(TH.fmix32(x), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_scramble64_equals_jax(seed):
    n = 1 << 13
    hi, lo = _words(n, seed), _words(n, seed + 10)
    salts = [_words(n, seed + 20 + j) for j in range(4)]
    want = jax.jit(JH.scramble64)(*(jnp.asarray(a) for a in (hi, lo, *salts)))
    got_t = TH.scramble64(*(_t(a) for a in (hi, lo, *salts)))
    got_np = TH.scramble64(hi, lo, *salts)
    for w, gt, gn in zip(want, got_t, got_np):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(gn, np.asarray(w))
    # and the host oracle's scalar form agrees
    for i in range(0, n, 997):
        v = (int(hi[i]) << 32) | int(lo[i])
        s = ((int(salts[0][i]) << 32) | int(salts[1][i]), (int(salts[2][i]) << 32) | int(salts[3][i]))
        assert JH.scramble64_int(v, s) == (int(got_np[0][i]) << 32) | int(got_np[1][i])


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_default_hash64_equals_jax(dtype):
    v = _words(1 << 12, 3).view(dtype)
    whi, wlo = JH.default_hash64(jnp.asarray(v))
    thi, tlo = TH.default_hash64(torch.from_numpy(v))
    nhi, nlo = TH.default_hash64(v)
    for w, t, n in ((whi, thi, nhi), (wlo, tlo, nlo)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w).view(np.uint32).astype(np.int64))
        np.testing.assert_array_equal(n, np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
@pytest.mark.parametrize("R", [1, 7, 4096])
def test_salts_equal_distinct_init(seed, R):
    want = np.asarray(JD.init(jr.key(seed), R, 2).salts)
    got = TD.init(key_from_seed(seed), R, 2).salts
    assert got.dtype == torch.int32 and got.shape == (R, 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("value", [(0, 7), (0xFFFFFFFF, 0xFFFFFFF9), (0x12345678, 0x9ABCDEF0)])
def test_salt_for_target_sends_the_value_to_the_target(value):
    r0 = (0x01234567, 0x89ABCDEF)
    for target in ((0xFFFFFFFF, 0xFFFFFFFF), (0, 0), (5, 6)):
        r1 = TH.salt_for_target(value, target, r0)
        salts = ((r0[0] << 32) | r0[1], (r1[0] << 32) | r1[1])
        assert JH.scramble64_int((value[0] << 32) | value[1], salts) == (target[0] << 32) | target[1]
