"""The torch port's Threefry, draws and keys against the JAX package's, word
for word (``reservoir_tpu_torch.ops.threefry`` / ``.rng``)."""

from __future__ import annotations

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import rng as jrng
from reservoir_tpu.ops import threefry as jtf
from reservoir_tpu_torch.ops import rng as trng
from reservoir_tpu_torch.ops import threefry as ttf


def _words(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(jax_words, torch_words):
    np.testing.assert_array_equal(
        np.asarray(jax_words).astype(np.int64), torch_words.numpy()
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_words(seed):
    rng = np.random.default_rng(seed)
    k1, k2, x0, x1 = (_words(rng, 4096) for _ in range(4))
    j0, j1 = jtf.threefry2x32(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = ttf.threefry2x32(_t(k1), _t(k2), _t(x0), _t(x1))
    _eq(j0, t0)
    _eq(j1, t1)


def test_fold_in_equals_jax_random():
    rng = np.random.default_rng(3)
    idx = np.concatenate([[0, 1, 2**31 - 1, 2**31, 2**32 - 1], _words(rng, 60)])
    for key_seed in (0, 9):
        key = jr.key(key_seed)
        k1, k2 = (int(w) for w in np.asarray(jr.key_data(key)))
        t1, t2 = ttf.fold_in_words(k1, k2, _t(idx))
        want = np.stack([np.asarray(jr.key_data(jr.fold_in(key, int(i)))) for i in idx])
        _eq(want[:, 0], t1)
        _eq(want[:, 1], t2)


def test_fold_in_folds_the_high_word_of_a_64_bit_index():
    rng = np.random.default_rng(4)
    hi = _words(rng, 256)
    lo = _words(rng, 256)
    k1, k2 = _words(rng, 256), _words(rng, 256)
    idx = torch.from_numpy((hi.astype(np.uint64) << np.uint64(32) | lo).astype(np.int64))
    j1, j2 = jtf.fold_in_words_pair(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(hi), jnp.asarray(lo))
    t1, t2 = ttf.fold_in_words(_t(k1), _t(k2), idx)
    _eq(j1, t1)
    _eq(j2, t2)
    # an int32 index is its own low word: negative values keep their bits
    neg = torch.tensor([-1, -(2**31)], dtype=torch.int32)
    n1, _ = ttf.fold_in_words(_t(k1[:2]), _t(k2[:2]), neg)
    m1, _ = jtf.fold_in_words(jnp.asarray(k1[:2]), jnp.asarray(k2[:2]), jnp.asarray([-1, -(2**31)], jnp.int32))
    _eq(m1, n1)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_bits_words_equal_jax_random_bits(n):
    for seed in (0, 1, 77):
        key = jr.key(seed)
        k1, k2 = (int(w) for w in np.asarray(jr.key_data(key)))
        got = torch.stack(ttf.bits_words(torch.tensor(k1), torch.tensor(k2), n))
        _eq(jr.bits(key, (n,), jnp.uint32), got)


def test_counter_bits_equal_the_reference():
    rng = np.random.default_rng(5)
    k1, k2 = _words(rng, 512), _words(rng, 512)
    idx = rng.integers(0, 2**31 - 1, 512).astype(np.int32)
    want = jtf.counter_bits(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(idx), 3)
    got = ttf.counter_bits(_t(k1), _t(k2), torch.from_numpy(idx), 3)
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("k", [1, 7, 128, 2**31 - 3])
def test_accept_draws_equal_the_reference(k):
    rng = np.random.default_rng(k % 1000)
    k1, k2 = _words(rng, 2048), _words(rng, 2048)
    idx = rng.integers(0, 2**31 - 1, 2048).astype(np.int32)
    js, ju1, ju2 = jrng.accept_draws_words(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(idx), k)
    ts, tu1, tu2 = trng.accept_draws_words(_t(k1), _t(k2), torch.from_numpy(idx), k)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ju1).view(np.int32), tu1.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(ju2).view(np.int32), tu2.numpy().view(np.int32))


@pytest.mark.parametrize("offset", [1.0, 0.5])
def test_uniform_from_bits_is_exact(offset):
    w = np.array([0, 1, 255, 256, 2**31, 2**32 - 256, 2**32 - 1], np.uint32)
    want = np.asarray(jrng.uniform_from_bits(jnp.asarray(w), offset))
    got = trng.uniform_from_bits(_t(w), offset).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 5, 2**31 - 1, -1, -7, 2**32 - 1, 2**33 + 5])
def test_key_from_seed_equals_jax_key(seed):
    _eq(jr.key_data(jr.key(seed)), trng.key_from_seed(seed))


@pytest.mark.parametrize("num", [1, 5, 64, 1000])
def test_split_keys_equal_jax_split(num):
    for seed in (0, 3, 2**32 - 1):
        want = jr.key_data(jr.split(jr.key(seed), num))
        _eq(want, trng.split_keys(trng.key_from_seed(seed), num))


def test_key_helpers_reject_bad_input():
    with pytest.raises(TypeError):
        trng.key_from_seed(1.5)
    with pytest.raises(ValueError):
        trng.split_keys(torch.zeros(3, dtype=torch.int64), 4)
