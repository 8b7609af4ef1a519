"""The port's Algorithm-L state against the JAX package's, bit for bit:
``reservoir_tpu_torch.ops.algorithm_l`` (the plain version) and
``.algorithm_l_cuda`` (the kernel's wrapper, which takes the plain version
for CPU tensors) against ``reservoir_tpu.ops.algorithm_l`` (XLA) and
``algorithm_l_pallas`` in interpret mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import algorithm_l as J
from reservoir_tpu.ops import algorithm_l_pallas as JP
from reservoir_tpu_torch.convert import state_from_numpy, state_to_numpy
from reservoir_tpu_torch.ops import algorithm_l as T
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops.rng import key_from_seed

_J_UPDATE = jax.jit(J.update)
_J_STEADY = jax.jit(J.update_steady)
_DTYPES = {"int32": (np.int32, torch.int32), "float32": (np.float32, torch.float32)}


def _tile(rng, R, B, dtype):
    t = rng.integers(-(2**31), 2**31, (R, B), dtype=np.int64).astype(np.int32)
    if dtype == "float32":
        t[::3, 0] = np.int32(-(2**31))  # -0.0
        t[1::3, -1] = 0x7FC00001        # NaN with a payload
    return t.view(_DTYPES[dtype][0])


def assert_same(js, ts):
    """JAX state == torch state, every field, as bits."""
    for f in ("samples", "count", "nxt", "log_w"):
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(jr.key_data(js.key)).astype(np.int64), ts.key.numpy()
    )


def _to_torch(js):
    return state_from_numpy(
        np.asarray(js.samples), np.asarray(js.count), np.asarray(js.nxt),
        np.asarray(js.log_w), np.asarray(jr.key_data(js.key)), device="cpu",
    )


def _to_jax(arrays):
    return J.ReservoirState(
        jnp.asarray(arrays["samples"]), jnp.asarray(arrays["count"]),
        jnp.asarray(arrays["nxt"]), jnp.asarray(arrays["log_w"]),
        jr.wrap_key_data(jnp.asarray(arrays["key"])),
    )


@pytest.mark.parametrize("R, k", [(1, 1), (7, 3), (64, 16), (64, 13)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_init_equals_reference(R, k, dtype):
    np_dt, t_dt = _DTYPES[dtype]
    js = J.init(jr.key(R * 31 + k), R, k, sample_dtype=np_dt)
    ts = T.init(key_from_seed(R * 31 + k), R, k, sample_dtype=t_dt)
    assert_same(js, ts)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_fill_partial_fill_steady_ragged_chain(dtype):
    R, k, B = 64, 13, 256
    rng = np.random.default_rng(1)
    js = J.init(jr.key(4), R, k, sample_dtype=_DTYPES[dtype][0])
    ts = T.init(key_from_seed(4), R, k, sample_dtype=_DTYPES[dtype][1])
    # partial fill, crossing the fill boundary, steady, ragged steady,
    # ragged with fill
    for width, ragged, fill in [(5, False, True), (B, False, True), (B, False, False),
                                (B, True, False), (B, True, True)]:
        tile = _tile(rng, R, width, dtype)
        valid = rng.integers(0, width + 1, R).astype(np.int32) if ragged else None
        jfn, tfn = (_J_UPDATE, T.update) if fill else (_J_STEADY, T.update_steady)
        js = jfn(js, jnp.asarray(tile), None if valid is None else jnp.asarray(valid))
        ts = tfn(ts, torch.from_numpy(tile), None if valid is None else torch.from_numpy(valid))
        assert_same(js, ts)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_against_the_pallas_kernel_in_interpret_mode(dtype):
    R, k, B = 16, 6, 64
    rng = np.random.default_rng(2)
    js = J.init(jr.key(6), R, k, sample_dtype=_DTYPES[dtype][0])
    ts = T.init(key_from_seed(6), R, k, sample_dtype=_DTYPES[dtype][1])
    for i in range(3):
        tile = _tile(rng, R, B, dtype)
        pallas = JP.update_pallas if i == 0 else JP.update_steady_pallas
        js = pallas(js, jnp.asarray(tile), interpret=True)
        ts = (TK.update_cuda if i == 0 else TK.update_steady_cuda)(ts, torch.from_numpy(tile))
        assert_same(js, ts)


def test_multi_tile_chain_deep_into_steady_state():
    R, k, B = 32, 5, 128
    rng = np.random.default_rng(3)
    js = J.init(jr.key(8), R, k)
    ts = T.init(key_from_seed(8), R, k)
    for i in range(12):
        tile = _tile(rng, R, B, "int32")
        js = (_J_UPDATE if i == 0 else _J_STEADY)(js, jnp.asarray(tile))
        ts = (T.update if i == 0 else T.update_steady)(ts, torch.from_numpy(tile))
    assert_same(js, ts)


def test_tile_split_invariance():
    R, k, N = 8, 4, 300
    rng = np.random.default_rng(4)
    stream = _tile(rng, R, N, "int32")
    whole = T.update(T.init(key_from_seed(9), R, k), torch.from_numpy(stream))
    # ragged splits: row r takes its own cut points, padded tiles + valid
    ts = T.init(key_from_seed(9), R, k)
    cuts = np.sort(rng.integers(0, N, (R, 6)), axis=1)
    cuts = np.concatenate([np.zeros((R, 1), int), cuts, np.full((R, 1), N)], axis=1)
    for j in range(cuts.shape[1] - 1):
        width = int((cuts[:, j + 1] - cuts[:, j]).max()) or 1
        tile = np.zeros((R, width), np.int32)
        valid = (cuts[:, j + 1] - cuts[:, j]).astype(np.int32)
        for r in range(R):
            tile[r, : valid[r]] = stream[r, cuts[r, j] : cuts[r, j + 1]]
        ts = T.update(ts, torch.from_numpy(tile), torch.from_numpy(valid))
    for f in ("samples", "count", "nxt", "log_w"):
        assert torch.equal(getattr(whole, f).view(torch.int32), getattr(ts, f).view(torch.int32))
    js = _J_UPDATE(J.init(jr.key(9), R, k), jnp.asarray(stream))
    assert_same(js, whole)


def _edge_state(R, k, log_w, nxt, count, key_words):
    rng = np.random.default_rng(5)
    return dict(
        samples=rng.integers(0, 100, (R, k)).astype(np.int32),
        count=np.full(R, count, np.int32), nxt=np.full(R, nxt, np.int32),
        log_w=np.full(R, log_w, np.float32),
        key=np.tile(np.asarray(key_words, np.uint32), (R, 1)),
    )


@pytest.mark.parametrize(
    "case, log_w, count, nxt, key",
    [
        # W rounds to 1.0: log1p(-1) = -inf, skip 0 (every element accepted)
        ("w_is_one", -1e-9, 100, 101, (1, 2)),
        # W underflows to 0: skip +inf, clamped to 2^30
        ("w_is_zero", -110.0, 100, 101, (3, 4)),
        # u2 == 1.0 exactly at index 22370 under this key, with W == 0:
        # log(u2) / log1p(-0) = 0 / -0 = NaN, which XLA converts to 0
        ("nan_skip", -110.0, 22300, 22370, (0x12345678, 0x9ABCDEF0)),
        # W > 1 (outside the algorithm's domain): log1p(-W) is NaN
        ("w_above_one", 1.0, 100, 101, (5, 6)),
        # nxt saturates at int32 max instead of wrapping
        ("saturation", -40.0, 2**31 - 200, 2**31 - 150, (7, 8)),
    ],
)
@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_numeric_edges(case, log_w, count, nxt, key, path):
    R, k, B = 8, 4, 128
    arrays = _edge_state(R, k, log_w, nxt, count, key)
    tile = _tile(np.random.default_rng(6), R, B, "int32")
    ts = state_from_numpy(arrays["samples"], arrays["count"], arrays["nxt"],
                          arrays["log_w"], arrays["key"], device="cpu")
    js = _to_jax(arrays)
    if path == "xla":
        js = _J_STEADY(js, jnp.asarray(tile))
    else:
        js = JP.update_steady_pallas(js, jnp.asarray(tile), interpret=True)
    ts = TK.update_steady_cuda(ts, torch.from_numpy(tile))
    assert_same(js, ts)
    if case == "saturation":
        assert (ts.nxt == 2**31 - 1).all()
    if case == "w_is_one":
        # the first acceptance sees W == 1.0 and skips nothing
        k1, k2 = ts.key[:, 0], ts.key[:, 1]
        idx = torch.full((R,), nxt, dtype=torch.int32)
        lw = torch.from_numpy(arrays["log_w"])
        _, _, n1 = T._advance_words(lw, idx, k1, k2, idx, k)
        _, _, jn1 = J._advance_words(jnp.asarray(arrays["log_w"]), jnp.asarray(idx.numpy()),
                                     jnp.asarray(arrays["key"][:, 0]),
                                     jnp.asarray(arrays["key"][:, 1]), jnp.asarray(idx.numpy()), k)
        assert (n1 == nxt + 1).all()
        np.testing.assert_array_equal(np.asarray(jn1), n1.numpy())


def _one_accept_at_a_time(ts, tile, fill):
    """The samples a tile leaves, walked one row and one acceptance at a
    time with each write made at once (after the fill's copy): a later
    accept to a slot overwrites an earlier one."""
    samples = ts.samples.clone().view(torch.int32)
    bits = torch.from_numpy(tile).view(torch.int32)
    B = tile.shape[1]
    for r in range(ts.samples.shape[0]):
        c, n, lw = int(ts.count[r]), ts.nxt[r : r + 1], ts.log_w[r : r + 1]
        k1, k2 = ts.key[r : r + 1, 0], ts.key[r : r + 1, 1]
        if fill:
            for j in range(max(0, min(B, ts.k - c))):
                samples[r, c + j] = bits[r, j]
        while int(n) <= c + B:
            slot, lw, n_new = T._advance_words(lw, n, k1, k2, n, ts.k)
            samples[r, int(slot)] = bits[r, int(n) - c - 1]
            n = n_new
    return samples


@pytest.mark.parametrize("start", ["count 0", "w_is_one"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_accepts_keep_the_latest_write_to_a_slot(k, start):
    """Tiny k, where accepts come densely and overwrite slots that earlier
    accepts of the same tile took (k = 1: every accept after the first):
    the plain version equals XLA and the Pallas kernel in interpret mode,
    and its samples equal a walk that writes each accept at once, in order,
    so the latest accept to a slot wins.  From an empty reservoir (a fill
    tile, then steady tiles) and from W = 1, where the first element is
    accepted (steady tiles)."""
    R, B = 8, 64
    rng = np.random.default_rng(20 + k)
    if start == "count 0":
        js = J.init(jr.key(k), R, k)
        ts = T.init(key_from_seed(k), R, k)
    else:
        arrays = _edge_state(R, k, -1e-9, 101, 100, (11, 12))  # nxt 101, count 100
        js, ts = _to_jax(arrays), state_from_numpy(
            arrays["samples"], arrays["count"], arrays["nxt"], arrays["log_w"], arrays["key"],
            device="cpu")
    for i in range(3):
        tile = _tile(rng, R, B, "int32")
        fill = start == "count 0" and i == 0
        pallas = JP.update_pallas if fill else JP.update_steady_pallas
        xla = (_J_UPDATE if fill else _J_STEADY)(js, jnp.asarray(tile))
        js = pallas(js, jnp.asarray(tile), interpret=True)
        walked = _one_accept_at_a_time(ts, tile, fill)
        ts, accepts = T.update_accepts(ts, torch.from_numpy(tile), fill=fill)
        assert_same(xla, ts)
        assert_same(js, ts)
        assert torch.equal(ts.samples.view(torch.int32), walked)
        if i == 0:
            assert accepts > R * k  # more accepts than slots: slots are overwritten


@pytest.mark.parametrize("k", [1, 3, 7, 100, 128, 65537, 2**24 + 1, 2**31 - 3])
def test_advance_words_equals_xla_for_any_k(k):
    # XLA folds log(u1) / k into fma(log(u1), f32(1/k), log_w): a power of
    # two hides the difference, any other k shows it within a few lanes
    n = 32768
    rng = np.random.default_rng(k % 997)
    k1, k2 = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    idx = rng.integers(1, 2**31 - 1, n).astype(np.int32)
    lw = (-rng.exponential(3.0, n)).astype(np.float32)
    lw[:256] = -rng.uniform(0.0, 1e-6, 256).astype(np.float32)  # W near 1
    fn = jax.jit(lambda a, b, c, d: J._advance_words(a, b, c, d, b, k))
    want = fn(lw, idx, k1, k2)
    got = T._advance_words(torch.from_numpy(lw), torch.from_numpy(idx),
                           torch.from_numpy(k1.astype(np.int64)),
                           torch.from_numpy(k2.astype(np.int64)), torch.from_numpy(idx), k)
    for name, a, b in zip(("slot", "log_w", "nxt"), want, got):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32),
                                      err_msg=name)


def test_result_equals_reference():
    R, k = 6, 5
    js = J.init(jr.key(1), R, k)
    ts = T.init(key_from_seed(1), R, k)
    valid = np.array([0, 1, 4, 5, 6, 3], np.int32)
    tile = np.arange(R * 8, dtype=np.int32).reshape(R, 8)
    js = _J_UPDATE(js, jnp.asarray(tile), jnp.asarray(valid))
    ts = T.update(ts, torch.from_numpy(tile), torch.from_numpy(valid))
    (a, asz), (b, bsz) = J.result(js), T.result(ts)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(asz), bsz.numpy())


def test_convert_round_trip():
    js = _J_UPDATE(J.init(jr.key(2), 4, 3), jnp.arange(40, dtype=jnp.int32).reshape(4, 10))
    ts = _to_torch(js)
    assert_same(js, ts)
    assert_same(_to_jax(state_to_numpy(ts)), ts)


def test_kernel_module_on_cpu_equals_plain_version_and_counts_no_launch():
    R, k, B = 16, 8, 64
    rng = np.random.default_rng(7)
    before = TK.launches
    a = b = T.init(key_from_seed(3), R, k)
    for i in range(3):
        tile = torch.from_numpy(_tile(rng, R, B, "int32"))
        valid = torch.from_numpy(rng.integers(0, B + 1, R).astype(np.int32)) if i == 2 else None
        a = TK.update_cuda(a, tile, valid)
        b = T.update(b, tile, valid)
        for f in ("samples", "count", "nxt", "log_w"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert TK.launches == before


@pytest.mark.parametrize("bad", ["batch_dtype", "batch_rows", "valid_dtype", "key_dtype",
                                 "count_dtype", "samples_dtype", "non_contiguous"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    R, k, B = 4, 2, 8
    s = T.init(key_from_seed(0), R, k)
    tile = torch.zeros((R, B), dtype=torch.int32)
    valid = None
    if bad == "batch_dtype":
        tile = tile.float()
    elif bad == "batch_rows":
        tile = torch.zeros((R + 1, B), dtype=torch.int32)
    elif bad == "valid_dtype":
        valid = torch.zeros(R, dtype=torch.int64)
    elif bad == "key_dtype":
        s = s._replace(key=s.key.to(torch.int32))
    elif bad == "count_dtype":
        s = s._replace(count=s.count.long())
    elif bad == "samples_dtype":
        s = s._replace(samples=s.samples.long())
        tile = tile.long()
    elif bad == "non_contiguous":
        tile = torch.zeros((B, R), dtype=torch.int32).t()
    with pytest.raises(ValueError):
        TK.update_cuda(s, tile, valid)
