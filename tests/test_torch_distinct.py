"""The port's distinct (bottom-k) update against the JAX package's, bit for
bit: ``reservoir_tpu_torch.ops.distinct`` (the plain version) and
``.distinct_cuda`` (the kernel's wrapper, which takes the plain version for
CPU tensors) against ``reservoir_tpu.ops.distinct`` (XLA, jitted) and
``distinct_pallas.update_pallas`` in interpret mode.  The tolerance is zero
on every field: values, value_hi, hash_hi, hash_lo, size and count.  The one
place the two JAX paths part, a lane whose hash is exactly (MAX, MAX), is
pinned: the port follows the Pallas kernel there."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import distinct_pallas as JDP
from reservoir_tpu_torch.convert import distinct_state_from_numpy, distinct_state_to_numpy
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import distinct_cuda as TDK
from reservoir_tpu_torch.ops.hashing import salt_for_target
from reservoir_tpu_torch.ops.rng import key_from_seed

_J_UPDATE = jax.jit(JD.update)
_NP = {"int32": np.int32, "uint32": np.uint32, "int64": np.int64}
_TORCH = {"int32": torch.int32, "uint32": torch.uint32, "int64": torch.int64}
_FIELDS = ("values", "hash_hi", "hash_lo", "size", "count", "value_hi")


def _tile(rng, R, B, dtype, kind):
    """Keys of ``dtype``: ``few`` (fewer distinct values than a row holds),
    ``negative`` (random, both signs), ``zipf`` (heavy duplication, as the
    benchmark's keys) or ``random``."""
    if kind == "few":
        t = rng.integers(-3, 3, (R, B))
    elif kind == "negative":
        t = -rng.integers(1, 2**31, (R, B))
    elif kind == "zipf":
        u = rng.uniform(1e-6, 1.0, (R, B))
        t = np.minimum(u ** -10.0, 1e7).astype(np.int64)
    else:
        t = rng.integers(-(2**62), 2**62, (R, B))
    t = t.astype(np.int64)
    if dtype == "int64":
        # spread the keys over both words, keeping which ones are equal
        return (t * np.int64(0x9E3779B97F4A7C15 - 2**64)).astype(np.int64)
    return t.astype(np.int32).view(_NP[dtype]) if dtype != "int32" else t.astype(np.int32)


def _jax_batch(tile):
    if tile.dtype == np.int64:
        hi, lo = JD.split_values_host(tile)
        return jnp.asarray(hi), jnp.asarray(lo)
    return jnp.asarray(tile)


def _to_torch(js):
    return distinct_state_from_numpy(
        *(None if getattr(js, f) is None else np.asarray(getattr(js, f))
          for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts", "value_hi")),
        device="cpu",
    )


def _to_jax(ts):
    host = distinct_state_to_numpy(ts)
    return JD.DistinctState(**{f: None if a is None else jnp.asarray(a) for f, a in host.items()})


def assert_same(js, ts):
    """JAX distinct state == torch distinct state, every field, as bits and
    in the JAX package's dtypes."""
    host = distinct_state_to_numpy(ts)
    for f in _FIELDS + ("salts",):
        a = getattr(js, f)
        if a is None:
            assert host[f] is None, f
            continue
        a = np.asarray(a)
        assert a.dtype == host[f].dtype, f
        np.testing.assert_array_equal(a, host[f], err_msg=f)


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
@pytest.mark.parametrize("B", [32, 128])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("R", [8, 13])
def test_update_equals_xla_and_pallas(R, k, B, dtype):
    """A chain from empty: an underfilled row, negative keys, heavy
    duplication; the XLA path at every tile and the Pallas kernel (in
    interpret mode, the tile cut into chunks when B = 128) on the last."""
    rng = np.random.default_rng(R * 1000 + k * 10 + B)
    js = JD.init(jr.key(R + k), R, k, sample_dtype=jnp.dtype(dtype))
    ts = TD.init(key_from_seed(R + k), R, k, sample_dtype=_TORCH[dtype])
    assert_same(js, ts)
    for kind in ("few", "negative", "zipf"):
        tile = _tile(rng, R, B, dtype, kind)
        before = ts
        js = _J_UPDATE(js, _jax_batch(tile))
        ts = TD.update(ts, torch.from_numpy(tile))
        assert_same(js, ts)
    pallas = JDP.update_pallas(_to_jax(before), _jax_batch(tile), block_r=8,
                               chunk_b=B // 4 if B == 128 else None, interpret=True)
    assert_same(pallas, ts)


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
def test_ragged_valid_equals_xla(dtype):
    # Pallas takes no valid: ragged tiles are held against XLA only
    R, k, B = 13, 8, 32
    rng = np.random.default_rng(5)
    js = JD.init(jr.key(2), R, k, sample_dtype=jnp.dtype(dtype))
    ts = TD.init(key_from_seed(2), R, k, sample_dtype=_TORCH[dtype])
    for kind in ("few", "random", "zipf", "negative"):
        tile = _tile(rng, R, B, dtype, kind)
        valid = rng.integers(0, B + 1, R).astype(np.int32)
        valid[:2] = (0, B)
        js = _J_UPDATE(js, _jax_batch(tile), jnp.asarray(valid))
        ts = TDK.update_cuda(ts, torch.from_numpy(tile), torch.from_numpy(valid))
        assert_same(js, ts)


def test_wide_tile_as_planes_or_as_int64_gives_one_state():
    R, k, B = 8, 8, 32
    rng = np.random.default_rng(6)
    tile = _tile(rng, R, B, "int64", "random")
    s = TD.init(key_from_seed(1), R, k, sample_dtype=torch.int64)
    a = TD.update(s, torch.from_numpy(tile))
    b = TD.update(s, TD.split_values(tile))
    c = TD.update(s, torch.from_numpy(tile.view(np.uint64)))
    for x in (b, c):
        for f in _FIELDS:
            assert torch.equal(getattr(a, f), getattr(x, f)), f


def _planted(wide: bool):
    """A state whose rows 0, 2 and 5 scramble the value 77 to (MAX, MAX),
    and a tile holding 77 in every row; k > B, so no row fills."""
    R, k, B = 8, 64, 32
    dtype = jnp.int64 if wide else jnp.int32
    js = JD.init(jr.key(9), R, k, sample_dtype=dtype)
    salts = np.asarray(js.salts).copy()
    for r in (0, 2, 5):
        r1 = salt_for_target((0, 77), (0xFFFFFFFF, 0xFFFFFFFF), (int(salts[r, 0]), int(salts[r, 1])))
        salts[r, 2:] = r1
    js = js._replace(salts=jnp.asarray(salts))
    rng = np.random.default_rng(7)
    tile = rng.integers(1000, 1 << 20, (R, B)).astype(np.int64 if wide else np.int32)
    tile[:, 3] = 77
    return js, tile


@pytest.mark.parametrize("wide", [False, True])
def test_a_hash_of_max_max_is_never_taken(wide):
    js, tile = _planted(wide)
    batch = _jax_batch(tile)
    xla = _J_UPDATE(js, batch)
    pallas = JDP.update_pallas(js, batch, block_r=8, interpret=True)
    port = TD.update(_to_torch(js), torch.from_numpy(tile))
    # the XLA sort-merge keeps 77 in the planted rows (they are not full)...
    held = np.asarray(xla.values) == 77
    assert held[[0, 2, 5]].any(axis=1).all()
    # ...the Pallas kernel and the port never take it
    ported = distinct_state_to_numpy(port)
    assert not (ported["values"][[0, 2, 5]] == 77).any()
    assert (ported["size"][[0, 2, 5]] == np.asarray(xla.size)[[0, 2, 5]] - 1).all()
    assert_same(pallas, port)
    # the other rows are the same on all three paths
    for f in ("values", "hash_hi", "hash_lo", "size"):
        rows = [1, 3, 4, 6, 7]
        np.testing.assert_array_equal(np.asarray(getattr(xla, f))[rows], ported[f][rows])


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    R, k, B = 8, 8, 32
    tile = torch.from_numpy(_tile(np.random.default_rng(8), R, B, "int32", "zipf"))
    s = TD.init(key_from_seed(3), R, k)
    before = TDK.launches
    got = TDK.update_cuda(s, tile)
    want = TD.update(s, tile)
    assert TDK.launches == before
    for f in _FIELDS:
        assert (getattr(got, f) is None and getattr(want, f) is None) or torch.equal(
            getattr(got, f), getattr(want, f))


def test_the_wrapper_checks_its_inputs():
    R, k, B = 4, 4, 8
    s = TD.init(key_from_seed(0), R, k)
    with pytest.raises(ValueError, match="dtype"):
        TDK.update_cuda(s, torch.zeros((R, B), dtype=torch.int64))
    with pytest.raises(ValueError, match="not planes"):
        TDK.update_cuda(s, (torch.zeros((R, B), dtype=torch.int32),) * 2)
    with pytest.raises(ValueError, match=r"must be \[R=4"):
        TDK.update_cuda(s, torch.zeros((R + 1, B), dtype=torch.int32))
    w = TD.init(key_from_seed(0), R, k, sample_dtype=torch.int64)
    with pytest.raises(ValueError, match="int64/uint64"):
        TDK.update_cuda(w, torch.zeros((R, B), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        TDK.update_cuda(w, torch.zeros((R, 2 * B), dtype=torch.int64)[:, ::2])
    with pytest.raises(ValueError, match="valid"):
        TDK.update_cuda(s, torch.zeros((R, B), dtype=torch.int32), torch.zeros(R, dtype=torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.float64])
def test_init_rejects_what_the_jax_package_rejects(dtype):
    with pytest.raises(ValueError, match="32- or 64-bit integer"):
        TD.init(key_from_seed(0), 2, 2, sample_dtype=dtype)
    with pytest.raises(ValueError, match="32- or 64-bit integer"):
        JD.init(jr.key(0), 2, 2, sample_dtype={torch.float32: jnp.float32, torch.int16: jnp.int16,
                                               torch.float64: jnp.float32}[dtype])


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_split_and_assemble_equal_the_jax_package(dtype):
    v = np.random.default_rng(9).integers(0, 2**64, (5, 7), dtype=np.uint64).view(dtype)
    for a, b in zip(TD.split_values_host(v), JD.split_values_host(v)):
        np.testing.assert_array_equal(a, b)
    hi, lo = TD.split_values(v)
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(TD.assemble_values(lo, hi, dtype), v)
    np.testing.assert_array_equal(
        TD.assemble_values(lo, hi, dtype), JD.assemble_values(lo.numpy().view(np.uint32),
                                                              hi.numpy().view(np.uint32), dtype))
    narrow = v.astype(np.int32)
    np.testing.assert_array_equal(TD.assemble_values(torch.from_numpy(narrow), None, np.int32), narrow)


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
def test_state_round_trips_through_numpy(dtype):
    R, k, B = 6, 5, 16
    js = _J_UPDATE(JD.init(jr.key(4), R, k, sample_dtype=jnp.dtype(dtype)),
                   _jax_batch(_tile(np.random.default_rng(10), R, B, dtype, "zipf")))
    ts = _to_torch(js)
    assert ts.wide == (dtype == "int64")
    assert ts.hash_hi.dtype == torch.int32 and ts.salts.dtype == torch.int32
    assert_same(js, ts)
    assert_same(_to_jax(ts), ts)
    with pytest.raises(ValueError, match="hash_hi must be uint32"):
        distinct_state_from_numpy(np.asarray(js.values), np.zeros((R, k + 1), np.uint32),
                                  np.asarray(js.hash_lo), np.asarray(js.size),
                                  np.asarray(js.count), np.asarray(js.salts),
                                  None if js.value_hi is None else np.asarray(js.value_hi),
                                  device="cpu")


def _permuted_rows(rng, tile, valid):
    """Each row's valid lanes in a random order (the lanes past valid stay)."""
    out = tile.copy()
    for r, v in enumerate(valid):
        out[r, :v] = tile[r, rng.permutation(v)]
    return out


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_the_state_is_a_function_of_the_set_of_keys(dtype, k, split):
    """What the CUDA kernel's design rests on: permuting the lanes of each
    row (and, with ``split``, feeding the tile as two tiles) leaves the
    plain version's state bit-identical, and the JAX package's XLA update on
    the permuted (split) inputs gives the same state.  A Zipf tile with many
    repeats and ragged valid counts, over a state that already holds keys."""
    R, B = 8, 64
    rng = np.random.default_rng(100 + k)
    js = JD.init(jr.key(k), R, k, sample_dtype=jnp.dtype(dtype))
    ts = TD.init(key_from_seed(k), R, k, sample_dtype=_TORCH[dtype])
    first = _tile(rng, R, B, dtype, "random")
    js = _J_UPDATE(js, _jax_batch(first))
    ts = TD.update(ts, torch.from_numpy(first))
    assert_same(js, ts)
    tile = _tile(rng, R, B, dtype, "zipf")
    tile[:, 1::4] = tile[:, :1]  # a key repeated in every fourth lane
    valid = rng.integers(0, B + 1, R).astype(np.int32)
    valid[:2] = (0, B)
    want = TD.update(ts, torch.from_numpy(tile), torch.from_numpy(valid))
    perm = _permuted_rows(rng, tile, valid)
    if split:
        cut = B // 3
        parts = [(np.ascontiguousarray(perm[:, :cut]), np.minimum(valid, cut).astype(np.int32)),
                 (np.ascontiguousarray(perm[:, cut:]), np.maximum(valid - cut, 0).astype(np.int32))]
    else:
        parts = [(perm, valid)]
    got, jgot = ts, js
    for part, v in parts:
        got = TD.update(got, torch.from_numpy(part), torch.from_numpy(v))
        jgot = _J_UPDATE(jgot, _jax_batch(part), jnp.asarray(v))
    for f in _FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert_same(jgot, got)
