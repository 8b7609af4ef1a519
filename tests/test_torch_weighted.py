"""The port's weighted (A-ExpJ) update against the JAX package's, bit for
bit: ``reservoir_tpu_torch.ops.weighted`` (the plain version) and
``.weighted_cuda`` (the kernel's wrapper, which takes the plain version for
CPU tensors) against ``reservoir_tpu.ops.weighted`` (XLA, jitted) and
``weighted_pallas.update_pallas`` in interpret mode.  The tolerance is zero:
samples as 32-bit words, lkeys and xw as float32 bits, and count."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import rng as JR
from reservoir_tpu.ops import weighted as JW
from reservoir_tpu.ops import weighted_pallas as JWP
from reservoir_tpu_torch.convert import weighted_state_from_numpy, weighted_state_to_numpy
from reservoir_tpu_torch.ops import rng as TR
from reservoir_tpu_torch.ops import weighted as TW
from reservoir_tpu_torch.ops import weighted_cuda as TWK
from reservoir_tpu_torch.ops.rng import key_from_seed

_J_UPDATE = jax.jit(JW.update)
_J_STEADY = jax.jit(JW.update_steady)
_DTYPES = {"int32": (np.int32, torch.int32), "float32": (np.float32, torch.float32),
           "uint32": (np.uint32, torch.uint32)}
_FIELDS = ("samples", "lkeys", "count", "xw")


def _elems(rng, R, B, dtype="int32"):
    t = rng.integers(-(2**31), 2**31, (R, B), dtype=np.int64).astype(np.int32)
    if dtype == "float32":
        t[::3, 0] = np.int32(-(2**31))  # -0.0
        t[1::3, -1] = 0x7FC00001        # NaN with a payload
        t[2::3, B // 2] = -1            # 0xFFFFFFFF, a negative NaN
    return t.view(_DTYPES[dtype][0])


def _weights(rng, R, B, kind="lognormal"):
    """Nonnegative float32 weights whose prefix sums are not exact."""
    if kind == "integer":
        return rng.integers(1, 5, (R, B)).astype(np.float32)
    if kind == "heavy":  # Pareto tail: a few weights dwarf the rest
        return (rng.pareto(0.8, (R, B)) + 1e-3).astype(np.float32)
    w = rng.lognormal(0.0, 1.0, (R, B)).astype(np.float32)
    if kind == "zeros":
        w[rng.random((R, B)) < 0.3] = 0.0
    elif kind == "subnormal":
        # XLA CPU reads denormals as zero: these are zero weights there
        w[rng.random((R, B)) < 0.25] = np.float32(1e-40)
        w[:, ::17] = np.float32(1.4e-45)
        w[rng.random((R, B)) < 0.05] = np.float32(2e-38)  # tiny but normal
    return w


def assert_same(js, ts):
    """JAX weighted state == torch weighted state, every field, as bits."""
    for f in _FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jr.key_data(js.key)).astype(np.int64), ts.key.numpy())


def _to_torch(js):
    return weighted_state_from_numpy(
        np.asarray(js.samples), np.asarray(js.lkeys), np.asarray(js.count),
        np.asarray(js.xw), np.asarray(jr.key_data(js.key)), device="cpu",
    )


def _to_jax(arrays):
    return JW.WeightedState(
        jnp.asarray(arrays["samples"]), jnp.asarray(arrays["lkeys"]),
        jnp.asarray(arrays["count"]), jnp.asarray(arrays["xw"]),
        jr.wrap_key_data(jnp.asarray(arrays["key"])),
    )


def _pair(R, k, seed, dtype="int32"):
    np_dt, t_dt = _DTYPES[dtype]
    return (JW.init(jr.key(seed), R, k, sample_dtype=np_dt),
            TW.init(key_from_seed(seed), R, k, sample_dtype=t_dt))


def _step(js, ts, elems, weights, valid=None, fill=True):
    jfn, tfn = (_J_UPDATE, TW.update_accepts) if fill else (_J_STEADY, TW.update_accepts)
    js = jfn(js, jnp.asarray(elems), jnp.asarray(weights),
             None if valid is None else jnp.asarray(valid))
    ts, accepts = tfn(ts, torch.from_numpy(elems), torch.from_numpy(weights),
                      None if valid is None else torch.from_numpy(valid), fill=fill)
    return js, ts, accepts


@pytest.mark.parametrize("R, k", [(1, 1), (7, 5), (16, 64)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_init_equals_reference(R, k, dtype):
    js, ts = _pair(R, k, R * 31 + k, dtype)
    assert_same(js, ts)


def test_uniforms_equal_reference():
    n = 4096
    rng = np.random.default_rng(0)
    kd = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    idx[:4] = [0, 1, 2**31 - 1, -1]
    want = jax.jit(lambda kd, i: JR.uniforms(jr.wrap_key_data(kd), i, (3,)))(kd, idx)
    got = TR.uniforms(torch.from_numpy(kd[:, 0].astype(np.int64)),
                      torch.from_numpy(kd[:, 1].astype(np.int64)), torch.from_numpy(idx), 3)
    for j in range(3):
        np.testing.assert_array_equal(np.asarray(want[j]).view(np.int32), got[j].numpy().view(np.int32))
    assert (got[0] > 0).all() and (got[0] <= 1).all()


@pytest.mark.parametrize("R, k, B", [(8, 16, 64), (16, 8, 32), (8, 64, 128), (16, 1, 200),
                                     (8, 5, 256)])
def test_from_empty_fill_completion_and_first_acceptances(R, k, B):
    rng = np.random.default_rng(R * k + B)
    js, ts = _pair(R, k, seed=B)
    elems = np.broadcast_to(np.arange(B, dtype=np.int32), (R, B)).copy()
    js, ts, accepts = _step(js, ts, elems, _weights(rng, R, B))
    assert_same(js, ts)
    assert (ts.count == B).all()
    if B > 2 * k:
        assert accepts > 0 and torch.isfinite(ts.xw).all()


@pytest.mark.parametrize("kind", ["lognormal", "zeros", "subnormal", "heavy", "integer"])
@pytest.mark.parametrize("k", [5, 64])
def test_multi_tile_chain_across_the_fill_end(kind, k):
    # a partial fill, the tile that completes it, steady tiles, then ragged
    # tiles whose valid counts include 0 and B
    R = 16
    rng = np.random.default_rng(k)
    js, ts = _pair(R, k, seed=k + 1)
    plan = [(32, None), (200, None), (256, None), (256, "ragged"), (128, "ragged")]
    total = 0
    for width, ragged in plan:
        valid = None
        if ragged:
            valid = rng.integers(0, width + 1, R).astype(np.int32)
            valid[:2] = [0, width]
        js, ts, accepts = _step(js, ts, _elems(rng, R, width), _weights(rng, R, width, kind),
                                valid)
        assert_same(js, ts)
        total += accepts
    assert total > 0
    (a, asz), (b, bsz) = JW.result(js), TW.result(ts)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(asz), bsz.numpy())
    if kind in ("zeros", "subnormal"):
        # zero (and denormal) weights are counted and never sampled
        assert (bsz <= k).all() and (ts.count.numpy() >= bsz.numpy()).all()


@pytest.mark.parametrize("dtype", ["float32", "uint32"])
def test_sample_words_survive_as_bits(dtype):
    R, k, B = 12, 8, 64
    rng = np.random.default_rng(3)
    js, ts = _pair(R, k, seed=5, dtype=dtype)
    for _ in range(3):
        elems = _elems(rng, R, B, "float32").view(_DTYPES[dtype][0])
        js, ts, _ = _step(js, ts, elems, _weights(rng, R, B, "zeros"))
        assert_same(js, ts)
    words = ts.samples.view(torch.int32)
    if dtype == "float32":
        assert (words == -(2**31)).any() or (words == 0x7FC00001).any() or (words == -1).any()


def test_ragged_valid_of_zero_and_of_b():
    R, k, B = 8, 4, 96
    rng = np.random.default_rng(4)
    js, ts = _pair(R, k, seed=6)
    for valid in (np.zeros(R, np.int32), np.full(R, B, np.int32),
                  np.array([0, B, 1, 2, 3, B - 1, 50, 0], np.int32)):
        js, ts, _ = _step(js, ts, _elems(rng, R, B), _weights(rng, R, B, "zeros"), valid)
        assert_same(js, ts)


def test_update_steady_equals_reference():
    R, k, B = 16, 6, 128
    rng = np.random.default_rng(5)
    js, ts = _pair(R, k, seed=7)
    js, ts, _ = _step(js, ts, _elems(rng, R, B), _weights(rng, R, B))
    for ragged in (False, True):
        valid = rng.integers(0, B + 1, R).astype(np.int32) if ragged else None
        js, ts, _ = _step(js, ts, _elems(rng, R, B), _weights(rng, R, B), valid, fill=False)
        assert_same(js, ts)


def test_the_conditional_key_is_the_contracted_fma(monkeypatch):
    # XLA compiles r2 = t + u1 * (1 - t) into fma(u1, 1 - t, t); the
    # unfused expression forks the chain's keys within a few hundred
    # acceptances, so this chain tells the two apart
    R, k, B = 16, 64, 256
    rng = np.random.default_rng(6)
    tiles = [(_elems(rng, R, B), _weights(rng, R, B)) for _ in range(3)]

    def run():
        js, ts = _pair(R, k, seed=8)
        for elems, weights in tiles:
            js, ts, _ = _step(js, ts, elems, weights)
        return js, ts

    js, ts = run()
    assert_same(js, ts)
    monkeypatch.setattr(TW, "_conditional", lambda u1, t: t + u1 * (1.0 - t))
    _, unfused = run()
    differs = (np.asarray(js.lkeys).view(np.int32) != unfused.lkeys.numpy().view(np.int32))
    assert differs.any()


@pytest.mark.parametrize("R, k, B, chunk_b, kind", [
    (8, 16, 64, None, "lognormal"),
    (8, 64, 128, None, "zeros"),
    (8, 8, 256, 128, "zeros"),   # two chunks: the carried prefix sum
    (16, 5, 256, 128, "heavy"),
])
def test_against_the_pallas_kernel_in_interpret_mode(R, k, B, chunk_b, kind):
    rng = np.random.default_rng(B + k)
    js, ts = _pair(R, k, seed=9)
    for _ in range(3):
        elems, weights = _elems(rng, R, B), _weights(rng, R, B, kind)
        js = JWP.update_pallas(js, jnp.asarray(elems), jnp.asarray(weights), block_r=8,
                               chunk_b=chunk_b, interpret=True)
        ts = TWK.update_cuda(ts, torch.from_numpy(elems), torch.from_numpy(weights))
        assert_same(js, ts)


def test_result_and_convert_round_trip():
    R, k, B = 6, 5, 16
    rng = np.random.default_rng(7)
    js, ts = _pair(R, k, seed=2)
    valid = np.array([0, 1, 4, 5, 6, 16], np.int32)
    weights = _weights(rng, R, B, "zeros")
    js, ts, _ = _step(js, ts, _elems(rng, R, B), weights, valid)
    (a, asz), (b, bsz) = JW.result(js), TW.result(ts)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(asz), bsz.numpy())
    assert_same(js, _to_torch(js))
    assert_same(_to_jax(weighted_state_to_numpy(ts)), ts)
    with pytest.raises(ValueError, match="lkeys"):
        weighted_state_from_numpy(b.numpy(), np.zeros((R, k + 1), np.float32), np.zeros(R),
                                  np.zeros(R), np.zeros((R, 2), np.uint32), device="cpu")


def test_kernel_module_on_cpu_equals_plain_version_and_counts_no_launch():
    R, k, B = 16, 8, 64
    rng = np.random.default_rng(8)
    before = TWK.launches
    a = b = TW.init(key_from_seed(3), R, k)
    for i in range(3):
        elems = torch.from_numpy(_elems(rng, R, B))
        weights = torch.from_numpy(_weights(rng, R, B, "zeros"))
        valid = torch.from_numpy(rng.integers(0, B + 1, R).astype(np.int32)) if i == 2 else None
        a = TWK.update_cuda(a, elems, weights, valid)
        b = TW.update(b, elems, weights, valid)
        for f in _FIELDS:
            assert torch.equal(getattr(a, f).view(torch.int32), getattr(b, f).view(torch.int32))
    assert TWK.launches == before


@pytest.mark.parametrize("bad", ["elems_dtype", "elems_rows", "weights_dtype", "weights_shape",
                                 "valid_dtype", "key_dtype", "lkeys_shape", "xw_dtype",
                                 "non_contiguous"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    R, k, B = 4, 2, 8
    s = TW.init(key_from_seed(0), R, k)
    elems = torch.zeros((R, B), dtype=torch.int32)
    weights = torch.ones((R, B), dtype=torch.float32)
    valid = None
    if bad == "elems_dtype":
        elems = elems.float()
    elif bad == "elems_rows":
        elems = torch.zeros((R + 1, B), dtype=torch.int32)
    elif bad == "weights_dtype":
        weights = weights.double()
    elif bad == "weights_shape":
        weights = torch.ones((R, B + 1))
    elif bad == "valid_dtype":
        valid = torch.zeros(R, dtype=torch.int64)
    elif bad == "key_dtype":
        s = s._replace(key=s.key.to(torch.int32))
    elif bad == "lkeys_shape":
        s = s._replace(lkeys=s.lkeys[:, :1].contiguous())
    elif bad == "xw_dtype":
        s = s._replace(xw=s.xw.double())
    elif bad == "non_contiguous":
        weights = torch.ones((B, R)).t()
    with pytest.raises(ValueError):
        TWK.update_cuda(s, elems, weights, valid)
