"""The fused stream, ``ReservoirEngine.sample_stream(fused=True)``, which
the port feeds tile by tile, one launch a tile.  On the CPU it must equal
the port's per-tile path and the JAX
package's fused path (its ``lax.scan``), bit for bit, in every mode: uniform
with int32 and WIDE counters, weighted, distinct with 4- and 8-byte keys,
and with the hooks (``tests/test_engine.py``'s
``test_sample_stream_fused_bit_identical_all_modes`` and
``tests/test_faults.py``'s fused case)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu_torch import ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import distinct_cuda as TDK
from reservoir_tpu_torch.ops import weighted_cuda as TWK

R, K, B = 6, 5, 16

#: name -> (config kwargs, element dtype of the stream, jnp map, torch map, jnp hash, torch hash)
MODES = {
    "uniform": (dict(), "int32", None, None, None, None),
    "uniform_float32": (dict(element_dtype="float32"), "float32", None, None, None, None),
    "wide_counts": (dict(count_dtype="wide"), "int32", None, None, None, None),
    "weighted": (dict(weighted=True), "int32", None, None, None, None),
    "distinct": (dict(distinct=True), "int32", None, None, None, None),
    "distinct_int64": (dict(distinct=True, element_dtype="int64"), "int64", None, None, None, None),
    "distinct_uint64": (dict(distinct=True, element_dtype="uint64"), "uint64", None, None, None, None),
    "mapped": (dict(sample_dtype="float32"), "int32",
               lambda x: (x >> 4).astype(jnp.float32) * 0.25, lambda x: (x >> 4).to(torch.float32) * 0.25,
               None, None),
    "hooked_distinct_int64": (dict(distinct=True, element_dtype="int64"), "int64",
                              lambda p: (p[0], p[1] & jnp.uint32(0xFFF)), lambda x: x & ~0xFFFFF000,
                              lambda p: (p[0] ^ p[1], p[1] & 0xFF), lambda x: ((x >> 32) ^ x, x & 0xFF)),
}


def _stream(rng, n, dtype, distinct):
    if distinct:  # heavy duplication
        t = rng.integers(0, 50, (R, n)).astype(np.int64) * np.int64(0x9E3779B97F4A7C15 - 2**64)
        return t.view(np.uint64) if dtype == "uint64" else t.astype(dtype)
    if dtype == "float32":
        return (rng.integers(-(1 << 20), 1 << 20, (R, n)) * 0.5).astype(np.float32)
    return rng.integers(-(1 << 31), 1 << 31, (R, n)).astype(np.int32)


def _engines(mode, seed=4):
    kw, _, jm, tm, jh, th = MODES[mode]
    cfg = dict(max_sample_size=K, num_reservoirs=R, tile_size=B, **kw)
    make = lambda: ReservoirEngine(SamplerConfig(**cfg), key=seed, reusable=True, map_fn=tm,  # noqa: E731
                                   hash_fn=th, device="cpu")
    return JEngine(JConfig(**cfg), key=seed, reusable=True, map_fn=jm, hash_fn=jh), make(), make()


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _same_state(a, b):
    for f, x, y in zip(a.state._fields, a.state, b.state):
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.uint32 else x,
                               y.view(torch.int32) if y.dtype == torch.uint32 else y), f


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_equals_the_per_tile_path_and_the_jax_fused_stream(mode):
    kw, dtype, *_ = MODES[mode]
    rng = np.random.default_rng(7)
    jeng, fused, tiled = _engines(mode)
    # 3 full tiles and a ragged tail of 5, then (uniform) a stream too
    # short to fuse
    for n in (3 * B + 5, B + 3)[: 2 if mode == "uniform" else 1]:
        stream = _stream(rng, n, dtype, kw.get("distinct", False))
        w = rng.uniform(0.0, 2.0, (R, n)).astype(np.float32) if kw.get("weighted") else None
        jeng.sample_stream(stream, weights=w, fused=True)
        fused.sample_stream(stream, weights=w, fused=True)
        tiled.sample_stream(stream, weights=w)
        _same_state(fused, tiled)
        assert fused._min_count == tiled._min_count == jeng._min_count
        _same(jeng.peek_arrays(), fused.peek_arrays())


def test_fused_takes_cpu_tensors_and_custom_widths():
    rng = np.random.default_rng(8)
    stream = _stream(rng, 5 * 12 + 7, "int32", False)
    jeng, fused, tiled = _engines("uniform")
    jeng.sample_stream(stream, tile_width=12, fused=True)
    fused.sample_stream(torch.from_numpy(stream), tile_width=12, fused=True)
    tiled.sample_stream(stream, tile_width=12)
    _same_state(fused, tiled)
    _same(jeng.peek_arrays(), fused.peek_arrays())


def test_fused_checks_every_weight_before_any_tile():
    _, eng, _ = _engines("weighted")
    stream = _stream(np.random.default_rng(9), 3 * B, "int32", False)
    w = np.ones((R, 3 * B), np.float32)
    w[2, 2 * B + 1] = -1.0
    with pytest.raises(ValueError, match="nonnegative"):
        eng.sample_stream(stream, weights=w, fused=True)
    assert int(eng.state.count.sum()) == 0 and eng._min_count == 0


def test_fused_snapshots_the_callers_stream():
    """The caller may reuse its array as soon as the call returns (R = 1
    makes each tile a view of it)."""
    rng = np.random.default_rng(10)
    stream = _stream(rng, 3 * B, "int32", False)[:1].copy()
    cfg = SamplerConfig(max_sample_size=K, num_reservoirs=1, tile_size=B)
    a = ReservoirEngine(cfg, key=1, reusable=True, device="cpu")
    b = ReservoirEngine(cfg, key=1, reusable=True, device="cpu")
    a.sample_stream(stream.copy(), fused=True)
    mine = stream.copy()
    b.sample_stream(mine, fused=True)
    mine[...] = 0
    _same(a.peek_arrays(), b.peek_arrays())


def test_fused_pallas_config_equals_auto_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(11)
    stream = _stream(rng, 4 * B, "int32", False)
    before = (TK.launches, TK.wide_launches, TWK.launches, TDK.launches, TDK.prehashed_launches)
    outs = []
    for impl in ("pallas", "auto"):
        eng = ReservoirEngine(SamplerConfig(K, R, B, impl=impl), key=8, reusable=True, device="cpu")
        eng.sample_stream(stream, fused=True)
        outs.append(eng.peek_arrays())
    _same(*outs)
    assert (TK.launches, TK.wide_launches, TWK.launches, TDK.launches, TDK.prehashed_launches) == before
