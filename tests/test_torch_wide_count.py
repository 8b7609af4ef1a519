"""WIDE stream counters (``count_dtype="wide"``) in the port against the JAX
package, bit for bit on the CPU.

A WIDE ``count`` or ``nxt`` is ``[R, 2]`` uint32 (lo, hi) words, so a row's
stream passes 2^31 (where int32 counters saturate) and 2^32.  The JAX
package runs WIDE states on XLA (its Pallas kernel declines them), so every
reference here is XLA on the CPU.  The same numpy-seeded inputs go through
both packages: ``ops/u64e.py`` function by function, the ``(hi, lo)``
Threefry forms and draws, the cases of ``tests/test_wide_count.py`` (below
the boundary equal to int32, across 2^31, 2^32 and 2^33 + 12,345, result
sizes, merges), ``init`` under both roundings, the engine end to end, its
row operations and checkpoints, the stream bridge and its journal, the
service and a standby across the packages, and the stream merger.  The
tolerance is zero: floats are compared as bits.
"""

from __future__ import annotations

import functools
import gc

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.ops import rng as JR
from reservoir_tpu.ops import threefry as JT
from reservoir_tpu.ops import u64e as JU
from reservoir_tpu.parallel import merge as JM
from reservoir_tpu.serve import ReservoirService as JService
from reservoir_tpu.serve import StandbyReplica as JStandby
from reservoir_tpu.stream.bridge import DeviceSampler as JSampler
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu.utils import checkpoint as jckpt
from reservoir_tpu_torch import (DeviceSampler, DeviceStreamBridge, ReservoirEngine, ReservoirService,
                                 SamplerConfig, convert)
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import rng as TR
from reservoir_tpu_torch.ops import threefry as TT
from reservoir_tpu_torch.ops import u64e as TU
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import merge as TM
from reservoir_tpu_torch.serve import StandbyReplica
from reservoir_tpu_torch.utils import faults

M32 = np.uint64(0xFFFFFFFF)
SHIFTS = [(1 << 31) - 300, (1 << 32) - 300, (1 << 33) + 12345]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    faults.uninstall()
    yield
    faults.uninstall()


def _planes(x) -> np.ndarray:
    """uint64 values as ``[..., 2]`` uint32 (lo, hi) words."""
    x = np.asarray(x, np.uint64)
    return np.stack([(x & M32).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)], -1)


def _u64(words) -> np.ndarray:
    """``[..., 2]`` words (numpy or torch, any 32-bit or int64 dtype) as uint64 values."""
    if isinstance(words, torch.Tensor):
        words = TU.words(words).numpy()
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return (w[..., 1].astype(np.uint64) << np.uint64(32)) | w[..., 0].astype(np.uint64)


def _t(planes) -> torch.Tensor:
    """``[..., 2]`` uint32 numpy words as the port's stored torch.uint32 layout."""
    return torch.from_numpy(np.ascontiguousarray(planes, np.uint32).view(np.int32)).view(torch.uint32)


def _bytes_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.view(np.uint8).tobytes() == want.view(np.uint8).tobytes()


def _jax_fields(state) -> dict:
    out = {}
    for name, value in zip(type(state)._fields, state):
        if jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        out[name] = np.asarray(value)
    return out


def _same_state(tstate, jstate):
    got, want = convert.state_to_numpy(tstate), _jax_fields(jstate)
    for name in ("samples", "count", "nxt", "log_w", "key"):
        _bytes_equal(got[name], want[name])


def _to_port(jstate) -> TA.ReservoirState:
    f = _jax_fields(jstate)
    return convert.state_from_numpy(f["samples"], f["count"], f["nxt"], f["log_w"], f["key"], device="cpu")


def _wide_cfg(k=8, R=16, B=64, **kw):
    return dict(max_sample_size=k, num_reservoirs=R, tile_size=B, count_dtype="wide", **kw)


# ---------------------------------------------------------------- ops/u64e.py


def _operands(seed=0, n=512):
    """Two uint64 operand arrays with the carry, borrow and sign
    boundaries of both words planted, a uint32 array and a float32 one."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1, 2**33 + 12345,
                      2**62, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1], np.uint64)
    a = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    b = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    a[: edges.size ** 2] = np.repeat(edges, edges.size)[: n]
    b[: edges.size ** 2] = np.tile(edges, edges.size)[: n]
    b[200:260] = rng.integers(1, 2**20, 60).astype(np.uint64)  # small divisors
    b[260:300] = np.uint64(2**63) + rng.integers(0, 2**62, 40).astype(np.uint64)  # divisors past 2^63
    d = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    d[:20] = [0, 1, 2**32 - 1, 2**31, 300, 2**32 - 1, 1, 0, 5, 2**32 - 2] * 2
    f = (rng.uniform(0, 1, n) * 2.0 ** rng.integers(0, 63, n)).astype(np.float32)
    f[:12] = [0.0, -0.0, 0.5, 1.0, 2.0**32 - 256, 2.0**32, 2.0**33 + 1024, 2.0**62, np.nan, 3.0, 1.5,
              2.0**31]
    return a, b, d, f


_U64E_CASES = ["make", "from_int", "lo", "hi", "add_u32", "add_f32", "add64", "sub_u32", "sub64",
               "le", "lt", "is_zero", "mod64", "diff_small", "to_f32", "to_int"]


@pytest.mark.parametrize("name", _U64E_CASES)
def test_u64e_function_equals_the_jax_package(name):
    a, b, d, f = _operands()
    pa, pb = _planes(a), _planes(b)
    b_nz = np.where(b == 0, np.uint64(7), b)
    args = {
        "make": ((pa[..., 0], pa[..., 1]), (_t(pa)[..., 0], _t(pa)[..., 1])),
        "lo": ((pa,), (_t(pa),)), "hi": ((pa,), (_t(pa),)),
        "add_u32": ((pa, d), (_t(pa), torch.from_numpy(d.astype(np.int64)))),
        "add_f32": ((pa, f), (_t(pa), torch.from_numpy(f))),
        "add64": ((pa, pb), (_t(pa), _t(pb))), "sub64": ((pa, pb), (_t(pa), _t(pb))),
        "sub_u32": ((pa, d), (_t(pa), torch.from_numpy(d.astype(np.int64)))),
        "le": ((pa, pb), (_t(pa), _t(pb))), "lt": ((pa, pb), (_t(pa), _t(pb))),
        "is_zero": ((pa,), (_t(pa),)),
        "mod64": ((pa, _planes(b_nz)), (_t(pa), _t(_planes(b_nz)))),
        "diff_small": ((pa, pb), (_t(pa), _t(pb))),
        "to_f32": ((pa,), (_t(pa),)),
    }
    if name == "from_int":
        for v in (0, 5, 2**32 - 1, 2**32, (1 << 40) + 7, 2**64 - 1):
            _bytes_equal(TU.to_u32(TU.from_int(v, (3,))), JU.from_int(v, (3,)))
        return
    if name == "to_int":
        for v in a[:40]:
            assert TU.to_int(_t(_planes(v))) == JU.to_int(_planes(v)) == int(v)
        return
    jargs, targs = args[name]
    want = np.asarray(jax.jit(getattr(JU, name))(*jargs))
    got = getattr(TU, name)(*targs).numpy()
    if want.dtype == np.uint32:
        assert np.array_equal(got, want.astype(np.int64)), name
    else:
        _bytes_equal(got, want)
    if name == "mod64":  # and it is the true remainder; a zero divisor gives a
        assert np.array_equal(_u64(got), a % b_nz)
        zero = _planes(np.zeros(8, np.uint64))
        want0 = np.asarray(jax.jit(JU.mod64)(pa[:8], zero))
        assert np.array_equal(TU.mod64(_t(pa[:8]), _t(zero)).numpy(), want0.astype(np.int64))


def test_u64e_round_trips_the_stored_layout():
    a = _operands()[0]
    stored = TU.to_u32(TU.words(_t(_planes(a))))
    assert stored.dtype == torch.uint32 and stored.shape == (a.size, 2)
    assert np.array_equal(_u64(stored), a)


# ------------------------------------------------------------- Threefry, draws


def test_pair_forms_of_threefry_and_the_draws_equal_the_jax_package():
    rng = np.random.default_rng(3)
    n = 4096
    k1, k2, hi, lo = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(4))
    hi[:64] = 0
    t = [torch.from_numpy(x.astype(np.int64)) for x in (k1, k2, hi, lo)]
    j = [jnp.asarray(x) for x in (k1, k2, hi, lo)]
    for got, want in zip(TT.fold_in_words_pair(*t), JT.fold_in_words_pair(*j)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for got, want in zip(TT.counter_bits_pair(*t, 3), JT.counter_bits_pair(*j, 3)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for k in (1, 5, 100, 128):
        for got, want in zip(TR.accept_draws_pair(*t, k), JR.accept_draws_pair(*j, k)):
            _bytes_equal(got, want)
    # a zero high word is the narrow form bit for bit
    narrow = TT.fold_in_words(t[0][:64], t[1][:64], torch.from_numpy(lo[:64].astype(np.int64)))
    for got, want in zip(TT.fold_in_words_pair(t[0][:64], t[1][:64], t[2][:64], t[3][:64]), narrow):
        assert torch.equal(got, want)


# --------------------------------------------------- the update and its states


@functools.lru_cache(maxsize=None)
def _j_update(fill: bool):
    return jax.jit(JA.update if fill else JA.update_steady)


def test_wide_matches_int32_below_boundary():
    R, k, B = 64, 16, 256
    s32 = TA.init(key_from_seed(0), R, k)
    sw = TA.init(key_from_seed(0), R, k, count_dtype="wide")
    jw = JA.init(jr.key(0), R, k, count_dtype=JA.WIDE)
    _same_state(sw, jw)
    for step in range(4):
        tile = np.random.default_rng(step).integers(0, 1 << 30, (R, B)).astype(np.int32)
        valid = None if step < 3 else np.random.default_rng(9).integers(0, B + 1, R).astype(np.int32)
        tv = None if valid is None else torch.from_numpy(valid)
        s32 = TA.update(s32, torch.from_numpy(tile), tv)
        sw = TA.update(sw, torch.from_numpy(tile), tv)
        jw = (_j_update(True)(jw, jnp.asarray(tile)) if valid is None
              else _j_update(True)(jw, jnp.asarray(tile), jnp.asarray(valid)))
        _same_state(sw, jw)
        assert torch.equal(s32.samples, sw.samples) and torch.equal(s32.log_w, sw.log_w)
        assert np.array_equal(_u64(sw.count), s32.count.numpy().astype(np.uint64))
        assert np.array_equal(_u64(sw.nxt), s32.nxt.numpy().astype(np.uint64))


def _lifted_pair(shift, R=128, k=16, B=512, steps=3):
    """The reference test's state: past the fill, imminent accepts
    (``nxt = count + 1 + U[0, B * steps)``), re-based to ``count + shift``,
    as a JAX WIDE state and the port's."""
    base = JA.init(jr.key(1), R, k)
    fill = np.random.default_rng(9).integers(0, 1 << 30, (R, 2 * k)).astype(np.int32)
    base = JA.update(base, jnp.asarray(fill))
    off = 1 + np.random.default_rng(10).integers(0, B * steps, R, dtype=np.int64)
    count = np.asarray(base.count).astype(np.uint64) + np.uint64(shift)
    nxt = np.asarray(base.count).astype(np.uint64) + off.astype(np.uint64) + np.uint64(shift)
    jw = JA.ReservoirState(base.samples, jnp.asarray(_planes(count)), jnp.asarray(_planes(nxt)),
                           base.log_w, base.key)
    return jw, _to_port(jw)


@pytest.mark.parametrize("shift", SHIFTS, ids=["2^31", "2^32", "2^33+12345"])
def test_wide_matches_the_jax_package_across_boundaries(shift):
    R, B, steps = 128, 512, 3
    jw, tw = _lifted_pair(shift, R=R, B=B, steps=steps)
    before = tw.samples.clone()
    for t in range(steps):
        tile = np.random.default_rng(20 + t).integers(0, 1 << 30, (R, B)).astype(np.int32)
        jw = _j_update(False)(jw, jnp.asarray(tile))
        tw = TK.update_steady_cuda(tw, torch.from_numpy(tile))
        _same_state(tw, jw)
    assert not torch.equal(tw.samples, before), "no acceptance landed past the boundary"
    assert int(_u64(tw.count).min()) >= shift


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("k", [5, 6])
def test_init_at_k_5_and_6_rounds_as_the_jax_package(k, compiled):
    R = 256
    got = TA.init(key_from_seed(4), R, k, count_dtype="wide", compiled=compiled)
    eager = JA.init(jr.key(4), R, k, count_dtype=JA.WIDE)
    jitted = jax.jit(functools.partial(JA.init, num_reservoirs=R, k=k, count_dtype=JA.WIDE))(jr.key(4))
    _same_state(got, jitted if compiled else eager)
    # the two roundings differ in some rows, so the case has teeth
    assert not np.array_equal(np.asarray(eager.log_w).view(np.int32), np.asarray(jitted.log_w).view(np.int32))


def test_result_sizes_wide():
    R, k = 8, 16
    st = TA.init(key_from_seed(2), R, k, count_dtype="wide")
    st = TA.update(st, torch.arange(R * 5, dtype=torch.int32).reshape(R, 5))
    samples, size = TA.result(st)
    assert size.dtype == torch.int32 and (size == 5).all()
    assert (samples[:, 5:] == 0).all()
    st = TA.update(st, torch.arange(R * 64, dtype=torch.int32).reshape(R, 64))
    assert (TA.result(st)[1] == k).all()
    big = st._replace(count=TU.to_u32(TU.from_int((1 << 40) + 7, (R,))))
    assert (TA.result(big)[1] == k).all()
    j = JA.init(jr.key(2), R, k, count_dtype=JA.WIDE)
    j = j._replace(count=JU.from_int((1 << 40) + 7, (R,)))
    assert np.asarray(JA.result(j)[1]).dtype == np.int32


def test_gated_update_raises_for_wide_counters():
    st = TA.init(key_from_seed(2), 4, 8, count_dtype="wide")
    tile, nv = torch.zeros((4, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    for fn in (TA.update_gated, TK.update_gated_cuda):
        with pytest.raises(ValueError, match="non-WIDE"):
            fn(st, tile, nv, nv)
    with pytest.raises(ValueError, match="non-WIDE"):
        JA.update_gated(JA.init(jr.key(2), 4, 8, count_dtype=JA.WIDE), jnp.zeros((4, 4), jnp.int32),
                        jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32))
    eng = ReservoirEngine(SamplerConfig(**_wide_cfg(R=4)), device="cpu")
    with pytest.raises(ValueError, match="narrow int32 counters"):
        eng.sample_gated(np.zeros((4, 2), np.int32), np.zeros(4, np.int32), np.ones(4, np.int32))


# ------------------------------------------------------------------ merges


def _merge_counts(R, seed=77):
    rng = np.random.default_rng(seed)
    ca = rng.integers(1, 1 << 40, R).astype(np.uint64)
    cb = rng.integers(1, 1 << 40, R).astype(np.uint64)
    ca[:8] = [1, 3, 2**32 - 1, 2**32 + 1, 0, 2**64 - 5, 2**63 + 9, 6]
    cb[:8] = [2, 3, 2**32 + 5, 2**32 - 3, 0, 7, 2**63, 2**31 + 2]
    return ca, cb


def test_wide_merge_equals_the_jax_package():
    R, k = 256, 16
    ca, cb = _merge_counts(R)
    rng = np.random.default_rng(5)
    s_a = rng.integers(1, 1 << 20, (R, k)).astype(np.int32)
    s_b = (1_000_000 + rng.integers(0, 1 << 20, (R, k))).astype(np.int32)
    want_s, want_c = jax.jit(JA.merge_samples)(jnp.asarray(s_a), jnp.asarray(_planes(ca)),
                                               jnp.asarray(s_b), jnp.asarray(_planes(cb)), jr.key(78))
    got_s, got_c = TA.merge_samples(torch.from_numpy(s_a), _t(_planes(ca)), torch.from_numpy(s_b),
                                    _t(_planes(cb)), key_from_seed(78))
    _bytes_equal(got_s, want_s)
    _bytes_equal(got_c, want_c)
    assert got_c.dtype == torch.uint32 and np.array_equal(_u64(got_c), ca + cb)  # exact 64-bit totals
    # the state-level merge: int32 sizes, WIDE counts
    sa = TA.ReservoirState(torch.from_numpy(s_a), _t(_planes(ca)), _t(_planes(ca)),
                           torch.zeros(R), torch.zeros((R, 2), dtype=torch.int64))
    sb = sa._replace(samples=torch.from_numpy(s_b), count=_t(_planes(cb)))
    samples, size, count = TA.merge(sa, sb, key_from_seed(78))
    assert torch.equal(samples, got_s) and torch.equal(count.view(torch.int32), got_c.view(torch.int32))
    # 64-bit totals wrap modulo 2^64, as the reference's u64e.add64 does
    assert size.dtype == torch.int32 and np.array_equal(size.numpy(), np.minimum(ca + cb, k))


def test_wide_merge_draws_equal_the_scan_of_the_jax_package():
    """The plain merge draws (the WIDE kernel's function): ``j_a`` equals the
    number of A's samples the reference's merge takes, row by row."""
    R, k = 128, 24
    ca, cb = _merge_counts(R, seed=4)
    keys = TA.split_keys(key_from_seed(9), R)
    draws = TA.merge_draws(_t(_planes(ca)), _t(_planes(cb)), keys, k)
    s_a = np.tile(np.arange(1, k + 1, dtype=np.int32), (R, 1))
    s_b = np.tile(np.arange(10_000, 10_000 + k, dtype=np.int32), (R, 1))
    merged, _ = jax.jit(JA.merge_samples)(jnp.asarray(s_a), jnp.asarray(_planes(ca)), jnp.asarray(s_b),
                                          jnp.asarray(_planes(cb)), jr.key(9))
    from_a = ((np.asarray(merged) > 0) & (np.asarray(merged) < 10_000)).sum(1)
    assert np.array_equal(draws.j_a.numpy(), from_a)


def test_merge_mixed_width_raises():
    R, k = 4, 8
    wide = TA.init(key_from_seed(3), R, k, count_dtype="wide")
    narrow = TA.init(key_from_seed(4), R, k)
    for a, b in ((wide, narrow), (narrow, wide)):
        with pytest.raises(ValueError, match="mixed-width"):
            TA.merge_samples(a.samples, a.count, b.samples, b.count, key_from_seed(5))
    with pytest.raises(ValueError, match="mixed-width"):
        JA.merge_samples(jnp.zeros((R, k), jnp.int32), JU.from_int(3, (R,)), jnp.zeros((R, k), jnp.int32),
                         jnp.zeros(R, jnp.int32), jr.key(5))


def test_uniform_stream_merger_on_wide_counts_equals_jax():
    D, R, k = 4, 8, 6
    rng = np.random.default_rng(21)
    samples = rng.integers(0, 1 << 30, (D, R, k)).astype(np.int32)
    counts = rng.integers(0, 1 << 40, (D, R)).astype(np.uint64)
    counts[:, 0] = [2**32 - 1, 2**32 + 1, 3, 2**33 + 12345]
    counts[:, 1] = [0, 2, 1, 4]
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("stream",))
    want_s, want_c = JM.uniform_stream_merger(mesh)(jnp.asarray(samples), jnp.asarray(_planes(counts)),
                                                    jr.key(99))
    got_s, got_c = TM.uniform_stream_merger(torch.from_numpy(samples), _t(_planes(counts)), 99)
    _bytes_equal(got_s, want_s)
    _bytes_equal(got_c, want_c)
    assert np.array_equal(_u64(got_c), counts.sum(0))
    # as a sequence of per-shard tensors on CPU ranks, too
    seq_s, seq_c = TM.uniform_stream_merger([torch.from_numpy(s) for s in samples],
                                            [_t(_planes(c)) for c in counts], 99)
    assert torch.equal(seq_s, got_s) and torch.equal(seq_c.view(torch.int32), got_c.view(torch.int32))


def test_host_merge_raises_for_a_count_past_2_32():
    parts = [(np.arange(3, dtype=np.int32), 2**32 + 5), (np.arange(3, dtype=np.int32), 4)]
    with pytest.raises(OverflowError):
        JM.merge_samples_host(parts, 0, max_sample_size=4)
    with pytest.raises(OverflowError, match="uint32"):
        TM.merge_samples_host(parts, 0, max_sample_size=4)
    # below 2^32 both merge, equal
    parts = [(np.arange(3, dtype=np.int32), 2**32 - 9), (np.arange(3, dtype=np.int32), 4)]
    got, want = TM.merge_samples_host(parts, 0, max_sample_size=4), JM.merge_samples_host(parts, 0,
                                                                                            max_sample_size=4)
    _bytes_equal(got[0], want[0])
    assert got[1] == want[1] == 2**32 - 5


def test_state_parts_of_a_wide_state_carry_64_bit_counts():
    st = TA.init(key_from_seed(1), 3, 4, count_dtype="wide")
    st = st._replace(count=_t(_planes(np.array([2, 2**33 + 1, 5], np.uint64))))
    parts = convert.state_parts(st)
    assert [c for _, c in parts] == [2, 2**33 + 1, 5] and [len(s) for s, _ in parts] == [2, 4, 4]


# -------------------------------------------------------------- the engine


def _engines(key=5, **kw):
    cfg = _wide_cfg(**kw)
    return (JEngine(JConfig(**cfg), key=key, reusable=True),
            ReservoirEngine(SamplerConfig(**cfg), key=key, reusable=True, device="cpu"))


def _feed(engines, rng, R, B, ragged=False):
    tile = rng.integers(0, 1 << 30, (R, B)).astype(np.int32)
    valid = rng.integers(0, B + 1, R).astype(np.int32) if ragged else None
    for e in engines:
        e.sample(tile, valid=valid)


def test_engine_wide_end_to_end_equals_jax():
    jeng, teng = _engines()
    narrow = ReservoirEngine(SamplerConfig(8, 16, tile_size=64), key=5, reusable=True, device="cpu")
    rng = np.random.default_rng(6)
    for step in range(4):
        _feed((jeng, teng, narrow), rng, 16, 64, ragged=step == 2)
        _same_state(teng.state, jeng._state)
    samples, sizes = teng.result_arrays()
    want = jeng.result_arrays()
    _bytes_equal(samples, want[0])
    _bytes_equal(sizes, want[1])
    assert sizes.dtype == np.int32 and (sizes == 8).all()
    # with a zero high word the WIDE engine is the int32 engine
    _bytes_equal(samples, narrow.result_arrays()[0])


def test_engine_wide_rows_cross_2_32_through_the_engine():
    """A restored engine whose counts straddle 2^32 keeps sampling past it."""
    jw, tw = _lifted_pair((1 << 32) - 300, R=32, k=8, B=128)
    cfg = _wide_cfg(k=8, R=32, B=128)
    teng = ReservoirEngine(SamplerConfig(**cfg), reusable=True, device="cpu", _initial_state=tw)
    teng._min_count = 8
    rng = np.random.default_rng(2)
    for _ in range(4):
        tile = rng.integers(0, 1 << 30, (32, 128)).astype(np.int32)
        teng.sample(tile)
        jw = _j_update(False)(jw, jnp.asarray(tile))
    _same_state(teng.state, jw)
    assert (_u64(teng.state.count) > 2**32).all()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_engine_wide_checkpoint_round_trip(tmp_path, direction):
    jeng, teng = _engines(key=7, k=4, R=8, B=32)
    rng = np.random.default_rng(8)
    tiles = [rng.integers(0, 1 << 30, (8, 32)).astype(np.int32) for _ in range(3)]
    jeng.sample(tiles[0])
    teng.sample(tiles[0])
    path = str(tmp_path / "wide.npz")
    (jckpt.save_engine(path, jeng) if direction == "jax_to_port" else teng.save(path))
    restored = (jckpt.load_engine(path) if direction == "port_to_jax"
                else ReservoirEngine.restore(path, device="cpu"))
    with np.load(path) as data:
        assert data["count"].dtype == np.uint32 and data["count"].shape == (8, 2)
    for t in tiles[1:]:
        restored.sample(t)
        teng.sample(t)
    got = restored._state if direction == "port_to_jax" else restored.state
    if direction == "port_to_jax":
        _same_state(teng.state, got)
    else:
        for t in tiles[1:]:
            jeng.sample(t)
        _same_state(got, jeng._state)


def test_engine_wide_row_operations_equal_jax():
    jeng, teng = _engines(key=3, k=6, R=32, B=16)
    rng = np.random.default_rng(0)
    for _ in range(3):
        _feed((jeng, teng), rng, 32, 16)
    rows = np.array([1, 3, 9, 3, 17], np.int32)
    for e in (jeng, teng):
        e.reset_rows(rows, 11)
    _same_state(teng.state, jeng._state)
    src, dst = np.array([2, 4, 30], np.int32), np.array([5, 6, 7], np.int32)
    jpart, tpart = jeng.export_rows(src), teng.export_rows(src)
    assert tpart.count.shape == (3, 2) and tpart.count.dtype == torch.uint32
    _same_state(tpart, jpart)
    jeng.adopt_rows(dst, jpart)
    teng.adopt_rows(dst, _to_port(jpart))  # the JAX package's export, adopted by the port
    for _ in range(3):
        _feed((jeng, teng), rng, 32, 16, ragged=True)
    _same_state(teng.state, jeng._state)
    with pytest.raises(ValueError, match="count"):
        teng.adopt_rows(dst, ReservoirEngine(SamplerConfig(6, 32, tile_size=16), device="cpu")
                        .export_rows(src))


def test_config_and_impl_rejections():
    with pytest.raises(ValueError):
        SamplerConfig(max_sample_size=4, distinct=True, count_dtype="wide")
    with pytest.raises(ValueError):
        SamplerConfig(max_sample_size=4, weighted=True, count_dtype="wide")
    with pytest.raises(ValueError, match="impl='pallas'"):
        ReservoirEngine(SamplerConfig(4, 64, count_dtype="wide", impl="pallas"), device="cpu")
    with pytest.raises(ValueError):
        JEngine(JConfig(4, 64, count_dtype="wide", impl="pallas"), key=0)
    ReservoirEngine(SamplerConfig(4, 64, count_dtype="wide", impl="auto"), device="cpu")


def test_uint32_and_int64_count_dtypes_raise():
    with pytest.raises(ValueError, match="cannot build that state"):
        ReservoirEngine(SamplerConfig(4, 2, count_dtype="uint32"), device="cpu")
    with pytest.raises(ValueError, match="global x64.*'wide'"):
        ReservoirEngine(SamplerConfig(4, 2, count_dtype="int64"), device="cpu")
    with pytest.raises(ValueError, match="count_dtype"):
        ReservoirEngine(SamplerConfig(4, 2, count_dtype="int16"), device="cpu")
    # what the JAX package does with them: uint32 fails to build, int64
    # silently gives int32 counters with x64 off
    with pytest.raises(OverflowError):
        JEngine(JConfig(4, 2, count_dtype="uint32"), key=0)
    assert np.asarray(JEngine(JConfig(4, 2, count_dtype="int64"), key=0)._state.count).dtype == np.int32


# ---------------------------------------------------- bridge, service, standby


def test_device_sampler_wide_equals_jax():
    cfg = _wide_cfg(k=8, R=1, B=64)
    got = DeviceSampler(SamplerConfig(**cfg), key=0, device="cpu")
    want = JSampler(JConfig(**cfg), key=0)
    for s in (got, want):
        s.sample_all(range(1000))
    _bytes_equal(got.result(), want.result())


def _bridge_round(bridge, data, r):
    for s in range(data.shape[1]):
        bridge.push(s, data[r, s])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wide_bridge_journal_recovers_across_packages(tmp_path, direction):
    S, B, rounds, crash = 8, 16, 6, 4
    cfg = _wide_cfg(k=4, R=S, B=B)
    data = np.random.default_rng(0).integers(0, 1 << 30, (rounds, S, B)).astype(np.int32)
    ref = DeviceStreamBridge(SamplerConfig(**cfg), key=7, device="cpu")
    for r in range(rounds):
        _bridge_round(ref, data, r)
    expected = ref.complete()
    ckdir = str(tmp_path / "ck")
    make = (lambda **kw: JBridge(JConfig(**cfg), key=7, **kw)) if direction == "jax_to_port" else \
        (lambda **kw: DeviceStreamBridge(SamplerConfig(**cfg), key=7, device="cpu", **kw))
    writer = make(checkpoint_dir=ckdir, checkpoint_every=5)
    for r in range(crash):
        _bridge_round(writer, data, r)
    writer.drain_barrier()
    del writer
    gc.collect()
    recovered = (DeviceStreamBridge.recover(ckdir, device="cpu") if direction == "jax_to_port"
                 else JBridge.recover(ckdir))
    assert recovered.flushed_seq == crash * S
    for r in range(crash, rounds):
        _bridge_round(recovered, data, r)
    for got, want in zip(recovered.complete(), expected):
        _bytes_equal(got, want)


def test_wide_bridge_gated_is_inert_with_the_reference_reason():
    cfg = _wide_cfg(k=4, R=8, B=16)
    port = DeviceStreamBridge(SamplerConfig(**cfg), key=1, device="cpu", gated=True)
    ref = JBridge(JConfig(**cfg), key=1, gated=True)
    assert not port.gate_active and port.gate_inert_reason == ref.gate_inert_reason
    assert "WIDE" in port.gate_inert_reason
    plain = DeviceStreamBridge(SamplerConfig(**cfg), key=1, device="cpu")
    data = np.random.default_rng(2).integers(0, 1 << 30, (3, 8, 16)).astype(np.int32)
    for r in range(3):
        _bridge_round(port, data, r)
        _bridge_round(plain, data, r)
    for got, want in zip(port.complete(), plain.complete()):
        _bytes_equal(got, want)


def _ingest(services, key, rng, n):
    elems = (1000 * (1 + int(key[1:])) + rng.integers(0, 500, n)).astype(np.int32)
    for s in services:
        s.ingest(key, elems)


def test_wide_service_snapshots_and_recycles_equal_jax():
    cfg = _wide_cfg(k=4, R=6, B=8)
    jsvc = JService(JConfig(**cfg), key=3, pipelined=False)
    tsvc = ReservoirService(SamplerConfig(**cfg), key=3, device="cpu", pipelined=False)
    rng = np.random.default_rng(4)
    for i in range(14):  # 14 sessions on 6 rows: opens past 6 evict and recycle rows
        for s in (jsvc, tsvc):
            s.open_session(f"s{i}")
        _ingest((jsvc, tsvc), f"s{i}", rng, 11 + i)
        live = [x.key for x in tsvc.table.sessions()]
        for key in live:
            _bytes_equal(tsvc.snapshot(key), jsvc.snapshot(key))
    _same_state(tsvc.bridge.engine.state, jsvc.bridge.engine._state)
    assert tsvc.bridge.engine.reset_epochs > 0


def test_standby_tails_a_wide_primary_of_the_other_package(tmp_path):
    cfg = _wide_cfg(k=3, R=3, B=8)
    kw = dict(pipelined=False, checkpoint_every=1000, coalesce_bytes=64)
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc = JService(JConfig(**cfg), key=9, checkpoint_dir=ck_j, **kw)
    tsvc = ReservoirService(SamplerConfig(**cfg), key=9, checkpoint_dir=ck_t, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(3):
        for s in (jsvc, tsvc):
            s.open_session(f"s{i}")
        _ingest((jsvc, tsvc), f"s{i}", rng, 30)
    for s in (jsvc, tsvc):
        s.sync()
    standbys = [StandbyReplica(ck_j, device="cpu"), JStandby(ck_t)]
    for rounds in range(3):
        for sb in standbys:
            sb.poll()
        _same_state(standbys[0].service.bridge.engine.state, jsvc.bridge.engine._state)
        _same_state(tsvc.bridge.engine.state, standbys[1].service.bridge.engine._state)
        old, new = f"s{rounds}", f"s{rounds + 3}"
        for s in (jsvc, tsvc):
            s.close_session(old)
            s.open_session(new)
        _ingest((jsvc, tsvc), new, rng, 40)
        _ingest((jsvc, tsvc), f"s{rounds + 1}", rng, 17)
        for s in (jsvc, tsvc):
            s.sync()
    for sb in standbys:
        sb.poll()
    _same_state(standbys[0].service.bridge.engine.state, jsvc.bridge.engine._state)
    _same_state(tsvc.bridge.engine.state, jsvc.bridge.engine._state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wide_adopt_frame_recovers_across_packages(tmp_path, writer):
    """An adoption of rows lifted past 2^32 (an ``RTJA`` frame whose counts
    are ``[n, 2]`` words), then tiles across the boundary; either
    package's recovery replays the other's journal to the writer's state."""
    S, B = 8, 16
    cfg = _wide_cfg(k=4, R=S, B=B)
    data = np.random.default_rng(5).integers(0, 1 << 30, (6, S, B)).astype(np.int32)
    lifted = TA.init(key_from_seed(2), S, 4, count_dtype="wide")
    lifted = TA.update(lifted, torch.from_numpy(data[0]))
    up = _planes(np.full(S, (1 << 32) - 2 * B, np.uint64))
    lifted = lifted._replace(count=TU.to_u32(TU.add64(lifted.count, _t(up))),
                             nxt=TU.to_u32(TU.add64(lifted.nxt, _t(up))))
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        live = JBridge(JConfig(**cfg), key=7, checkpoint_dir=ckdir, checkpoint_every=100)
        f = convert.state_to_numpy(lifted)
        sub = JA.ReservoirState(jnp.asarray(f["samples"]), jnp.asarray(f["count"]), jnp.asarray(f["nxt"]),
                                jnp.asarray(f["log_w"]), jr.wrap_key_data(jnp.asarray(f["key"])))
    else:
        live = DeviceStreamBridge(SamplerConfig(**cfg), key=7, device="cpu", checkpoint_dir=ckdir,
                                  checkpoint_every=100)
        sub = lifted
    live.adopt_rows(np.arange(S), sub)
    for r in range(1, 5):
        _bridge_round(live, data, r)
    live.drain_barrier()
    want = convert.state_to_numpy(_to_port(live.engine._state) if writer == "jax" else live.engine.state)
    del live
    gc.collect()
    port = DeviceStreamBridge.recover(ckdir, device="cpu")
    ref = JBridge.recover(ckdir)
    for got in (port.engine.state, _to_port(ref.engine._state)):
        for name, value in convert.state_to_numpy(got).items():
            _bytes_equal(value, want[name])
    assert int(_u64(port.engine.state.count).min()) > 2**32
