"""The reference's map and hash hooks in the port (``map_fn``, ``hash_fn``),
held against the JAX package on the CPU, bit for bit.

Each hook is a pair: a jnp function for the JAX engine (which runs XLA
here, since its Pallas ``supports()`` declines hooks) and its torch twin
for the port.  The maps are exact (integer arithmetic, float products by
powers of two, casts of values in range), so the two frameworks agree on
every input.  8-byte keys reach a jnp hook as ``(hi, lo)`` uint32 planes
and a torch hook as int64.

- the engine in the three modes, with WIDE counters, and with a map whose
  sample dtype differs from the element dtype, over fill, steady and
  ragged tiles (``tests/test_engine.py``'s ``test_map_fn``, ``test_device_algl.py``'s
  map on accept, ``test_device_distinct.py``'s map and hash cases);
- the map never moves the skip chain, and mapping a whole tile first (the
  card's path) equals mapping on accept for an elementwise map;
- the reference's construction errors;
- a scrambled hash of (MAX, MAX) under a ``hash_fn`` or a ``map_fn``, and
  on a ragged tile (C.9): kept while the row is not full, as the
  reference's XLA sort-merge keeps it, in the engine and the bridge;
- the gated bridge, the bridge and its ``recover``, a standby, and
  checkpoints in both directions.
"""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import hashing as JH
from reservoir_tpu.oracle import BottomKOracle as JOracle
from reservoir_tpu.serve import StandbyReplica as JStandby
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.convert import distinct_state_from_numpy, distinct_state_to_numpy
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import hashing as TH
from reservoir_tpu_torch.ops import hooks
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.oracle import BottomKOracle
from reservoir_tpu_torch.serve import StandbyReplica
from reservoir_tpu_torch.utils import faults

# ------------------------------------------------------------------ hooks

#: name -> (jnp map, torch map)
MAPS = {
    "affine": (lambda x: x * 3 + 7, lambda x: x * 3 + 7),
    "xor": (lambda x: x ^ 0x5A5A5A5A, lambda x: x ^ 0x5A5A5A5A),
    "half": (lambda x: (x >> 8).astype(jnp.float32) * 0.5, lambda x: (x >> 8).to(torch.float32) * 0.5),
    "times4": (lambda x: x * 4.0, lambda x: x * 4.0),
    "low10": (lambda x: x & 0x3FF, lambda x: x & 0x3FF),
    # 8-byte keys: (hi, lo) planes for jnp, int64 for torch
    "xor64": (lambda p: (p[0] ^ jnp.uint32(0x1234), p[1]), lambda x: x ^ (0x1234 << 32)),
}
#: name -> (jnp hash, torch hash)
HASHES = {
    "shift": (lambda v: (v >> 16, v * 31), lambda v: (v >> 16, v * 31)),
    # many keys share one hash: the order falls to the value words
    "collide": (lambda v: (v & 0, v & 0xF), lambda v: (v & 0, v & 0xF)),
    "words64": (lambda p: (p[0] ^ p[1], p[1] & 0xFF), lambda x: ((x >> 32) ^ x, x & 0xFF)),
}


@pytest.fixture(autouse=True)
def _no_global_faults():
    faults.uninstall()
    yield
    faults.uninstall()


def _engines(kw, seed=3, map_name=None, hash_name=None, reusable=True):
    jm, tm = MAPS[map_name] if map_name else (None, None)
    jh, th = HASHES[hash_name] if hash_name else (None, None)
    return (
        JEngine(JConfig(**kw), key=seed, map_fn=jm, hash_fn=jh, reusable=reusable),
        ReservoirEngine(SamplerConfig(**kw), key=seed, map_fn=tm, hash_fn=th, reusable=reusable,
                        device="cpu"),
    )


def _elements(rng, R, B, dtype):
    if dtype == "float32":  # finite, so every map's products are exact
        return (rng.integers(-(1 << 20), 1 << 20, (R, B)) * 0.25).astype(np.float32)
    if dtype == "int64":
        t = rng.integers(-(1 << 20), 1 << 20, (R, B)).astype(np.int64)
        return t * np.int64(0x9E3779B97F4A7C15 - 2**64)
    if dtype == "zipf":
        u = rng.uniform(1e-6, 1.0, (R, B))
        return (np.minimum(u ** -4.0, 1e6).astype(np.int64) * rng.choice([-1, 1], (R, B))).astype(np.int32)
    return rng.integers(-(1 << 31), 1 << 31, (R, B)).astype(np.int32)


def _same_results(jeng, teng):
    for a, b in zip(jeng.peek_arrays(), teng.peek_arrays()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_state(jeng, teng):
    """Every field of the two engines' states, as bits."""
    js, ts = jeng.state, teng.state
    if type(ts).__name__ == "DistinctState":
        host = distinct_state_to_numpy(ts)
        for f, a in host.items():
            b = getattr(js, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(np.asarray(b), a, err_msg=f)
        return
    for f in ts._fields:
        if f == "key":
            continue
        a = getattr(ts, f)
        a = a.view(torch.int32) if a.dtype == torch.uint32 else a
        np.testing.assert_array_equal(np.asarray(getattr(js, f)).view(np.uint8), a.numpy().view(np.uint8),
                                      err_msg=f)


def _feed(jeng, teng, rng, R, B, dtype, weighted=False):
    """A ragged tile from empty (a partial fill in every row), a tile
    across the fill's end, then a steady one, into both engines; the
    states compared after each."""
    for i in range(3):
        tile = _elements(rng, R, B, dtype)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 0 else None
        w = rng.uniform(0.0, 2.0, (R, B)).astype(np.float32) if weighted else None
        if weighted:
            jeng.sample(tile, valid, weights=w)
            teng.sample(tile, valid, weights=w)
        else:
            jeng.sample(tile, valid)
            teng.sample(torch.from_numpy(tile) if i % 2 else tile, valid)
        _same_state(jeng, teng)


UNIFORM_CASES = [
    ("int32", None, "affine", "int32"),
    ("int32", None, "affine", "wide"),
    ("int32", "float32", "half", "int32"),
    ("int32", "float32", "half", "wide"),
    ("int32", "uint32", "xor", "int32"),
    ("float32", "int32", "times4", "int32"),
]


@pytest.mark.parametrize("elem, sample, map_name, count", UNIFORM_CASES)
def test_uniform_engine_maps_on_accept_as_jax(elem, sample, map_name, count):
    R, k, B = 12, 6, 24
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=elem,
              sample_dtype=sample, count_dtype=count)
    jeng, teng = _engines(kw, map_name=map_name)
    _feed(jeng, teng, np.random.default_rng(1), R, B, elem)
    _same_results(jeng, teng)


@pytest.mark.parametrize("elem, sample, map_name", [("int32", "float32", "half")])
def test_weighted_engine_maps_on_accept_as_jax(elem, sample, map_name):
    R, k, B = 12, 5, 24
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=elem,
              sample_dtype=sample, weighted=True)
    jeng, teng = _engines(kw, map_name=map_name)
    _feed(jeng, teng, np.random.default_rng(2), R, B, elem, weighted=True)
    _same_results(jeng, teng)


DISTINCT_CASES = [
    ("zipf", "int32", "low10", None),
    ("zipf", "int32", None, "shift"),
    ("zipf", "int32", "affine", "shift"),
    ("int32", "int32", None, "collide"),
    ("zipf", "uint32", "low10", None),
    ("int64", "int64", "xor64", None),
    ("int64", "int64", None, "words64"),
    ("int64", "int64", "xor64", "words64"),
]


@pytest.mark.parametrize("keys, dtype, map_name, hash_name", DISTINCT_CASES)
def test_distinct_engine_maps_and_hashes_as_jax(keys, dtype, map_name, hash_name):
    R, k, B = 10, 8, 32
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=dtype, distinct=True)
    jeng, teng = _engines(kw, map_name=map_name, hash_name=hash_name)
    rng = np.random.default_rng(3)
    for i in range(4):
        tile = _elements(rng, R, B, keys)
        if dtype == "uint32":
            tile = tile.view(np.uint32)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 1 else None
        jeng.sample(tile, valid)
        teng.sample(tile, valid)
        _same_state(jeng, teng)
    _same_results(jeng, teng)


def test_a_map_in_distinct_mode_applies_to_every_element():
    R, k, B = 1, 32, 1000
    _, teng = _engines(dict(max_sample_size=k, num_reservoirs=R, tile_size=B, distinct=True),
                       map_name="low10")
    teng.sample(np.arange(1000, dtype=np.int32)[None, :] * 1024 + np.arange(1000, dtype=np.int32) % 10)
    samples, sizes = teng.result_arrays()
    assert int(sizes[0]) == 10 and sorted(samples[0, :10].tolist()) == list(range(10))


def test_the_map_never_moves_the_skip_chain():
    R, k = 4, 8
    stream = torch.arange(R * 100, dtype=torch.int32).reshape(R, 100)
    s0 = TA.init(key_from_seed(11), R, k)
    mapped = TA.update(s0, stream, map_fn=lambda x: x * 2)
    plain = TA.update(s0, stream)
    assert torch.equal(mapped.samples, plain.samples * 2)
    for f in ("count", "nxt", "log_w"):
        assert torch.equal(getattr(mapped, f), getattr(plain, f)), f


@pytest.mark.parametrize("count", ["int32", "wide"])
def test_mapping_the_tile_first_equals_mapping_on_accept(count):
    """The card's path maps the whole tile, then runs the unchanged
    kernel; for an elementwise map that is the reference's map on accept."""
    R, k, B = 16, 6, 40
    rng = np.random.default_rng(4)
    s = TA.init(key_from_seed(2), R, k, sample_dtype=torch.float32, count_dtype=count)
    fn = MAPS["half"][1]
    for fill in (True, False, False):
        tile = torch.from_numpy(_elements(rng, R, B, "int32"))
        step = TA.update if fill else TA.update_steady
        a = step(s, tile, None, fn)
        b = step(s, hooks.map_values(fn, tile, torch.float32))
        for f in ("samples", "count", "nxt", "log_w"):
            assert torch.equal(getattr(a, f).view(torch.int32) if f == "samples" else getattr(a, f),
                               getattr(b, f).view(torch.int32) if f == "samples" else getattr(b, f)), f
        s = a


def test_a_gated_candidate_tile_maps_as_the_reference():
    R, k, bg = 6, 4, 8
    rng = np.random.default_rng(5)
    js = JA.init(jr.key(3), R, k)
    ts = TA.init(key_from_seed(3), R, k)
    tile = rng.integers(-1000, 1000, (R, bg)).astype(np.int32)
    nvalid = np.array([0, 3, 8, 4, 1, 2], np.int32)
    advance = np.array([0, 3, 9, 20, 4, 2], np.int32)
    jm, tm = MAPS["affine"]
    j = jax.jit(lambda s, t, n, a: JA.update_gated(s, t, n, a, map_fn=jm))(
        js, jnp.asarray(tile), jnp.asarray(nvalid), jnp.asarray(advance))
    t = TA.update_gated(ts, torch.from_numpy(tile), torch.from_numpy(nvalid), torch.from_numpy(advance),
                        map_fn=tm)
    for f in ("samples", "count", "nxt", "log_w"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)).view(np.int32),
                                      getattr(t, f).numpy().view(np.int32), err_msg=f)


def test_the_engine_raises_the_references_construction_errors():
    with pytest.raises(ValueError, match="only meaningful with distinct=True"):
        ReservoirEngine(SamplerConfig(4, 2), hash_fn=lambda v: (v, v), device="cpu")
    with pytest.raises(ValueError, match="identity map_fn"):
        ReservoirEngine(SamplerConfig(4, 2, impl="pallas"), map_fn=abs, device="cpu")
    with pytest.raises(ValueError, match="default hash"):
        ReservoirEngine(SamplerConfig(4, 2, distinct=True, impl="pallas"), hash_fn=lambda v: (v, v),
                        device="cpu")
    # without a map the element and sample dtypes must agree; a map may change it
    with pytest.raises(ValueError, match="4-byte words"):
        ReservoirEngine(SamplerConfig(4, 2, element_dtype="int32", sample_dtype="float32"), device="cpu")
    ReservoirEngine(SamplerConfig(4, 2, element_dtype="int32", sample_dtype="float32"), map_fn=abs,
                    device="cpu")
    with pytest.raises(ValueError, match="element dtype|map_fn takes elements"):
        ReservoirEngine(SamplerConfig(4, 2, element_dtype="int16", sample_dtype="int32"), map_fn=abs,
                        device="cpu")
    with pytest.raises(ValueError, match="elementwise"):
        eng = ReservoirEngine(SamplerConfig(4, 2, tile_size=8), map_fn=lambda x: x.reshape(-1)[:1], device="cpu")
        eng.sample(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="integer words"):
        eng = ReservoirEngine(SamplerConfig(4, 2, tile_size=8, distinct=True),
                              hash_fn=lambda v: (v * 0.5, v), device="cpu")
        eng.sample(np.ones((2, 8), np.int32))


# ------------------------------------------------- (MAX, MAX) under a hash_fn


def test_a_user_hash_of_max_max_is_kept_as_the_reference_keeps_it():
    """Salts that send the pre-scramble hash of the key 77 to (MAX, MAX) in
    rows 0, 2 and 5: under a ``hash_fn`` the reference runs its XLA
    sort-merge, which keeps 77 while the row is not full, and so does the
    port.  The default hash would drop it (the Pallas rule)."""
    R, k, B = 8, 64, 32
    jh, th = HASHES["shift"]
    js = JD.init(jr.key(9), R, k)
    salts = np.asarray(js.salts).copy()
    pre = (0, (77 * 31) & 0xFFFFFFFF)  # (77 >> 16, 77 * 31)
    for r in (0, 2, 5):
        salts[r, 2:] = TH.salt_for_target(pre, (0xFFFFFFFF, 0xFFFFFFFF), (int(salts[r, 0]), int(salts[r, 1])))
    js = js._replace(salts=jnp.asarray(salts))
    tile = np.random.default_rng(7).integers(1000, 1 << 20, (R, B)).astype(np.int32)
    tile[:, 3] = 77
    got = jax.jit(lambda s, t: JD.update(s, t, hash_fn=jh))(js, jnp.asarray(tile))
    ts = distinct_state_from_numpy(*(None if getattr(js, f) is None else np.asarray(getattr(js, f))
                                     for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts",
                                               "value_hi")), device="cpu")
    port = distinct_state_to_numpy(TD.update(ts, torch.from_numpy(tile), hash_fn=th))
    held = port["values"] == 77
    assert held[[0, 2, 5]].any(axis=1).all()
    for f in ("values", "hash_hi", "hash_lo", "size", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), port[f], err_msg=f)
    # the same keys' words as pre-hashed planes, and the default hash's rule
    default = distinct_state_to_numpy(TD.update(ts, torch.from_numpy(tile)))
    assert default["size"].sum() >= port["size"].sum() - 3


def test_pre_hashed_planes_of_the_keys_own_words_differ_only_by_the_max_rule():
    R, k, B = 8, 16, 64
    rng = np.random.default_rng(8)
    s = TD.init(key_from_seed(4), R, k)
    tile = torch.from_numpy(_elements(rng, R, B, "zipf"))
    hi, lo = TH.default_hash64(tile)
    a = TD.update_prehashed(s, tile, (TH.to_i32(hi), TH.to_i32(lo)))
    b = TD.update(s, tile)
    for f in ("values", "hash_hi", "hash_lo", "size", "count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_as_scalar_hash_is_the_references_and_drives_the_host_oracle():
    def tile_hash(v):
        bits = v.astype(np.int64).astype(np.uint32) if v.dtype.kind == "i" else v.view("uint32")
        lo = bits * np.uint32(2654435761)
        return lo ^ np.uint32(0xDEADBEEF), lo

    values = np.random.default_rng(10).integers(-(1 << 31), 1 << 31, 64).astype(np.int32)
    mine, theirs = TH.as_scalar_hash(tile_hash), JH.as_scalar_hash(tile_hash)
    assert [mine(int(v)) for v in values] == [theirs(int(v)) for v in values]
    salts = (0x0123456789ABCDEF, 0xFEDCBA9876543210)
    a = BottomKOracle(16, np.random.default_rng(11), hash_fn=mine, salts=salts)
    b = JOracle(16, np.random.default_rng(11), hash_fn=theirs, salts=salts)
    a.sample_all(int(x) for x in values)
    b.sample_all(int(x) for x in values)
    assert [int(x) for x in a.result()] == [int(x) for x in b.result()]


# ------------------------------------------------ bridge, gate, recovery


S, K, B = 4, 3, 8


def _bkw(mode, **kw):
    return dict(max_sample_size=K, num_reservoirs=S, tile_size=B, weighted=mode == "weighted",
                distinct=mode == "distinct", **kw)


def _bridge_hooks(mode):
    """(jnp hooks, torch hooks) of a bridge in ``mode``."""
    if mode == "distinct":
        return (MAPS["low10"][0], HASHES["shift"][0]), (MAPS["low10"][1], HASHES["shift"][1])
    return (MAPS["affine"][0], None), (MAPS["affine"][1], None)


def _pushes(mode, rounds, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 30, (rounds, S, B)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, (rounds, S, B)).astype(np.float32) if mode == "weighted" else None
    return data, w


def _round(bridge, feed, r):
    data, w = feed
    for s in range(S):
        bridge.push(s, data[r, s], weights=None if w is None else w[r, s])


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
def test_bridge_with_hooks_equals_the_jax_bridge(mode):
    (jm, jh), (tm, th) = _bridge_hooks(mode)
    feed = _pushes(mode, 5, seed=1)
    jb = JBridge(JConfig(**_bkw(mode)), key=2, map_fn=jm, hash_fn=jh)
    tb = DeviceStreamBridge(SamplerConfig(**_bkw(mode)), key=2, map_fn=tm, hash_fn=th, device="cpu")
    for r in range(5):
        _round(jb, feed, r)
        _round(tb, feed, r)
    _same(jb.complete(), tb.complete())


def test_gated_bridge_with_a_map_equals_the_ungated_and_the_jax_one():
    cfg = dict(max_sample_size=4, num_reservoirs=3, tile_size=16)
    data = np.random.default_rng(17).integers(0, 1 << 20, (3, 160)).astype(np.int32)
    jm, tm = MAPS["affine"]

    def run(bridge):
        for off in range(0, 160, 16):
            for s in range(3):
                bridge.push(s, data[s, off:off + 16])
        return bridge.complete()

    ungated = run(DeviceStreamBridge(SamplerConfig(**cfg), key=2, map_fn=tm, device="cpu"))
    gated = DeviceStreamBridge(SamplerConfig(**cfg), key=2, map_fn=tm, gated=True, gate_tile=8,
                               device="cpu")
    got = run(gated)
    assert gated.metrics.snapshot()["gated_dispatches"] >= 1
    _same(ungated, got)
    _same(run(JBridge(JConfig(**cfg), key=2, map_fn=jm, gated=True, gate_tile=8)), got)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("mode", ["uniform", "distinct"])
def test_recover_with_hooks_across_packages(tmp_path, mode, direction):
    (jm, jh), (tm, th) = _bridge_hooks(mode)
    rounds, crash = 5, 3
    feed = _pushes(mode, rounds, seed=2)
    ref = DeviceStreamBridge(SamplerConfig(**_bkw(mode)), key=7, map_fn=tm, hash_fn=th, device="cpu")
    for r in range(rounds):
        _round(ref, feed, r)
    expected = ref.complete()
    ck = str(tmp_path / "ck")
    if direction == "jax_to_port":
        writer = JBridge(JConfig(**_bkw(mode)), key=7, map_fn=jm, hash_fn=jh, checkpoint_dir=ck,
                         checkpoint_every=2)
    else:
        writer = DeviceStreamBridge(SamplerConfig(**_bkw(mode)), key=7, map_fn=tm, hash_fn=th,
                                    checkpoint_dir=ck, checkpoint_every=2, device="cpu")
    for r in range(crash):
        _round(writer, feed, r)
    writer.drain_barrier()
    del writer
    gc.collect()
    if direction == "jax_to_port":
        with pytest.raises(ValueError, match="map_fn present; restore must match"):
            DeviceStreamBridge.recover(ck, device="cpu")
        recovered = DeviceStreamBridge.recover(ck, map_fn=tm, hash_fn=th, device="cpu")
    else:
        recovered = JBridge.recover(ck, map_fn=jm, hash_fn=jh)
    for r in range(crash, rounds):
        _round(recovered, feed, r)
    _same(expected, recovered.complete())


def test_standby_with_a_map_equals_its_primary_and_the_jax_standby(tmp_path):
    """A journaling bridge as the primary (no session table, so the
    standby follows its tiles alone), in each package, and a standby of
    each package over the other's directory too."""
    jm, tm = MAPS["affine"]
    cfg = _bkw("uniform")
    ck_j, ck_t = str(tmp_path / "j"), str(tmp_path / "t")
    jprim = JBridge(JConfig(**cfg), key=5, map_fn=jm, reusable=True, pipelined=False, checkpoint_dir=ck_j,
                    checkpoint_every=1000)
    tprim = DeviceStreamBridge(SamplerConfig(**cfg), key=5, map_fn=tm, reusable=True, pipelined=False,
                               checkpoint_dir=ck_t, checkpoint_every=1000, device="cpu")
    with pytest.raises(ValueError, match="map_fn present"):
        StandbyReplica(ck_t, device="cpu")
    standbys = [JStandby(ck_j, map_fn=jm), StandbyReplica(ck_j, map_fn=tm, device="cpu"),
                JStandby(ck_t, map_fn=jm), StandbyReplica(ck_t, map_fn=tm, device="cpu")]
    feed = _pushes("uniform", 3, seed=6)
    for r in range(3):
        for prim in (jprim, tprim):
            _round(prim, feed, r)
            prim.drain_barrier()
        for sb in standbys:
            sb.poll()
        want = tprim.engine.peek_arrays()
        _same(jprim.engine.peek_arrays(), want)
        for sb in standbys:
            _same(sb.service.bridge.engine.peek_arrays(), want)


@pytest.mark.parametrize("mode", ["uniform", "distinct"])
def test_checkpoints_with_hooks_go_both_ways(tmp_path, mode):
    (jm, jh), (tm, th) = _bridge_hooks(mode)
    kw = _bkw(mode)
    rng = np.random.default_rng(9)
    tiles = [rng.integers(0, 1 << 20, (S, B)).astype(np.int32) for _ in range(3)]
    jeng = JEngine(JConfig(**kw), key=1, map_fn=jm, hash_fn=jh, reusable=True)
    teng = ReservoirEngine(SamplerConfig(**kw), key=1, map_fn=tm, hash_fn=th, reusable=True, device="cpu")
    for e in (jeng, teng):
        e.sample(tiles[0])
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jeng.save(jpath)
    teng.save(tpath)
    # a hook on one side and not on the other is the reference's ValueError
    with pytest.raises(ValueError, match="map_fn present; restore must match"):
        ReservoirEngine.restore(jpath, device="cpu")
    with pytest.raises(ValueError, match="map_fn present; restore must match"):
        JEngine.restore(tpath)
    with pytest.raises(ValueError, match="map_fn absent; restore must match"):
        ReservoirEngine.restore(str(_plain_checkpoint(tmp_path, kw)), map_fn=tm, device="cpu")
    from_jax = ReservoirEngine.restore(jpath, map_fn=tm, hash_fn=th, device="cpu")
    from_port = JEngine.restore(tpath, map_fn=jm, hash_fn=jh)
    for a, b in ((jeng, from_jax), (from_port, teng)):
        for t in tiles[1:]:
            a.sample(t)
            b.sample(t)
        _same_results(a, b)


def _plain_checkpoint(tmp_path, kw):
    path = tmp_path / "plain.npz"
    ReservoirEngine(SamplerConfig(**kw), key=1, device="cpu").save(str(path))
    return path


def test_a_mapped_key_hashed_to_max_max_is_kept_as_the_reference_keeps_it():
    """With a ``map_fn`` and the default hash the reference runs its XLA
    sort-merge, which keeps a mapped key whose scrambled hash is (MAX,
    MAX) while the row is not full; the port takes its pre-hashed merge
    (its keep-max rule on the mapped keys' own words) and keeps it too.
    Without the map the same key is dropped (the Pallas rule of the default
    merge)."""
    R, k, B = 8, 64, 32
    jm, tm = MAPS["low10"]
    js = JD.init(jr.key(9), R, k)
    salts = np.asarray(js.salts).copy()
    for r in (0, 2, 5):  # the mapped key 77 goes to (MAX, MAX) in these rows
        salts[r, 2:] = TH.salt_for_target((0, 77), (0xFFFFFFFF, 0xFFFFFFFF), (int(salts[r, 0]), int(salts[r, 1])))
    js = js._replace(salts=jnp.asarray(salts))
    tile = np.random.default_rng(7).integers(1000, 1 << 20, (R, B)).astype(np.int32)
    tile[:, 3] = 77 + 1024  # maps to 77
    xla = jax.jit(lambda s, t: JD.update(s, t, map_fn=jm))(js, jnp.asarray(tile))
    ts = distinct_state_from_numpy(*(None if getattr(js, f) is None else np.asarray(getattr(js, f))
                                     for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts",
                                               "value_hi")), device="cpu")
    port = distinct_state_to_numpy(TD.update(ts, torch.from_numpy(tile), map_fn=tm))
    assert (port["values"][[0, 2, 5]] == 77).any(axis=1).all()
    for f in ("values", "hash_hi", "hash_lo", "size", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(xla, f)), port[f], err_msg=f)
    unmapped = tile & 0x3FF
    plain = distinct_state_to_numpy(TD.update(ts, torch.from_numpy(unmapped)))
    assert not (plain["values"][[0, 2, 5]] == 77).any()


# ------------------------------- (MAX, MAX) on a ragged or mapped tile (C.9)


def _planted_state(R, k, target, wide):
    """A JAX distinct state whose rows 0, 2 and 5 send the pre-scramble
    words ``target`` to (MAX, MAX), and its twin in the port."""
    js = JD.init(jr.key(9), R, k, sample_dtype=jnp.int64 if wide else jnp.int32)
    salts = np.asarray(js.salts).copy()
    for r in (0, 2, 5):
        salts[r, 2:] = TH.salt_for_target(target, (0xFFFFFFFF, 0xFFFFFFFF), (int(salts[r, 0]), int(salts[r, 1])))
    js = js._replace(salts=jnp.asarray(salts))
    ts = distinct_state_from_numpy(*(None if getattr(js, f) is None else np.asarray(getattr(js, f))
                                     for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts",
                                               "value_hi")), device="cpu")
    return js, ts


def _holds(state, rows, key):
    """Whether each of ``rows`` holds the 8-byte (or 4-byte) ``key``."""
    host = distinct_state_to_numpy(state)
    lo = host["values"].view(np.uint32).astype(np.uint64)
    hi = np.zeros_like(lo) if host["value_hi"] is None else host["value_hi"].astype(np.uint64)
    return (((hi << np.uint64(32)) | lo) == np.uint64(key))[rows].any(axis=1)


@pytest.mark.parametrize("wide", [False, True])
def test_a_ragged_bridge_flush_keeps_a_hash_of_max_max_as_the_jax_bridge(wide):
    """C.9 through the bridge: its flushes always pass ``valid``, so the
    reference's engine runs them on XLA, which keeps the planted key in
    rows that are not full.  Rows of different lengths (a ragged flush);
    the port's bridge equals the JAX bridge, every field of the state."""
    R, k, width = 8, 64, 32
    js, ts = _planted_state(R, k, (0, 77), wide)
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=width, distinct=True,
              element_dtype="int64" if wide else "int32")
    jb = JBridge(JConfig(**kw), _engine=JEngine(JConfig(**kw), _initial_state=js))
    tb = DeviceStreamBridge(SamplerConfig(**kw), device="cpu",
                            _engine=ReservoirEngine(SamplerConfig(**kw), _initial_state=ts, device="cpu"))
    rng = np.random.default_rng(3)
    for r in range(R):
        chunk = rng.integers(1000, 1 << 20, 5 + 3 * r).astype(np.int64 if wide else np.int32)
        chunk[2] = 77
        jb.push(r, chunk)
        tb.push(r, chunk)
    for b in (jb, tb):
        b.flush()
        b.drain_barrier()
    _same_state(jb.engine, tb.engine)
    assert _holds(tb.engine.state, [0, 2, 5], 77).all()


@pytest.mark.parametrize("wide", [False, True])
def test_a_map_only_engine_keeps_a_hash_of_max_max_as_the_jax_engine(wide):
    """C.9's sibling: under ``map_fn`` alone the reference hashes the
    mapped keys' own words on XLA, and the port's engine (keep-max) equals
    the JAX engine on full tiles whose mapped key hashes to (MAX, MAX) in
    rows that are not full, every field."""
    R, k, width = 8, 64, 32
    name = "xor64" if wide else "low10"
    target = (0x1234, 77) if wide else (0, 77)  # the mapped key's words
    js, ts = _planted_state(R, k, target, wide)
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=width, distinct=True,
              element_dtype="int64" if wide else "int32")
    jm, tm = MAPS[name]
    jeng = JEngine(JConfig(**kw), map_fn=jm, _initial_state=js)
    teng = ReservoirEngine(SamplerConfig(**kw), map_fn=tm, _initial_state=ts, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(2):
        tile = rng.integers(1000, 1 << 20, (R, width)).astype(np.int64 if wide else np.int32)
        tile[:, 3] = 77 if wide else 77 + 1024  # maps to the planted key
        jeng.sample(tile)
        teng.sample(tile)
        _same_state(jeng, teng)
    assert _holds(teng.state, [0, 2, 5], (target[0] << 32) | target[1]).all()


def test_hash_planes_views_a_32_bit_hash_and_converts_the_rest():
    """The card path's hash planes: a 32-bit ``hash_fn`` result of the
    tile's shape is the kernel's int32 plane as a view (no int64 round
    trip), any other result the low 32 bits of :func:`hooks.hash_words`,
    as int32 bits; a float word raises as ``hash_words`` does."""
    tile = torch.from_numpy(np.random.default_rng(12).integers(-(1 << 31), 1 << 31, (4, 16)).astype(np.int32))
    words32 = (tile >> 16, tile * 31)
    hi, lo = hooks.hash_planes(lambda v: words32, tile)
    assert hi.dtype == lo.dtype == torch.int32
    assert hi.data_ptr() == words32[0].data_ptr() and lo.data_ptr() == words32[1].data_ptr()
    for fn in (lambda v: (v >> 16, v * 31), lambda v: (v.to(torch.int64) << 7, 5),
               lambda v: (v.view(torch.uint32), v.to(torch.int16))):
        got = hooks.hash_planes(fn, tile)
        want = hooks.hash_words(fn, tile)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == tile.shape and g.is_contiguous()
            assert torch.equal(g, TH.to_i32(w))
    with pytest.raises(ValueError, match="integer words"):
        hooks.hash_planes(lambda v: (v * 0.5, v), tile)
