"""The port's sharded engine (L4) against the JAX package's on its 8
virtual CPU devices, with the port's ranks ``make_mesh(devices=["cpu"] *
8)``: a meshed engine equals the JAX meshed engine and the port's unmeshed
engine bit for bit, in every mode, with WIDE counters, 8-byte distinct
keys, hooks, ragged and fused streams and row operations; the JAX
engine's Pallas kernels under its mesh (interpret mode) too; the helpers
of ``parallel.sharded`` against ``reservoir_tpu.parallel``'s; meshed
checkpoints in both directions and the pre-flight; the meshed bridge with
``recover``; and the reference's errors, word for word."""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu import parallel as JP
from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import weighted as JW
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu.utils import checkpoint as jckpt
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig, convert
from reservoir_tpu_torch.errors import CheckpointMismatch
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import weighted as TW
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    reservoir_sharding,
    shard_state,
    sharded_result,
    sharded_update,
    state_shardings,
)
from reservoir_tpu_torch.parallel.sharded import gather_state
from reservoir_tpu_torch.utils import checkpoint as tckpt

R, K, B = 16, 8, 32
#: the port's 8 ranks on the CPU, as the JAX package's tests run 8 virtual devices
CPU8 = ["cpu"] * 8

MODES = {
    "uniform": {},
    "weighted": {"weighted": True},
    "distinct": {"distinct": True},
    "wide": {"count_dtype": "wide"},
    "distinct_int64": {"distinct": True, "element_dtype": "int64"},
}


def _cfg(cls, mode, mesh_axis=None, **kw):
    base = dict(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis=mesh_axis)
    base.update(MODES[mode])
    base.update(kw)
    return cls(**base)


def _trio(mode, key=11, **kw):
    """The JAX meshed engine, the port's meshed engine (8 CPU ranks) and
    the port's unmeshed one, same key."""
    return (
        JEngine(_cfg(JConfig, mode, "res", **kw), key=key, reusable=True),
        ReservoirEngine(_cfg(SamplerConfig, mode, "res", **kw), key=key, reusable=True,
                        mesh=make_mesh(devices=CPU8)),
        ReservoirEngine(_cfg(SamplerConfig, mode, **kw), key=key, reusable=True, device="cpu"),
    )


def _tile(rng, mode, width=B):
    if mode.startswith("distinct"):
        dtype = np.int64 if mode.endswith("int64") else np.int32
        hi = (1 << 40) if dtype == np.int64 else 97
        return rng.integers(-hi, hi, (R, width)).astype(dtype)
    return rng.integers(0, 1 << 30, (R, width)).astype(np.int32)


def _feed(engines, mode, rng, ragged=False):
    tile = _tile(rng, mode)
    kw = {}
    if mode == "weighted":
        w = rng.uniform(0.1, 2.0, (R, B)).astype(np.float32)
        w[:, ::5] = 0.0
        kw["weights"] = w
    if ragged:
        kw["valid"] = rng.integers(0, B + 1, R).astype(np.int32)
    for eng in engines:
        eng.sample(tile, **kw)


def _jax_host(state):
    """A JAX state's fields as numpy (keys as their uint32 words)."""
    out = {}
    for name, value in zip(type(state)._fields, state):
        if value is not None and jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        out[name] = None if value is None else np.asarray(value)
    return out


def _same_states(jstate, *tstates):
    want = _jax_host(jstate)
    for tstate in tstates:
        got = convert.state_to_numpy(tstate)
        for name, w in want.items():
            g = got[name]
            assert (w is None) == (g is None), name
            if w is not None:
                np.testing.assert_array_equal(w.view(np.uint8), g.view(np.uint8), err_msg=name)


def _same_results(jeng, *engines):
    js, jz = jeng.peek_arrays()
    for eng in engines:
        ts, tz = eng.peek_arrays()
        np.testing.assert_array_equal(js.view(np.uint8), ts.view(np.uint8))
        np.testing.assert_array_equal(jz, tz)


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("mode", list(MODES))
def test_meshed_engine_equals_the_jax_meshed_engine_and_the_unmeshed_one(mode):
    rng = np.random.default_rng(5)
    jeng, meshed, single = _trio(mode)
    for step in range(5):
        _feed((jeng, meshed, single), mode, rng, ragged=step in (2, 4))
    _same_states(jeng.state, meshed.state, single.state)
    _same_results(jeng, meshed, single)
    # the rows really live on the 8 ranks, one block each
    assert len(meshed._shards) == 8
    assert {int(s[0].shape[0]) for s in meshed._shards} == {R // 8}
    assert meshed.device is None and meshed.mesh.shape == {"res": 8}


def test_meshed_engine_takes_device_tensors_and_8_byte_planes():
    rng = np.random.default_rng(6)
    jeng, meshed, single = _trio("distinct_int64")
    for step in range(3):
        tile = _tile(rng, "distinct_int64")
        jeng.sample(tile)
        meshed.sample(torch.from_numpy(tile) if step == 1 else tile)
        single.sample(tile)
    _same_states(jeng.state, meshed.state, single.state)
    _same_results(jeng, meshed, single)


#: hooks: (mode, config overrides, JAX hooks, port hooks)
HOOKED = {
    "map_to_float": ("uniform", {"sample_dtype": "float32"},
                     {"map_fn": lambda x: (x >> 8).astype(jnp.float32) * 0.5},
                     {"map_fn": lambda x: (x >> 8).to(torch.float32) * 0.5}),
    "map_weighted": ("weighted", {}, {"map_fn": lambda x: x * 3 + 7}, {"map_fn": lambda x: x * 3 + 7}),
    "hash_distinct": ("distinct", {}, {"hash_fn": lambda v: (v >> 16, v * 31)},
                      {"hash_fn": lambda v: (v >> 16, v * 31)}),
}


@pytest.mark.parametrize("case", list(HOOKED))
def test_meshed_engine_with_hooks_equals_the_jax_meshed_engine(case):
    mode, over, jhooks, thooks = HOOKED[case]
    rng = np.random.default_rng(7)
    jeng = JEngine(_cfg(JConfig, mode, "res", **over), key=3, reusable=True, **jhooks)
    meshed = ReservoirEngine(_cfg(SamplerConfig, mode, "res", **over), key=3, reusable=True,
                             mesh=make_mesh(devices=CPU8), **thooks)
    single = ReservoirEngine(_cfg(SamplerConfig, mode, **over), key=3, reusable=True, device="cpu",
                             **thooks)
    for step in range(4):
        _feed((jeng, meshed, single), mode, rng, ragged=step == 2)
    _same_states(jeng.state, meshed.state, single.state)
    _same_results(jeng, meshed, single)


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct_int64"])
def test_meshed_fused_stream_equals_the_jax_meshed_fused_stream(mode):
    rng = np.random.default_rng(8)
    n = 4 * B + 9
    stream = _tile(rng, mode, n)
    kw = {}
    if mode == "weighted":
        kw["weights"] = rng.uniform(0.1, 2.0, (R, n)).astype(np.float32)
    jeng, meshed, single = _trio(mode)
    jeng.sample_stream(stream, fused=True, **kw)
    meshed.sample_stream(stream, fused=True, **kw)
    single.sample_stream(stream, **kw)
    _same_states(jeng.state, meshed.state, single.state)


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct", "wide"])
def test_meshed_row_operations_equal_the_jax_meshed_engine(mode):
    rng = np.random.default_rng(9)
    jeng, meshed, single = _trio(mode)
    engines = (jeng, meshed, single)
    for _ in range(2):
        _feed(engines, mode, rng)
    # rows on several ranks, one repeated: its last occurrence wins
    rows = np.asarray([14, 1, 7, 8, 1, 3], np.int32)
    for eng in engines:
        eng.reset_rows(rows, 21)
    _feed(engines, mode, rng)
    src, dst = [0, 5, 13, 9], [15, 2, 6, 10]
    for eng in engines:
        eng.adopt_rows(dst, eng.export_rows(src))
    _feed(engines, mode, rng, ragged=True)
    _same_states(jeng.state, meshed.state, single.state)
    # an export of the meshed engine is the unmeshed one's, rows in order
    a, b = convert.state_to_numpy(meshed.export_rows([12, 3, 3])), \
        convert.state_to_numpy(single.export_rows([12, 3, 3]))
    for name in a:
        if a[name] is not None:
            np.testing.assert_array_equal(a[name].view(np.uint8), b[name].view(np.uint8))


#: the reference's Pallas-under-mesh cases (tests/test_engine_sharded.py):
#: (config, tiles)
PALLAS = {
    "uniform": (dict(max_sample_size=16, num_reservoirs=512, tile_size=64), "uniform"),
    "weighted": (dict(max_sample_size=8, num_reservoirs=512, tile_size=64, weighted=True), "weighted"),
    "distinct": (dict(max_sample_size=16, num_reservoirs=64, tile_size=64, distinct=True), "distinct"),
}


@pytest.mark.parametrize("case", list(PALLAS))
def test_meshed_engine_equals_the_jax_pallas_kernels_under_a_mesh(case):
    cfg, kind = PALLAS[case]
    rows, width = cfg["num_reservoirs"], cfg["tile_size"]
    rng = np.random.default_rng(11)
    tiles = [rng.integers(0, 200 if kind == "distinct" else 1 << 30, (rows, width)).astype(np.int32)
             for _ in range(3)]
    wts = [rng.integers(1, 5, (rows, width)).astype(np.float32) for _ in range(3)]
    wts[1][:, ::3] = 0.0
    jeng = JEngine(JConfig(impl="pallas", mesh_axis="res", **cfg), key=9, reusable=True)
    meshed = ReservoirEngine(SamplerConfig(impl="pallas", mesh_axis="res", **cfg), key=9, reusable=True,
                             mesh=make_mesh(devices=CPU8))
    for t, w in zip(tiles, wts):
        kw = {"weights": w} if kind == "weighted" else {}
        jeng.sample(t, **kw)
        meshed.sample(t, **kw)
    assert jeng.pallas_used()
    _same_results(jeng, meshed)


# ------------------------------------------------------------------ errors


def _message(make):
    with pytest.raises(Exception) as info:
        make()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["uneven", "mesh_without_axis", "device_with_mesh", "sample_gated",
                                  "too_many_devices"])
def test_errors_are_the_references_word_for_word(case):
    if case == "uneven":
        want = _message(lambda: JEngine(JConfig(max_sample_size=4, num_reservoirs=12, mesh_axis="res")))
        got = _message(lambda: ReservoirEngine(SamplerConfig(max_sample_size=4, num_reservoirs=12,
                                                             mesh_axis="res"), mesh=make_mesh(devices=CPU8)))
        assert "divide" in got[1]
    elif case == "mesh_without_axis":
        want = _message(lambda: JEngine(_cfg(JConfig, "uniform"), mesh=JP.make_mesh(8)))
        got = _message(lambda: ReservoirEngine(_cfg(SamplerConfig, "uniform"), mesh=make_mesh(devices=CPU8)))
    elif case == "device_with_mesh":
        want = _message(lambda: JEngine(_cfg(JConfig, "uniform", "res"), device=jax.devices()[0]))
        got = _message(lambda: ReservoirEngine(_cfg(SamplerConfig, "uniform", "res"), device="cpu",
                                               mesh=make_mesh(devices=CPU8)))
    elif case == "sample_gated":
        args = (np.zeros((R, 4), np.int32), np.zeros(R, np.int32), np.zeros(R, np.int32))
        want = _message(lambda: _trio("uniform")[0].sample_gated(*args))
        got = _message(lambda: _trio("uniform")[1].sample_gated(*args))
    else:
        want = _message(lambda: JP.make_mesh(9))
        got = _message(lambda: make_mesh(9, devices=CPU8))
    assert got == want


def test_a_default_mesh_needs_a_card_or_names_devices():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default mesh is its cards")
    with pytest.raises(RuntimeError, match=r"devices=\["):
        make_mesh()
    with pytest.raises(RuntimeError, match=r"devices=\["):
        ReservoirEngine(_cfg(SamplerConfig, "uniform", "res"))


def test_a_mesh_holds_all_cpu_or_all_cuda_ranks_of_one_axis():
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])
    with pytest.raises(ValueError, match="one axis"):
        Mesh(CPU8, ("a", "b"))
    assert make_mesh(4, axis="r", devices=CPU8).shape == {"r": 4}


# ------------------------------------------------------------------ helpers


def _jstate(mode, rows=64, k=K):
    if mode == "weighted":
        return JW.init(jr.key(5), rows, k)
    if mode == "distinct":
        return JD.init(jr.key(5), rows, k)
    return JA.init(jr.key(5), rows, k, count_dtype="wide" if mode == "wide" else jnp.int32)


def _tstate(mode, rows=64, k=K):
    key = key_from_seed(5)
    if mode == "weighted":
        return TW.init(key, rows, k)
    if mode == "distinct":
        return TD.init(key, rows, k)
    return TA.init(key, rows, k, count_dtype="wide" if mode == "wide" else "int32")


def _jax_shards(jstate):
    """Each JAX leaf's addressable shards in row order, as numpy."""
    out = []
    for name, value in zip(type(jstate)._fields, jstate):
        if value is None:
            out.append(None)
            continue
        if jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        shards = sorted(value.addressable_shards, key=lambda s: s.index[0].start or 0)
        out.append([np.asarray(s.data) for s in shards])
    return out


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct", "wide"])
def test_shard_state_places_the_rows_of_the_jax_shard_state(mode):
    jmesh, tmesh = JP.make_mesh(8), make_mesh(devices=CPU8)
    want = _jax_shards(JP.shard_state(_jstate(mode), jmesh))
    got = shard_state(_tstate(mode), tmesh)
    assert len(got) == 8
    for i, shard in enumerate(got):
        host = convert.state_to_numpy(shard)
        for name, w in zip(type(shard)._fields, want):
            if w is None:
                assert host[name] is None
                continue
            np.testing.assert_array_equal(host[name].view(np.uint8), w[i].view(np.uint8), err_msg=name)
    # the placement description: each rank's rows, as the JAX sharding's
    jsh = JP.reservoir_sharding(jmesh)
    index = jsh.devices_indices_map((64,))
    starts = [index[d][0].start or 0 for d in jmesh.devices.flat]
    blocks = reservoir_sharding(tmesh).blocks(64)
    assert [b.start for b in blocks] == starts and [b.stop - b.start for b in blocks] == [8] * 8
    shs = state_shardings(_tstate(mode), tmesh)
    assert all(s is None or s.blocks(64) == blocks for s in shs)
    # gathered back in rank order, the state is the unsharded one
    whole = convert.state_to_numpy(gather_state(got, "cpu"))
    for name, value in convert.state_to_numpy(_tstate(mode)).items():
        if value is not None:
            np.testing.assert_array_equal(whole[name].view(np.uint8), value.view(np.uint8))


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
def test_sharded_update_fill_and_steady_equal_the_jax_helpers(mode):
    rows = 64
    jmesh, tmesh = JP.make_mesh(8), make_mesh(devices=CPU8)
    ops = {"uniform": (JA, TA), "weighted": (JW, TW), "distinct": (JD, TD)}[mode]
    rng = np.random.default_rng(12)
    jst = JP.shard_state(_jstate(mode, rows), jmesh)
    tst = shard_state(_tstate(mode, rows), tmesh)
    spec = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("res", None))
    for steady in (False, False, True):
        tile = rng.integers(0, 97 if mode == "distinct" else 1 << 30, (rows, B)).astype(np.int32)
        extra = ()
        if mode == "weighted":
            extra = (rng.uniform(0.1, 2.0, (rows, B)).astype(np.float32),)
        jst = JP.sharded_update(jmesh, steady=steady, ops=ops[0])(
            jst, jax.device_put(jnp.asarray(tile), spec),
            *(jax.device_put(jnp.asarray(e), spec) for e in extra))
        tst = sharded_update(tmesh, steady=steady, ops=ops[1])(tst, tile, *extra)
    _same_states(jst, gather_state(tst, "cpu"))


def _with_counts(mode, counts):
    """A uniform state of ``len(counts)`` rows whose counts are ``counts``
    (int32, or WIDE (lo, hi) words), in both packages."""
    rows = len(counts)
    tstate = _tstate(mode, rows)
    host = convert.state_to_numpy(tstate)
    host["count"] = counts
    t = convert.state_from_numpy(host["samples"], host["count"], host["nxt"], host["log_w"], host["key"],
                                 device="cpu")
    j = JA.ReservoirState(jnp.asarray(host["samples"]), jnp.asarray(counts), jnp.asarray(host["nxt"]),
                          jnp.asarray(host["log_w"]), jr.wrap_key_data(jnp.asarray(host["key"])))
    return j, t


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct", "wide"])
def test_sharded_result_gathers_every_rank_as_the_jax_helper(mode):
    rows = 64
    jmesh, tmesh = JP.make_mesh(8), make_mesh(devices=CPU8)
    ops = {"uniform": (JA, TA), "weighted": (JW, TW), "distinct": (JD, TD), "wide": (JA, TA)}[mode]
    rng = np.random.default_rng(13)
    jst = JP.shard_state(_jstate(mode, rows), jmesh)
    tst = shard_state(_tstate(mode, rows), tmesh)
    spec = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("res", None))
    tile = rng.integers(0, 97 if mode == "distinct" else 1 << 30, (rows, B)).astype(np.int32)
    extra = (rng.uniform(0.1, 2.0, (rows, B)).astype(np.float32),) if mode == "weighted" else ()
    jst = JP.sharded_update(jmesh, ops=ops[0])(jst, jax.device_put(jnp.asarray(tile), spec),
                                               *(jax.device_put(jnp.asarray(e), spec) for e in extra))
    tst = sharded_update(tmesh, ops=ops[1])(tst, tile, *extra)
    js, jz, jt = JP.sharded_result(jmesh, ops=ops[0])(jst)
    ts, tz, tt = sharded_result(tmesh, ops=ops[1])(tst)
    assert len(ts) == len(tz) == len(tt) == 8
    for s, z, t in zip(ts, tz, tt):
        np.testing.assert_array_equal(np.asarray(js).view(np.uint8), s.numpy().view(np.uint8))
        np.testing.assert_array_equal(np.asarray(jz), z.numpy())
        if mode == "wide":
            assert t.dtype == torch.float32 and float(t) == float(jt)
        else:
            assert t.dtype == torch.int32 and int(t) == int(jt) == rows * B


def test_sharded_result_total_wraps_as_the_jax_int32_sum():
    rng = np.random.default_rng(14)
    counts = rng.integers(2**30, 2**31 - 1, 64).astype(np.int32)
    j, t = _with_counts("uniform", counts)
    jmesh, tmesh = JP.make_mesh(8), make_mesh(devices=CPU8)
    jt = JP.sharded_result(jmesh)(JP.shard_state(j, jmesh))[2]
    tt = sharded_result(tmesh)(shard_state(t, tmesh))[2]
    want = int(np.asarray(jt))
    assert want != int(counts.astype(np.int64).sum())  # the sum wrapped
    assert {int(x) for x in tt} == {want}


#: the WIDE total is a float32 sum of 64 values; torch and XLA add them in
#: different orders, so the two agree to float32 rounding, not bit for bit
WIDE_TOTAL_RTOL = 1e-6


def test_sharded_result_wide_total_is_the_jax_float32_total():
    rng = np.random.default_rng(15)
    values = rng.integers(2**31, 2**40, 64).astype(np.uint64)
    counts = np.stack([values & 0xFFFFFFFF, values >> 32], axis=1).astype(np.uint32)
    j, t = _with_counts("wide", counts)
    jmesh, tmesh = JP.make_mesh(8), make_mesh(devices=CPU8)
    jt = float(np.asarray(JP.sharded_result(jmesh)(JP.shard_state(j, jmesh))[2]))
    for tt in sharded_result(tmesh)(shard_state(t, tmesh))[2]:
        assert tt.dtype == torch.float32
        np.testing.assert_allclose(float(tt), jt, rtol=WIDE_TOTAL_RTOL)
    np.testing.assert_allclose(jt, float(values.astype(np.float64).sum()), rtol=WIDE_TOTAL_RTOL)


# -------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct_int64"])
def test_meshed_checkpoints_restore_across_the_packages(tmp_path, mode):
    rng = np.random.default_rng(16)
    jeng, meshed, single = _trio(mode)
    _feed((jeng, meshed, single), mode, rng)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jeng.save(jpath)
    meshed.save(tpath)
    from_jax = ReservoirEngine.restore(jpath, mesh=make_mesh(devices=CPU8))
    from_port = ReservoirEngine.restore(tpath, mesh=make_mesh(devices=CPU8))
    jax_from_port = JEngine.restore(tpath)
    assert from_jax.config.mesh_axis == "res" and len(from_jax._shards) == 8
    # a mesh of 4 ranks takes the rows as well
    four = ReservoirEngine.restore(tpath, mesh=make_mesh(4, devices=CPU8))
    assert len(four._shards) == 4
    engines = (jeng, meshed, single, from_jax, from_port, jax_from_port, four)
    _feed(engines, mode, rng)
    _same_states(jeng.state, meshed.state, single.state, from_jax.state, from_port.state, four.state)
    _same_states(jax_from_port.state, single.state)


def test_preflight_refuses_a_mesh_the_rows_do_not_divide_over(tmp_path, monkeypatch):
    path = str(tmp_path / "mesh.npz")
    eng = JEngine(JConfig(max_sample_size=4, num_reservoirs=8, tile_size=8, mesh_axis="res"), key=0,
                  reusable=True)
    eng.sample(np.arange(64, dtype=np.int32).reshape(8, 8))
    eng.save(path)
    with pytest.raises(CheckpointMismatch) as got:
        tckpt.load_engine(path, mesh=make_mesh(5, devices=CPU8))
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 5)
    with pytest.raises(jckpt.CheckpointMismatch) as want:
        jckpt.load_engine(path)
    assert str(got.value) == str(want.value)
    assert "5 device(s)" in str(got.value) and "taken on 8 cpu device(s)" in str(got.value)


def test_a_port_meshed_checkpoint_names_its_ranks_in_the_preflight(tmp_path):
    path = str(tmp_path / "port.npz")
    eng = ReservoirEngine(SamplerConfig(max_sample_size=4, num_reservoirs=8, tile_size=8, mesh_axis="res"),
                          key=0, mesh=make_mesh(devices=CPU8))
    eng.save(path)
    with pytest.raises(CheckpointMismatch, match=r"over the 3 device\(s\).*taken on 8 cpu device\(s\)"):
        ReservoirEngine.restore(path, mesh=make_mesh(3, devices=CPU8))


# ------------------------------------------------------------------ bridge


def _pushes(seed, n, weighted):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, R, n).astype(np.int32)
    vals = rng.integers(0, 1 << 20, n).astype(np.int32)
    w = (0.25 + rng.random(n)).astype(np.float32) if weighted else None
    return ids, vals, w


@pytest.mark.parametrize("mode", ["uniform", "weighted"])
def test_meshed_bridge_equals_the_jax_meshed_bridge(mode):
    ids, vals, w = _pushes(3, 5000, mode == "weighted")
    out = []
    jb = JBridge(_cfg(JConfig, mode, "res"), key=29)
    tb = DeviceStreamBridge(_cfg(SamplerConfig, mode, "res"), key=29, mesh=make_mesh(devices=CPU8))
    sb = DeviceStreamBridge(_cfg(SamplerConfig, mode), key=29, device="cpu")
    for bridge in (jb, tb, sb):
        bridge.push_interleaved(ids, vals, w)
        out.append(bridge.complete())
    for got in out[1:]:
        for a, b in zip(out[0], got):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_meshed_bridge_keeps_the_gate_inert_with_the_references_reason():
    ids, vals, _ = _pushes(4, 3000, False)
    jb = JBridge(_cfg(JConfig, "uniform", "res"), key=31, gated=True)
    tb = DeviceStreamBridge(_cfg(SamplerConfig, "uniform", "res"), key=31, gated=True,
                            mesh=make_mesh(devices=CPU8))
    assert not tb.gate_active
    assert tb.gate_inert_reason == jb.gate_inert_reason == "meshed engine (gated dispatch is single-device)"
    results = []
    for bridge in (jb, tb):
        bridge.push_interleaved(ids, vals)
        results.append(bridge.complete())
    for a, b in zip(*results):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_meshed_bridge_recovers_onto_the_mesh(tmp_path, writer):
    rng = np.random.default_rng(17)
    rounds, crash = 6, 4
    # a push of B elements fills its row: each push is one flush, and
    # nothing is staged at the crash
    data = rng.integers(0, 1 << 30, (rounds, R, B)).astype(np.int32)

    def feed(bridge, r):
        for s in range(R):
            bridge.push(s, data[r, s])

    ref = JBridge(_cfg(JConfig, "uniform", "res"), key=7)
    for r in range(rounds):
        feed(ref, r)
    expected = ref.complete()
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        live = JBridge(_cfg(JConfig, "uniform", "res"), key=7, checkpoint_dir=ckdir, checkpoint_every=3)
    else:
        live = DeviceStreamBridge(_cfg(SamplerConfig, "uniform", "res"), key=7, checkpoint_dir=ckdir,
                                  checkpoint_every=3, mesh=make_mesh(devices=CPU8))
    for r in range(crash):
        feed(live, r)
    live.drain_barrier()
    assert live.flushed_seq == crash * R
    del live  # the crash: no complete(), no clean shutdown
    gc.collect()
    recovered = DeviceStreamBridge.recover(ckdir, mesh=make_mesh(devices=CPU8))
    assert recovered.metrics.recoveries == 1
    assert len(recovered._engine._shards) == 8
    for r in range(crash, rounds):
        feed(recovered, r)
    for a, b in zip(expected, recovered.complete()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
