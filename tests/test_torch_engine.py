"""The port's ``ReservoirEngine`` (uniform, weighted and distinct modes,
``device="cpu"``) against the JAX package's engine on the same tiles, bit
for bit; its lifecycle; checkpoints across the two packages in both
directions; and the port's rules: no CPU fallback, no import of jax or
``reservoir_tpu``, and a named ``NotImplementedError`` for what the port
does not run yet."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu_torch import convert
from reservoir_tpu_torch import (
    CheckpointCorrupt,
    CheckpointMismatch,
    ReservoirEngine,
    SamplerClosedError,
    SamplerConfig,
)
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import distinct_cuda as TDK
from reservoir_tpu_torch.ops import weighted_cuda as TWK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NP = {"int32": np.int32, "float32": np.float32, "uint32": np.uint32}


def _pair(R, k, B, dtype="int32", seed=0, reusable=False):
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=dtype)
    return (
        JEngine(JConfig(**kw), key=seed, reusable=reusable),
        ReservoirEngine(SamplerConfig(**kw), key=seed, reusable=reusable, device="cpu"),
    )


def _tile(rng, R, B, dtype="int32"):
    t = rng.integers(0, 2**32, (R, B), dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        t[::3, 0] = 0x80000000  # -0.0
        t[1::3, -1] = 0x7FC00001  # NaN with a payload
    return t.view(_NP[dtype])


def _same_arrays(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def _same_state(jeng, teng):
    js, ts = jeng.state, teng.state
    for f in ("samples", "count", "nxt", "log_w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)).view(np.int32),
            getattr(ts, f).numpy().view(np.int32), err_msg=f,
        )
    np.testing.assert_array_equal(
        np.asarray(jr.key_data(js.key)).astype(np.int64), ts.key.numpy()
    )
    assert jeng._min_count == teng._min_count


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
def test_engine_equals_jax_engine_across_fill_steady_and_ragged_tiles(dtype):
    R, k, B = 24, 8, 32
    rng = np.random.default_rng(1)
    jeng, teng = _pair(R, k, B, dtype, seed=3, reusable=True)
    feeds = [
        (_tile(rng, R, 3, dtype), None),  # partial fill
        (_tile(rng, R, B, dtype), rng.integers(0, B + 1, R).astype(np.int32)),  # ragged fill
        (_tile(rng, R, B, dtype), None),  # crosses the fill boundary
        (_tile(rng, R, B, dtype), None),  # steady
        (_tile(rng, R, B, dtype), rng.integers(0, B + 1, R).astype(np.int32)),  # ragged steady
    ]
    for i, (tile, valid) in enumerate(feeds):
        jeng.sample(tile, valid)
        # the port also takes CPU tensors and lists
        t_in = torch.from_numpy(tile) if i % 2 else tile
        teng.sample(t_in, None if valid is None else torch.from_numpy(valid))
        _same_state(jeng, teng)
    _same_arrays(jeng.peek_arrays(), teng.peek_arrays())
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_int_key_and_key_words_give_the_same_engine():
    R, k, B = 8, 4, 16
    tile = _tile(np.random.default_rng(2), R, B)
    words = np.asarray(jr.key_data(jr.key(5)))
    a = ReservoirEngine(SamplerConfig(k, R, B), key=5, device="cpu")
    b = ReservoirEngine(SamplerConfig(k, R, B), key=words, device="cpu")
    a.sample(tile)
    b.sample(tile.tolist())
    _same_arrays(a.result_arrays(), b.result_arrays())


@pytest.mark.parametrize("width", [None, 24])
def test_sample_stream_with_a_ragged_tail_equals_jax(width):
    R, k, B = 16, 6, 32
    stream = _tile(np.random.default_rng(3), R, 3 * B + 37)
    jeng, teng = _pair(R, k, B, seed=4, reusable=True)
    jeng.sample_stream(stream, tile_width=width)
    teng.sample_stream(stream, tile_width=width)
    _same_state(jeng, teng)
    # a tensor stream takes the same path
    _, t2 = _pair(R, k, B, seed=4)
    t2.sample_stream(torch.from_numpy(stream), tile_width=width)
    _same_arrays(teng.peek_arrays(), t2.result_arrays())
    # and the engine keeps streaming after the masked tail
    more = _tile(np.random.default_rng(4), R, B)
    jeng.sample(more)
    teng.sample(more)
    _same_state(jeng, teng)


def test_sample_all_equals_jax_and_names_the_bad_item():
    R, k, B = 8, 4, 16
    rng = np.random.default_rng(5)
    items = [_tile(rng, R, B), (_tile(rng, R, B), np.full(R, 9, np.int32)), (_tile(rng, R, B),)]
    jeng, teng = _pair(R, k, B, seed=6)
    jeng.sample_all(items)
    teng.sample_all(items)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())
    _, teng = _pair(R, k, B)
    with pytest.raises(ValueError, match=r"tiles\[1\]"):
        teng.sample_all([_tile(rng, R, B), _tile(rng, R + 1, B)])


def test_result_truncates_like_the_jax_engine():
    R, k, B = 6, 5, 8
    valid = np.array([0, 1, 4, 5, 6, 8], np.int32)
    tile = np.arange(R * B, dtype=np.int32).reshape(R, B)
    jeng, teng = _pair(R, k, B, seed=1)
    jeng.sample(tile, valid)
    teng.sample(tile, valid)
    for a, b in zip(jeng.result(), teng.result()):
        np.testing.assert_array_equal(a, b)


def test_single_use_engine_closes_on_result():
    R, k, B = 4, 3, 8
    _, eng = _pair(R, k, B)
    eng.sample(np.zeros((R, B), np.int32))
    assert eng.is_open
    peeked = eng.peek_arrays()
    assert eng.is_open
    got = eng.result_arrays()
    _same_arrays(peeked, got)
    assert not eng.is_open
    for call in (lambda: eng.sample(np.zeros((R, B), np.int32)), eng.result_arrays,
                 eng.peek_arrays, eng.result, lambda: eng.state):
        with pytest.raises(SamplerClosedError):
            call()


def test_reusable_engine_stays_open_and_results_are_snapshots():
    R, k, B = 4, 3, 8
    _, eng = _pair(R, k, B, reusable=True)
    eng.sample(np.arange(R * B, dtype=np.int32).reshape(R, B))
    first = eng.result_arrays()
    kept = (first[0].copy(), first[1].copy())
    assert eng.is_open
    eng.sample(np.full((R, B), -5, np.int32))
    second = eng.result_arrays()
    _same_arrays(first, kept)
    assert (second[1] == k).all() and eng.is_open


def test_engine_rejects_bad_tiles():
    R, k, B = 4, 3, 8
    _, eng = _pair(R, k, B, reusable=True)
    with pytest.raises(ValueError, match="tile must be"):
        eng.sample(np.zeros((R + 1, B), np.int32))
    with pytest.raises(ValueError, match="valid entries"):
        eng.sample(np.zeros((R, B), np.int32), np.full(R, B + 1, np.int32))
    with pytest.raises(ValueError, match="valid must be"):
        eng.sample(np.zeros((R, B), np.int32), np.zeros(R + 1, np.int32))


# ------------------------------------------------------------- checkpoints


def test_jax_checkpoint_restores_into_the_port_and_continues(tmp_path):
    R, k, B = 12, 5, 16
    rng = np.random.default_rng(7)
    jeng, _ = _pair(R, k, B, seed=8, reusable=True)
    jeng.sample(_tile(rng, R, 3))
    jeng.sample(_tile(rng, R, B), rng.integers(0, B + 1, R).astype(np.int32))
    path = str(tmp_path / "jax.npz")
    jeng.save(path, metadata={"who": "jax"})
    teng = ReservoirEngine.restore(path, device="cpu")
    _same_state(jeng, teng)
    for _ in range(3):
        tile = _tile(rng, R, B)
        jeng.sample(tile)
        teng.sample(tile)
    _same_state(jeng, teng)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_port_checkpoint_restores_into_jax_and_continues(tmp_path):
    R, k, B = 12, 5, 16
    rng = np.random.default_rng(9)
    _, teng = _pair(R, k, B, dtype="float32", seed=10)
    for _ in range(2):
        teng.sample(_tile(rng, R, B, "float32"))
    path = str(tmp_path / "port.npz")
    teng.save(path)
    jeng = JEngine.restore(path)
    again = ReservoirEngine.restore(path, device="cpu")
    assert not jeng._reusable and not again._reusable
    _same_state(jeng, teng)
    for _ in range(2):
        tile = _tile(rng, R, B, "float32")
        for eng in (jeng, teng, again):
            eng.sample(tile)
    _same_state(jeng, teng)
    _same_state(jeng, again)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_both_packages_write_the_same_manifest(tmp_path):
    R, k, B = 4, 3, 8
    jeng, teng = _pair(R, k, B, seed=2)
    tile = np.arange(R * B, dtype=np.int32).reshape(R, B)
    jeng.sample(tile)
    teng.sample(tile)
    manifests = []
    for eng, name in ((jeng, "j.npz"), (teng, "t.npz")):
        eng.save(str(tmp_path / name), metadata={"m": 1})
        with np.load(str(tmp_path / name)) as data:
            manifests.append(json.loads(bytes(data["__manifest__"]).decode()))
            assert sorted(data.files) == ["__manifest__", "count", "key", "log_w", "nxt", "samples"]
    for m in manifests:
        del m["engine"]["backend"]
    assert manifests[0] == manifests[1]


def test_checkpoint_errors_are_typed(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip file")
    with pytest.raises(CheckpointCorrupt):
        ReservoirEngine.restore(str(bad), device="cpu")
    # a distinct engine saved with a hash_fn restores with one, and only so
    distinct = JEngine(JConfig(max_sample_size=3, num_reservoirs=2, tile_size=4, distinct=True),
                       key=0, hash_fn=lambda v: (v >> 16, v))
    path = str(tmp_path / "distinct.npz")
    distinct.save(path)
    with pytest.raises(ValueError, match="hash_fn present; restore must match"):
        ReservoirEngine.restore(path, device="cpu")
    restored = ReservoirEngine.restore(path, device="cpu", hash_fn=lambda v: (v >> 16, v))
    assert restored.config.distinct


# ----------------------------------------------------------- port rules


def test_no_cpu_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReservoirEngine(SamplerConfig(4, 2, 8), key=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReservoirEngine(SamplerConfig(4, 2, 8), key=0, device="cuda")


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import reservoir_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'reservoir_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'reservoir_tpu')\n"
        "       or n.startswith(('jax.', 'reservoir_tpu.'))]\n"
        "new = ('api', 'oracle.algorithm_l', 'oracle.bottom_k', 'oracle.weighted',\n"
        "       'stream.operator', 'stream.interop', 'serve.sessions', 'serve.service',\n"
        "       'serve.autotune', 'ops.autotune', 'serve.replica', 'serve.ha',\n"
        "       'serve.shard', 'serve.cluster', 'obs.export', 'obs.slo', 'ops.u64e',\n"
        "       'parallel.sharded', 'parallel.multihost', 'obs.audit', 'utils.selftest',\n"
        "       'utils.probe', 'tools.loadgen', 'tools.serve_knob_sweep')\n"
        "bad += [n for n in new if 'reservoir_tpu_torch.' + n not in sys.modules]\n"
        "print(len([n for n in sys.modules if n.startswith('reservoir_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 66


def _two_process_mesh():
    """A mesh over the ranks of two processes, this one process 0's: its
    engine holds process 0's rows only.  A checkpoint of such an engine,
    and a bridge over it, are what the port leaves out of L4."""
    from reservoir_tpu_torch.parallel import Mesh

    return Mesh(["cpu"] * 2, owners=[0, 1], process=0)


@pytest.mark.parametrize(
    "make",
    [
        lambda: ReservoirEngine(SamplerConfig(4, 2, mesh_axis="res"), mesh=_two_process_mesh()).save(
            os.devnull),
    ],
    ids=["mesh_axis"],
)
def test_what_the_slice_leaves_out_raises_naming_the_roadmap(make):
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*L4"):
        make()


@pytest.mark.parametrize("impl, ok", [("xla", False), ("auto", True), ("pallas", True)])
def test_impl_xla_is_rejected(impl, ok):
    cfg = SamplerConfig(4, 2, impl=impl)
    if ok:
        ReservoirEngine(cfg, device="cpu")
    else:
        with pytest.raises(ValueError, match="impl='xla'"):
            ReservoirEngine(cfg, device="cpu")


@pytest.mark.parametrize("dtypes", [("int64", None), ("int32", "float32"), ("float16", None)])
def test_engine_takes_only_four_byte_words(dtypes):
    element, sample = dtypes
    with pytest.raises(ValueError, match="4-byte words"):
        ReservoirEngine(SamplerConfig(4, 2, element_dtype=element, sample_dtype=sample), device="cpu")


def test_cpu_engine_launches_no_kernel():
    before = TK.launches
    _, eng = _pair(4, 3, 8)
    eng.sample(np.zeros((4, 8), np.int32))
    eng.result_arrays()
    assert TK.launches == before


# ------------------------------------------------------------ weighted mode


def _wpair(R, k, B, dtype="int32", seed=0, reusable=False):
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=dtype, weighted=True)
    return (
        JEngine(JConfig(**kw), key=seed, reusable=reusable),
        ReservoirEngine(SamplerConfig(**kw), key=seed, reusable=reusable, device="cpu"),
    )


def _wts(rng, R, B):
    w = rng.lognormal(0.0, 1.0, (R, B)).astype(np.float32)
    w[rng.random((R, B)) < 0.3] = 0.0
    return w


def _same_wstate(jeng, teng):
    js, ts = jeng.state, teng.state
    assert type(ts).__name__ == "WeightedState"
    for f in ("samples", "lkeys", "count", "xw"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)).view(np.int32),
            getattr(ts, f).numpy().view(np.int32), err_msg=f,
        )
    np.testing.assert_array_equal(
        np.asarray(jr.key_data(js.key)).astype(np.int64), ts.key.numpy()
    )
    assert jeng._min_count == teng._min_count


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_weighted_engine_equals_jax_engine(dtype):
    R, k, B = 16, 6, 32
    rng = np.random.default_rng(21)
    jeng, teng = _wpair(R, k, B, dtype, seed=3, reusable=True)
    feeds = [
        (_tile(rng, R, 3, dtype), _wts(rng, R, 3), None),  # partial fill
        (_tile(rng, R, B, dtype), _wts(rng, R, B), rng.integers(0, B + 1, R).astype(np.int32)),
        (_tile(rng, R, B, dtype), _wts(rng, R, B), None),
        (_tile(rng, R, B, dtype), _wts(rng, R, B), None),
        (_tile(rng, R, B, dtype), _wts(rng, R, B), rng.integers(0, B + 1, R).astype(np.int32)),
    ]
    for i, (tile, weights, valid) in enumerate(feeds):
        jeng.sample(tile, valid, weights=weights)
        # the port also takes CPU tensors and lists, for tiles and weights
        w_in = torch.from_numpy(weights) if i % 2 else weights.tolist()
        teng.sample(torch.from_numpy(tile) if i % 2 else tile, valid, weights=w_in)
        _same_wstate(jeng, teng)
    _same_arrays(jeng.peek_arrays(), teng.peek_arrays())
    for a, b in zip(jeng.result(), teng.result()):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


@pytest.mark.parametrize("width", [None, 24])
def test_weighted_sample_all_and_sample_stream_equal_jax(width):
    R, k, B = 12, 5, 32
    rng = np.random.default_rng(22)
    items = [(_tile(rng, R, B), _wts(rng, R, B)),
             (_tile(rng, R, B), _wts(rng, R, B), np.full(R, 9, np.int32))]
    stream = _tile(rng, R, 3 * B + 37)
    sw = _wts(rng, R, stream.shape[1])
    jeng, teng = _wpair(R, k, B, seed=4, reusable=True)
    jeng.sample_all(items)
    teng.sample_all(items)
    _same_wstate(jeng, teng)
    jeng.sample_stream(stream, tile_width=width, weights=sw)
    teng.sample_stream(stream, tile_width=width, weights=sw)
    _same_wstate(jeng, teng)
    # tensor streams and weights take the same path
    _, t2 = _wpair(R, k, B, seed=4)
    t2.sample_all(items)
    t2.sample_stream(torch.from_numpy(stream), tile_width=width, weights=torch.from_numpy(sw))
    _same_arrays(teng.peek_arrays(), t2.result_arrays())
    # and the engine keeps streaming after the masked tail
    more, mw = _tile(rng, R, B), _wts(rng, R, B)
    jeng.sample(more, weights=mw)
    teng.sample(more, weights=mw)
    _same_wstate(jeng, teng)
    with pytest.raises(ValueError, match=r"tiles\[1\]"):
        teng.sample_all([(more, mw), (more,)])


def test_weighted_jax_checkpoint_restores_into_the_port_and_continues(tmp_path):
    R, k, B = 12, 5, 16
    rng = np.random.default_rng(23)
    jeng, _ = _wpair(R, k, B, seed=8, reusable=True)
    jeng.sample(_tile(rng, R, 3), weights=_wts(rng, R, 3))
    jeng.sample(_tile(rng, R, B), rng.integers(0, B + 1, R).astype(np.int32), weights=_wts(rng, R, B))
    path = str(tmp_path / "jax.npz")
    jeng.save(path)
    teng = ReservoirEngine.restore(path, device="cpu")
    _same_wstate(jeng, teng)
    for _ in range(3):
        tile, w = _tile(rng, R, B), _wts(rng, R, B)
        jeng.sample(tile, weights=w)
        teng.sample(tile, weights=w)
    _same_wstate(jeng, teng)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_weighted_port_checkpoint_restores_into_jax_and_continues(tmp_path):
    R, k, B = 12, 5, 16
    rng = np.random.default_rng(24)
    _, teng = _wpair(R, k, B, dtype="float32", seed=10)
    for _ in range(2):
        teng.sample(_tile(rng, R, B, "float32"), weights=_wts(rng, R, B))
    path = str(tmp_path / "port.npz")
    teng.save(path, metadata={"who": "port"})
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
    assert manifest["state_class"] == "WeightedState"
    assert [f["name"] for f in manifest["fields"]] == ["samples", "lkeys", "count", "xw", "key"]
    jeng = JEngine.restore(path)
    again = ReservoirEngine.restore(path, device="cpu")
    _same_wstate(jeng, teng)
    for _ in range(2):
        tile, w = _tile(rng, R, B, "float32"), _wts(rng, R, B)
        for eng in (jeng, teng, again):
            eng.sample(tile, weights=w)
    _same_wstate(jeng, teng)
    _same_wstate(jeng, again)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_weighted_engine_validates_its_weights():
    R, k, B = 4, 3, 8
    tile = np.zeros((R, B), np.int32)
    ones = np.ones((R, B), np.float32)
    _, eng = _wpair(R, k, B, reusable=True)
    with pytest.raises(ValueError, match="requires a weights tile"):
        eng.sample(tile)
    bad = ones.copy()
    bad[1, 2] = -0.5
    with pytest.raises(ValueError, match="nonnegative"):
        eng.sample(tile, weights=bad)
    bad[1, 2] = np.nan
    with pytest.raises(ValueError, match="nonnegative"):
        eng.sample(tile, weights=bad)
    with pytest.raises(ValueError, match="match tile shape"):
        eng.sample(tile, weights=np.ones((R, B + 1), np.float32))
    with pytest.raises(ValueError, match="requires a weights array"):
        eng.sample_stream(np.zeros((R, 3 * B), np.int32))
    # the whole stream is checked before any tile is consumed
    sw = np.ones((R, 3 * B), np.float32)
    sw[0, -1] = -1.0
    with pytest.raises(ValueError, match="nonnegative"):
        eng.sample_stream(np.zeros((R, 3 * B), np.int32), weights=sw)
    assert (eng.state.count == 0).all()
    with pytest.raises(ValueError, match="match stream shape"):
        eng.sample_stream(np.zeros((R, 3 * B), np.int32), weights=np.ones((R, B)))
    # zero weights are legal: counted, never sampled
    eng.sample(tile, weights=np.zeros((R, B), np.float32))
    assert (eng.state.count == B).all() and (eng.peek_arrays()[1] == 0).all()
    _, plain = _pair(R, k, B)
    with pytest.raises(ValueError, match="only meaningful with weighted=True"):
        plain.sample(tile, weights=ones)
    with pytest.raises(ValueError, match="only meaningful with weighted=True"):
        plain.sample_stream(tile, weights=ones)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ReservoirEngine(SamplerConfig(4, 2, weighted=True, distinct=True), device="cpu")


def test_weighted_engine_snapshots_host_weights():
    # the caller may reuse its buffers as soon as sample() returns
    R, k, B = 6, 3, 16
    rng = np.random.default_rng(25)
    tile, w = _tile(rng, R, B), _wts(rng, R, B)
    nxt_tile, nxt_w = _tile(rng, R, B), _wts(rng, R, B)
    _, a = _wpair(R, k, B, seed=1)
    _, b = _wpair(R, k, B, seed=1)
    a.sample(tile, weights=w)
    b.sample(tile.copy(), weights=w.copy())
    tile[:] = 0
    w[:] = 0.0
    for eng in (a, b):
        eng.sample(nxt_tile, weights=nxt_w)
    for f in ("samples", "lkeys", "count", "xw"):
        assert torch.equal(getattr(a.state, f).view(torch.int32), getattr(b.state, f).view(torch.int32))


def test_weighted_checkpoint_with_a_mismatched_config_is_refused(tmp_path):
    _, teng = _wpair(4, 3, 8, seed=2)
    teng.sample(np.zeros((4, 8), np.int32), weights=np.ones((4, 8), np.float32))
    path = str(tmp_path / "w.npz")
    teng.save(path)
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files}
    manifest = json.loads(bytes(arrays.pop("__manifest__")).decode())
    manifest["engine"]["config"]["weighted"] = False
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8), **arrays)
    with pytest.raises(CheckpointMismatch):
        ReservoirEngine.restore(bad, device="cpu")


def test_cpu_weighted_engine_launches_no_kernel():
    before = TWK.launches
    _, eng = _wpair(4, 3, 8)
    eng.sample(np.zeros((4, 8), np.int32), weights=np.ones((4, 8), np.float32))
    eng.result_arrays()
    assert TWK.launches == before


# ------------------------------------------------------------ distinct mode

_DNP = {"int32": np.int32, "uint32": np.uint32, "int64": np.int64, "uint64": np.uint64}


def _dpair(R, k, B, dtype="int32", seed=0, reusable=False):
    kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, element_dtype=dtype, distinct=True)
    return (
        JEngine(JConfig(**kw), key=seed, reusable=reusable),
        ReservoirEngine(SamplerConfig(**kw), key=seed, reusable=reusable, device="cpu"),
    )


def _keys(rng, R, B, dtype="int32"):
    """Zipf-like keys (heavy duplication, both signs) of ``dtype``; 8-byte
    keys spread over both words."""
    u = rng.uniform(1e-6, 1.0, (R, B))
    t = np.minimum(u ** -4.0, 1e6).astype(np.int64) * rng.choice([-1, 1], (R, B))
    if _DNP[dtype]().itemsize == 8:
        return (t * np.int64(0x9E3779B97F4A7C15 - 2**64)).view(_DNP[dtype])
    return t.astype(np.int32).view(_DNP[dtype])


def _same_dstate(jeng, teng):
    js, ts = jeng.state, teng.state
    assert type(ts).__name__ == "DistinctState"
    host = convert.distinct_state_to_numpy(ts)
    for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts", "value_hi"):
        a = getattr(js, f)
        if a is None:
            assert host[f] is None, f
        else:
            assert np.asarray(a).dtype == host[f].dtype, f
            np.testing.assert_array_equal(np.asarray(a), host[f], err_msg=f)
    assert jeng._min_count == teng._min_count


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64", "uint64"])
def test_distinct_engine_equals_jax_engine(dtype):
    R, k, B = 12, 8, 32
    rng = np.random.default_rng(31)
    jeng, teng = _dpair(R, k, B, dtype, seed=3, reusable=True)
    feeds = [
        (_keys(rng, R, 3, dtype), None),  # underfilled rows
        (_keys(rng, R, B, dtype), rng.integers(0, B + 1, R).astype(np.int32)),  # ragged
        (_keys(rng, R, B, dtype), None),
        (_keys(rng, R, B, dtype), np.r_[0, B, rng.integers(0, B + 1, R - 2)].astype(np.int32)),
    ]
    for i, (tile, valid) in enumerate(feeds):
        jeng.sample(tile, valid)
        # the port also takes CPU tensors and lists (numpy reads a list of
        # uint64 keys as floats, so those stay arrays)
        if i % 2:
            t_in = torch.from_numpy(tile.view(np.int64) if dtype == "uint64" else tile)
        else:
            t_in = tile if dtype == "uint64" else tile.tolist()
        teng.sample(t_in, None if valid is None else torch.from_numpy(valid))
        _same_dstate(jeng, teng)
    _same_arrays(jeng.peek_arrays(), teng.peek_arrays())
    samples, sizes = teng.peek_arrays()
    assert samples.dtype == _DNP[dtype] and (sizes <= k).all()
    for a, b in zip(jeng.result(), teng.result()):
        np.testing.assert_array_equal(a, b)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_distinct_sample_all_and_sample_stream_equal_jax(dtype):
    R, k, B = 10, 6, 32
    rng = np.random.default_rng(32)
    items = [_keys(rng, R, B, dtype), (_keys(rng, R, B, dtype), np.full(R, 9, np.int32))]
    stream = _keys(rng, R, 3 * B + 17, dtype)
    jeng, teng = _dpair(R, k, B, dtype, seed=5, reusable=True)
    jeng.sample_all(items)
    teng.sample_all(items)
    _same_dstate(jeng, teng)
    jeng.sample_stream(stream)
    teng.sample_stream(stream)
    _same_dstate(jeng, teng)
    # a tensor stream takes the same path, and the engine keeps streaming
    _, t2 = _dpair(R, k, B, dtype, seed=5)
    t2.sample_all(items)
    t2.sample_stream(torch.from_numpy(stream), tile_width=24)
    _same_arrays(teng.peek_arrays(), t2.result_arrays())
    more = _keys(rng, R, B, dtype)
    jeng.sample(more)
    teng.sample(more)
    _same_dstate(jeng, teng)
    with pytest.raises(ValueError, match=r"tiles\[1\]"):
        teng.sample_all([more, more[:-1]])


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_distinct_jax_checkpoint_restores_into_the_port_and_continues(tmp_path, dtype):
    R, k, B = 9, 5, 16
    rng = np.random.default_rng(33)
    jeng, _ = _dpair(R, k, B, dtype, seed=8, reusable=True)
    jeng.sample(_keys(rng, R, 3, dtype))
    jeng.sample(_keys(rng, R, B, dtype), rng.integers(0, B + 1, R).astype(np.int32))
    path = str(tmp_path / "jax.npz")
    jeng.save(path)
    teng = ReservoirEngine.restore(path, device="cpu")
    _same_dstate(jeng, teng)
    for _ in range(2):
        tile = _keys(rng, R, B, dtype)
        jeng.sample(tile)
        teng.sample(tile)
    _same_dstate(jeng, teng)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
def test_distinct_port_checkpoint_restores_into_jax_and_continues(tmp_path, dtype):
    R, k, B = 9, 5, 16
    rng = np.random.default_rng(34)
    jeng0, teng = _dpair(R, k, B, dtype, seed=10)
    for _ in range(2):
        tile = _keys(rng, R, B, dtype)
        jeng0.sample(tile)
        teng.sample(tile)
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    teng.save(path, metadata={"who": "port"})
    jeng0.save(jpath, metadata={"who": "port"})
    manifests = []
    for p in (path, jpath):
        with np.load(p) as data:
            manifests.append(json.loads(bytes(data["__manifest__"]).decode()))
            wide = dtype == "uint64"
            assert sorted(data.files) == sorted(
                ["__manifest__", "values", "hash_hi", "hash_lo", "size", "count", "salts"]
                + (["value_hi"] if wide else []))
    for m in manifests:
        del m["engine"]["backend"]
    assert manifests[0] == manifests[1]
    assert manifests[0]["state_class"] == "DistinctState"
    assert manifests[0]["fields"][-1] == {"name": "value_hi", "kind": "array" if wide else "none"}
    jeng = JEngine.restore(path)
    again = ReservoirEngine.restore(path, device="cpu")
    _same_dstate(jeng, teng)
    for _ in range(2):
        tile = _keys(rng, R, B, dtype)
        for eng in (jeng, teng, again):
            eng.sample(tile)
    _same_dstate(jeng, teng)
    _same_dstate(jeng, again)
    _same_arrays(jeng.result_arrays(), teng.result_arrays())


def test_distinct_engine_validates_like_the_jax_engine():
    R, k, B = 4, 3, 8
    for dtype in ("float32", "int16", "float64"):
        with pytest.raises(ValueError, match="32- or 64-bit integer"):
            ReservoirEngine(SamplerConfig(k, R, B, element_dtype=dtype, distinct=True), device="cpu")
        with pytest.raises(ValueError, match="32- or 64-bit integer"):
            JEngine(JConfig(k, R, B, element_dtype=dtype, distinct=True), key=0)
    _, eng = _dpair(R, k, B, reusable=True)
    with pytest.raises(ValueError, match="only meaningful with weighted=True"):
        eng.sample(np.zeros((R, B), np.int32), weights=np.ones((R, B), np.float32))
    with pytest.raises(ValueError, match="tile must be"):
        eng.sample(np.zeros((R + 1, B), np.int32))
    with pytest.raises(ValueError, match="not a tuple"):
        eng.sample((np.zeros((R, B), np.int32),) * 2)
    with pytest.raises(ValueError, match="wide"):
        SamplerConfig(k, R, B, distinct=True, count_dtype="wide")
    _, wide = _dpair(R, k, B, "int64")
    with pytest.raises(ValueError, match="64-bit integer keys"):
        wide.sample(np.zeros((R, B), np.int32))
    # nothing was consumed by the refused calls
    assert (eng.state.count == 0).all() and (wide.state.count == 0).all()


def test_cpu_distinct_engine_launches_no_kernel():
    before = TDK.launches
    _, eng = _dpair(4, 3, 8, "int64")
    eng.sample(np.arange(32, dtype=np.int64).reshape(4, 8))
    samples, sizes = eng.result_arrays()
    assert TDK.launches == before
    assert (sizes == 3).all() and samples.dtype == np.int64
