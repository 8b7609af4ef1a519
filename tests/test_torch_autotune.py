"""The kernels' launch geometry and its autotune cache, against the JAX
package's: one cache file, written by either package, loads in the other
(kernel geometry and gate entries, schema 3); ``ops/blocking.py`` keeps the
reference's rules (``shrink_block_to``, ``resolve_chunk``) and takes only
the rows a block each kernel is built for; the engine resolves a tile
shape's rows a block once, the bridge resolves ``gate_tile=0`` as the JAX
bridge does from the same file, and the sweep records a variant only where
it beats the default past the spread of its readings."""

from __future__ import annotations

import json
import subprocess

import numpy as np
import pytest
import torch

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu.ops import autotune as jtune
from reservoir_tpu.ops import blocking as jblocking
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.ops import algorithm_l_cuda, autotune, blocking, distinct_cuda, weighted_cuda
from reservoir_tpu_torch.tools import block_sweep


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", path)
    return path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_file_round_trips_between_the_packages(cache, writer):
    w, r = (autotune, jtune) if writer == "port" else (jtune, autotune)
    kinds = [("algl", w.Geometry(64, 0, 512)), ("weighted", w.Geometry(2, 128, 0)),
             ("distinct", w.Geometry(1, 0, 0)), ("gate", w.Geometry(0, 0, 0, gate_tile=128,
                                                                      gate_push_chunk=1 << 18))]
    for i, (kernel, geometry) in enumerate(kinds):
        assert w.record_if_better("NVIDIA H100 80GB HBM3", 65536, 128, 2048, np.int32, geometry,
                                  elem_per_sec=1e9 + i, source="test", kernel=kernel)
    # a slower rate does not displace a winner; a faster one does
    assert not w.record_if_better("NVIDIA H100 80GB HBM3", 65536, 128, 2048, np.int32,
                                  w.Geometry(256, 0, 0), elem_per_sec=1.0, kernel="algl")
    for kernel, geometry in kinds:
        got = r.lookup("NVIDIA H100 80GB HBM3", 65536, 128, 2048, "int32", kernel=kernel)
        assert tuple(got) == tuple(geometry)
        # the device kind is part of the key: a TPU's entries never meet an H100's
        assert r.lookup("TPU v5 lite", 65536, 128, 2048, "int32", kernel=kernel) is None
    with open(cache) as fh:
        data = json.load(fh)
    assert data["_schema"] == 3
    assert set(data) == {"_schema"} | {jtune.make_key("NVIDIA H100 80GB HBM3", 65536, 128, 2048, np.int32,
                                                      kernel=kernel) for kernel, _ in kinds}
    assert r.record_if_better("NVIDIA H100 80GB HBM3", 65536, 128, 2048, np.int32,
                              r.Geometry(256, 0, 0), elem_per_sec=2e9, kernel="algl")
    assert w.lookup("NVIDIA H100 80GB HBM3", 65536, 128, 2048, np.int32, kernel="algl").block_r == 256


def test_keys_agree_for_numpy_and_torch_dtypes():
    for np_dtype, t_dtype in ((np.int32, torch.int32), (np.uint32, torch.uint32), (np.int64, torch.int64),
                              (np.float32, torch.float32)):
        want = jtune.make_key("cpu", 8, 4, 16, np_dtype, kernel="distinct")
        assert autotune.make_key("cpu", 8, 4, 16, np_dtype, kernel="distinct") == want
        assert autotune.make_key("cpu", 8, 4, 16, t_dtype, kernel="distinct") == want
    assert autotune.device_kind("cpu") == "cpu"


def test_blocking_keeps_the_reference_rules():
    for R in (1, 2, 3, 63, 64, 100, 128, 129, 4096):
        for block in (1, 8, 32, 64, 128, 256):
            assert blocking.shrink_block_to(R, block) == jblocking.shrink_block_to(R, block)
    for tile_b in (1, 64, 100, 1024, 2048):
        for chunk in (None, 0, -1, 1, 3, 64, 128, 256, 1000, 1024, 4096):
            for mult in (1, 128):
                assert blocking.resolve_chunk(tile_b, chunk, mult) == jblocking.resolve_chunk(tile_b, chunk, mult)


@pytest.mark.parametrize("kernel", sorted(blocking.BLOCK_CHOICES))
def test_resolve_block_r_takes_only_the_built_choices(kernel):
    choices, default = blocking.BLOCK_CHOICES[kernel], blocking.DEFAULT_BLOCK[kernel]
    assert default in choices
    for b in choices:
        assert blocking.resolve_block_r(kernel, b) == (None if b == default else b)
        # R at least the block: nothing shrinks
        assert blocking.resolve_block_r(kernel, b, num_reservoirs=4096) == (None if b == default else b)
    for b in (None, 0, -1, 3, 100, 512, max(choices) * 2):
        assert blocking.resolve_block_r(kernel, b) is None  # not built: the default, never a crash


def test_resolve_block_r_falls_back_to_the_default():
    assert blocking.resolve_block_r("algl", None) is None
    assert blocking.resolve_block_r("algl", 0) is None
    assert blocking.resolve_block_r("algl", 128) is None  # the default launch
    assert blocking.resolve_block_r("algl", 64) == 64
    assert blocking.resolve_block_r("algl", 100) is None  # not built: speed, never a crash
    assert blocking.resolve_block_r("algl", 256, num_reservoirs=40) == 32  # R's power of two
    assert blocking.resolve_block_r("algl", 256, num_reservoirs=10) == 32  # the smallest built
    assert blocking.resolve_block_r("algl", 256, num_reservoirs=100) == 64
    assert blocking.resolve_block_r("weighted", 8) == 8
    assert blocking.resolve_block_r("weighted", 8, num_reservoirs=3) == 2
    assert blocking.resolve_block_r("distinct", 2) == 2
    assert blocking.resolve_block_r("distinct", 8) is None  # at most 4 warps


@pytest.mark.parametrize("times, default, wins", [
    ([1.0, 1.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0], True),  # no spread, faster in every turn
    ([1.0, 1.1, 1.0, 1.1], [2.0, 2.1, 2.0, 2.0], True),  # ahead by more than either spread
    ([1.0, 1.1, 1.0, 1.1], [1.1, 1.2, 1.1, 1.2], False),  # ahead by the spread, not past it
    ([1.0, 1.0, 1.0, 2.5], [2.0, 2.0, 2.0, 2.0], False),  # behind in one turn
    ([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0], False),  # equal
    ([1.0, 1.02, 1.0, 1.0], [1.5, 1.01, 1.5, 1.5], False),  # within noise in one turn
    ([1.0, 1.0], [2.0, 2.0, 2.0, 2.0], False),  # turns that do not pair
    ([], [], False),
])
def test_beats_default_needs_every_turn_past_the_spread(times, default, wins):
    assert block_sweep.beats_default(times, default) is wins


@pytest.mark.parametrize("wrapper", ["algl", "gated", "weighted", "distinct"])
def test_wrappers_reject_a_geometry_they_were_not_built_for(wrapper):
    from reservoir_tpu_torch.ops import algorithm_l, distinct, weighted
    from reservoir_tpu_torch.ops.rng import key_from_seed

    R, k, B = 4, 3, 8
    tile = torch.arange(R * B, dtype=torch.int32).reshape(R, B)
    if wrapper == "algl":
        st = algorithm_l.init(key_from_seed(0), R, k)
        call = lambda b: algorithm_l_cuda.update_cuda(st, tile, block_r=b)  # noqa: E731
    elif wrapper == "gated":
        st = algorithm_l.init(key_from_seed(0), R, k)
        nv = torch.full((R,), 2, dtype=torch.int32)
        call = lambda b: algorithm_l_cuda.update_gated_cuda(st, tile[:, :2].contiguous(), nv, nv,  # noqa: E731
                                                            block_r=b)
    elif wrapper == "weighted":
        st = weighted.init(key_from_seed(0), R, k)
        call = lambda b: weighted_cuda.update_cuda(st, tile, torch.ones(R, B), block_r=b)  # noqa: E731
    else:
        st = distinct.init(key_from_seed(0), R, k)
        call = lambda b: distinct_cuda.update_cuda(st, tile, block_r=b)  # noqa: E731
    with pytest.raises(ValueError, match="block_r"):
        call(100)
    good = blocking.BLOCK_CHOICES["algl_gated" if wrapper == "gated" else wrapper][0]
    want = call(None)
    got = call(good)  # on the CPU the plain version: the same state
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a, b)


def test_engine_resolves_each_tile_shape_once(cache):
    cfg = SamplerConfig(max_sample_size=4, num_reservoirs=64, tile_size=8)
    autotune.record("cpu", 64, 4, 8, np.int32, autotune.Geometry(64, 0, 0), kernel="algl")
    autotune.record("cpu", 64, 4, 4, np.int32, autotune.Geometry(100, 0, 0), kernel="algl")
    eng = ReservoirEngine(cfg, key=0, reusable=True, device="cpu")
    plain = ReservoirEngine(cfg, key=0, reusable=True, device="cpu")
    tiles = [np.arange(64 * 8, dtype=np.int32).reshape(64, 8) + 512 * t for t in range(3)]
    for t in tiles:
        eng.sample(t)
        plain.sample(t)
    eng.sample(tiles[0][:, :4])
    eng.sample(tiles[1][:, :6])
    assert eng._geometry_by_key[("algl", 8, "int32")] == autotune.Geometry(64, 0, 0)
    assert eng._rows_by_key == {("algl", 8, "int32"): 64, ("algl", 4, "int32"): None,
                                ("algl", 6, "int32"): None}
    assert eng._geometry_by_key[("algl", 6, "int32")] is None
    # a later entry for a shape already resolved is not read again
    autotune.record("cpu", 64, 4, 8, np.int32, autotune.Geometry(32, 0, 0), kernel="algl")
    eng.sample(tiles[2])
    assert eng._rows_by_key[("algl", 8, "int32")] == 64
    plain.sample(tiles[0][:, :4])
    plain.sample(tiles[1][:, :6])
    plain.sample(tiles[2])
    for a, b in zip(eng.peek_arrays(), plain.peek_arrays()):
        np.testing.assert_array_equal(a, b)


def test_bridge_picks_the_gate_tile_the_jax_bridge_picks(cache):
    kw = dict(max_sample_size=4, num_reservoirs=2, tile_size=8)
    jtune.record("cpu", 2, 4, 8, np.int32, jtune.Geometry(0, 0, 0, gate_tile=16, gate_push_chunk=4096),
                 kernel="gate")
    port = DeviceStreamBridge(SamplerConfig(**kw), key=0, gated=True, gate_tile=0, gate_push_chunk=0,
                              device="cpu")
    ref = JBridge(JConfig(**kw), key=0, gated=True, gate_tile=0, gate_push_chunk=0)
    assert (port._gate_tile, port._gate_push_chunk) == (ref._gate_tile, ref._gate_push_chunk) == (16, 4096)
    # no entry for a shape: the untuned defaults, in both
    kw["tile_size"] = 16
    port = DeviceStreamBridge(SamplerConfig(**kw), key=0, gated=True, gate_tile=0, device="cpu")
    ref = JBridge(JConfig(**kw), key=0, gated=True, gate_tile=0)
    assert (port._gate_tile, port._gate_push_chunk) == (ref._gate_tile, ref._gate_push_chunk) == (64, 1 << 20)


def _sweep_with(monkeypatch, rows, jobs, cache):
    """block_sweep.sweep with its child's output replaced by ``rows``."""
    seen = {}

    def fake_run(cmd, **kw):
        seen["jobs"], seen["timeout"] = json.loads(cmd[-1]), kw["timeout"]
        return subprocess.CompletedProcess(cmd, 0, "noise\n" + "\n".join(json.dumps(r) for r in rows), "")

    monkeypatch.setattr(block_sweep.subprocess, "run", fake_run)
    out = str(cache) + ".jsonl"
    got = block_sweep.sweep(jobs, cache, timeout=5.0, out=out)
    with open(out) as fh:
        assert len(fh.readlines()) == len(rows)
    return got, seen


def _algl_rows(ms: dict, same=lambda b: True):
    return [{"kernel": "algl", "R": 2048, "k": 32, "B": 256, "device_kind": "NVIDIA H100 80GB HBM3", "card": "x",
             "block_r": b, "default": b == 128, "same_bits": same(b), "ms": t,
             "elem_per_sec": 2048 * 256 / (1e-3 * min(t))} for b, t in ms.items()]


def test_sweep_records_only_a_variant_past_the_default_and_its_spread(cache, monkeypatch):
    rows = _algl_rows({32: [0.001] * 4, 64: [0.010, 0.011, 0.010, 0.011], 128: [0.013, 0.013, 0.014, 0.013],
                       256: [0.0125, 0.0126, 0.0125, 0.0125]}, same=lambda b: b != 32)
    got, seen = _sweep_with(monkeypatch, rows, [{"kernel": "algl", "shape": [2048, 32, 256],
                                                 "variants": [[32, 0], [64, 0]]}], cache)
    # the default is added to the variants the child runs
    assert seen == {"jobs": [{"kernel": "algl", "shape": [2048, 32, 256], "variants": [[128, 0], [32, 0], [64, 0]]}],
                    "timeout": 5.0}
    # 32 is fastest but changed the bits; 256 is ahead by less than the spread
    assert [(r["block_r"], r["beats_default"], r["cached"]) for r in got] == [
        (32, False, False), (64, True, True), (128, False, False), (256, False, False)]
    # the JAX package reads the winner
    assert jtune.lookup("NVIDIA H100 80GB HBM3", 2048, 32, 256, np.int32).block_r == 64
    assert block_sweep.default_variants("algl") == [(32, 0), (64, 0), (128, 0), (256, 0)]
    assert block_sweep.default_variants("weighted") == [(1, 0), (2, 0), (4, 0), (8, 0)]
    assert block_sweep.default_variants("distinct") == [(1, 0), (2, 0), (4, 0)]
    assert block_sweep.default_variants("gate")[0] == (64, 1 << 20)


def test_sweep_records_nothing_where_the_default_holds(cache, monkeypatch):
    # the readings of a call where 32 threads led by under the spread
    rows = _algl_rows({32: [0.0814, 0.0817, 0.0815, 0.0816], 64: [0.0826, 0.0826, 0.0827, 0.0826],
                       128: [0.0822, 0.0816, 0.0820, 0.0822], 256: [0.0827, 0.0817, 0.0821, 0.0819]})
    gate = [{"kernel": "gate", "R": 64, "k": 16, "B": 4096, "device_kind": "NVIDIA H100 80GB HBM3", "card": "x",
             "gate_tile": t, "gate_push_chunk": c, "default": (t, c) == (64, 1 << 20), "same_bits": True, "s": s,
             "elem_per_sec": 64 * 4096 * 40 / min(s)}
            for (t, c), s in (((64, 1 << 20), [0.007, 0.004, 0.005, 0.006]),
                              ((128, 1 << 20), [0.004, 0.005, 0.004, 0.003]))]
    got, _ = _sweep_with(monkeypatch, rows + gate, [{"kernel": "algl", "shape": [2048, 32, 256],
                                                    "variants": [[32, 0], [128, 0]]},
                                                   {"kernel": "gate", "shape": [64, 16, 4096],
                                                    "variants": [[64, 1 << 20], [128, 1 << 20]]}], cache)
    assert not any(r["beats_default"] or r["cached"] for r in got)
    assert autotune.load(cache) == {}
    assert autotune.lookup("NVIDIA H100 80GB HBM3", 2048, 32, 256, np.int32) is None


def test_sweep_cli_requires_a_cache(capsys):
    with pytest.raises(SystemExit) as e:
        block_sweep.main(["--kernel", "algl"])
    assert e.value.code == 2 and "--cache" in capsys.readouterr().err
