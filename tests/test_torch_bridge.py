"""The port's stream bridge (``DeviceStreamBridge(device="cpu")``) and
``DeviceSampler`` against the JAX package's on the same pushes, bit for bit
(integer and float states compared as words: no tolerance), in uniform,
weighted and distinct (int32 and int64 keys) modes; the tri-state
protocol; the pipeline under contention; and what the slice leaves out."""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.stream.bridge import DeviceSampler as JSampler
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu_torch import DeviceSampler, DeviceStreamBridge, SamplerConfig
from reservoir_tpu_torch.errors import AbruptStreamTermination, SamplerClosedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

S, B, K = 6, 8, 4
MODES = {
    "uniform": ("int32", {}),
    "weighted": ("int32", {"weighted": True}),
    "distinct": ("int32", {"distinct": True}),
    "distinct64": ("int64", {"distinct": True}),
}


def _kw(mode, **extra):
    dtype, flags = MODES[mode]
    return dict(max_sample_size=K, num_reservoirs=S, tile_size=B, element_dtype=dtype, **flags, **extra)


def _bridges(mode, key=5, **kw):
    """The JAX bridge and the port's, same config and key."""
    return (
        JBridge(JConfig(**_kw(mode)), key=key, **kw),
        DeviceStreamBridge(SamplerConfig(**_kw(mode)), key=key, device="cpu", **kw),
    )


def _feed(mode, n, seed=1):
    """``n`` seeded (stream, element[, weight]) triples; distinct keys with
    many repeats, int64 keys past 32 bits."""
    dtype = MODES[mode][0]
    rng = np.random.default_rng(seed)
    streams = rng.integers(0, S, n).astype(np.int32)
    elems = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int64)
    if mode.startswith("distinct"):
        elems = elems % 23
    if dtype == "int64":
        elems = elems * np.int64(0x9E3779B97F4A7C15 - 2**64)
    weights = rng.uniform(0.0, 2.0, n).astype(np.float32) if mode == "weighted" else None
    if weights is not None:
        weights[::7] = 0.0  # a zero weight is counted and never sampled
    return streams, elems.astype(dtype), weights


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _push(bridge, feed, how, mode):
    streams, elems, weights = feed
    if how == "push_interleaved":
        bridge.push_interleaved(streams, elems, weights=weights)
    elif how == "push":
        for s in range(S):
            sel = streams == s
            # in chunks that cross the row width, and one element at a time
            chunk = elems[sel]
            w = weights[sel] if weights is not None else None
            bridge.push(s, chunk[:-1], weights=None if w is None else w[:-1])
            bridge.push(s, chunk[-1], weights=None if w is None else w[-1])
    else:
        rng = np.random.default_rng(9)
        for t in range(3):
            tile = elems[t * S * B : (t + 1) * S * B].reshape(S, B)
            valid = rng.integers(0, B + 1, S).astype(np.int32) if t == 1 else None
            w = weights[t * S * B : (t + 1) * S * B].reshape(S, B) if weights is not None else None
            bridge.push_tile(tile, valid=valid, weights=w)


@pytest.mark.parametrize("how", ["push", "push_interleaved", "push_tile"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bridge_equals_jax_bridge(mode, how):
    feed = _feed(mode, S * B * 5)
    jb, tb = _bridges(mode)
    for b in (jb, tb):
        _push(b, feed, how, mode)
    _same(jb.complete(), tb.complete())
    jm, tm = jb.metrics.snapshot(), tb.metrics.snapshot()
    for key in ("elements", "flushes", "flushed_elements", "completions"):
        assert jm[key] == tm[key], key
    assert tm["flushes"] >= 3


@pytest.mark.parametrize("mode", ["uniform", "distinct"])
def test_rows_below_k_are_exact_and_equal_jax(mode):
    lengths = [0, 3, 4, 1, 2, 0]
    jb, tb = _bridges(mode)
    for b in (jb, tb):
        for s, n in enumerate(lengths):
            for i in range(n):
                b.push(s, 100 * s + i)
    got = tb.complete()
    _same(jb.complete(), got)
    for s, n in enumerate(lengths):
        assert sorted(int(x) for x in got[s]) == [100 * s + i for i in range(n)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mode", ["uniform", "weighted"])
def test_pipelined_equals_serial_and_jax(mode, native):
    streams, elems, weights = _feed(mode, S * B * 9, seed=3)
    want = JBridge(JConfig(**_kw(mode)), key=8, pipelined=False)
    want.push_interleaved(streams, elems, weights=weights)
    expected = want.complete()
    for pipelined in (True, False):
        b = DeviceStreamBridge(SamplerConfig(**_kw(mode)), key=8, device="cpu",
                               pipelined=pipelined, native=native)
        assert b.metrics.demux_threads >= 1
        # small batches: many flush handoffs
        for off in range(0, streams.size, 17):
            sl = slice(off, off + 17)
            b.push_interleaved(streams[sl], elems[sl], weights=None if weights is None else weights[sl])
        _same(expected, b.complete())


def test_reusable_snapshots_equal_jax():
    streams, elems, _ = _feed("uniform", S * B * 4, seed=4)
    jb, tb = _bridges("uniform", reusable=True)
    half = streams.size // 2
    firsts, seconds = [], []
    for b in (jb, tb):
        b.push_interleaved(streams[:half], elems[:half])
        firsts.append(b.complete())
        b.push_interleaved(streams[half:], elems[half:])
        seconds.append(b.complete())
    _same(*firsts)
    _same(*seconds)
    # an earlier snapshot is not clobbered by later pushes
    small = DeviceStreamBridge(SamplerConfig(max_sample_size=8, num_reservoirs=2, tile_size=8),
                               key=12, reusable=True, device="cpu")
    small.push(0, np.arange(3, dtype=np.int32))
    first = small.complete()
    small.push(0, np.arange(3, 6, dtype=np.int32))
    second = small.complete()
    assert sorted(int(x) for x in first[0]) == [0, 1, 2]
    assert sorted(int(x) for x in second[0]) == [0, 1, 2, 3, 4, 5]
    assert small.sample.done() is False and small.is_open


def test_tri_state_protocol():
    cfg = SamplerConfig(max_sample_size=8, num_reservoirs=2, tile_size=8)
    # complete: the future holds the samples
    done = DeviceStreamBridge(cfg, key=5, device="cpu")
    done.push(0, np.arange(50, dtype=np.int32))
    res = done.complete()
    assert done.sample.result(timeout=1) is res and not done.is_open
    with pytest.raises(SamplerClosedError):
        done.push(0, 1)
    # fail: the future holds the cause, pushes are refused
    failed = DeviceStreamBridge(cfg, key=5, device="cpu")
    failed.push(0, 1)
    boom = RuntimeError("feed died")
    failed.fail(boom)
    assert failed.sample.exception(timeout=1) is boom
    assert failed.metrics.failures == 1
    with pytest.raises(SamplerClosedError):
        failed.push(0, 2)
    # graceful cancel delivers the partial sample; cancel with a cause fails
    graceful = DeviceStreamBridge(cfg, key=9, device="cpu")
    graceful.push(0, np.arange(3, dtype=np.int32))
    graceful.cancel()
    part = graceful.sample.result(timeout=1)
    assert sorted(int(x) for x in part[0]) == [0, 1, 2] and len(part[1]) == 0
    caused = DeviceStreamBridge(cfg, key=9, device="cpu")
    caused.cancel(ValueError("downstream"))
    assert isinstance(caused.sample.exception(timeout=1), ValueError)


@pytest.mark.parametrize("pipelined", [True, False])
def test_abrupt_termination_backstop(pipelined):
    cfg = SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=8)
    bridge = DeviceStreamBridge(cfg, key=10, device="cpu", pipelined=pipelined)
    bridge.push(0, np.arange(20, dtype=np.int32))
    fut = bridge.sample
    del bridge
    gc.collect()
    assert isinstance(fut.exception(timeout=2), AbruptStreamTermination)


_EXIT_CHILD = """
import numpy as np
from reservoir_tpu_torch.config import SamplerConfig
from reservoir_tpu_torch.stream.bridge import DeviceStreamBridge

bridge = DeviceStreamBridge(SamplerConfig(8, 4096, tile_size=64), key=0, gated=True, device="cpu")
rng = np.random.default_rng(0)
for _ in range(200):
    bridge.push(int(rng.integers(0, 4096)), rng.integers(0, 1 << 30, 64).astype(np.int32))
bridge.flush()
print("last line", flush=True)
"""


def test_exit_with_a_gated_flush_in_flight_does_not_abort():
    """Fault C.5: a process that ends while a gated, pipelined bridge still
    has its flush in flight (no ``complete()``) exits with 0 after its last
    line, six runs out of six.  Before the fix the flush worker, a daemon
    thread, was torn down inside the flush's C++ frames and the process
    aborted ("terminate called without an active exception") in about five
    runs out of six."""
    procs = [
        subprocess.Popen([sys.executable, "-c", _EXIT_CHILD], cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (proc.returncode, err[-2000:])
        assert out.strip().splitlines()[-1] == "last line"


def test_worker_error_surfaces_and_reaches_the_future():
    cfg = SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=4)
    bridge = DeviceStreamBridge(cfg, key=14, device="cpu")

    def _boom(*a):
        raise RuntimeError("final flush boom")

    bridge._pipeline._fn = lambda: _boom  # as the WeakMethod resolves
    bridge.push(0, np.arange(4, dtype=np.int32))  # fills a row: a flush
    assert isinstance(bridge.sample.exception(timeout=2), RuntimeError)
    with pytest.raises(RuntimeError, match="final flush boom"):
        bridge.drain_barrier()
    # dropped after a failed final flush, the future keeps the cause
    again = DeviceStreamBridge(cfg, key=17, device="cpu")
    again._pipeline._fn = lambda: _boom
    again.push(0, np.arange(4, dtype=np.int32))
    fut = again.sample
    del again
    gc.collect()
    assert "final flush boom" in str(fut.exception(timeout=2))


def test_device_sampler_equals_jax():
    kw = dict(max_sample_size=8, num_reservoirs=1, tile_size=16)
    data = np.arange(200, dtype=np.int32) * 7
    j = JSampler(JConfig(**kw), key=3)
    j.sample_all(data)
    want = j.result()
    bulk = DeviceSampler(SamplerConfig(**kw), key=3, device="cpu")
    bulk.sample_all(data)
    one = DeviceSampler(SamplerConfig(**kw), key=3, device="cpu")
    for x in data:
        one.sample(x)
    gen = DeviceSampler(SamplerConfig(**kw), key=3, device="cpu")
    gen.sample_all(iter(data.tolist()))
    for s in (bulk, one, gen):
        np.testing.assert_array_equal(s.result(), want)
    # single use: closed after result(); reusable stays open
    assert not bulk.is_open
    with pytest.raises(SamplerClosedError):
        bulk.sample(2)
    again = DeviceSampler(SamplerConfig(**kw), key=3, reusable=True, device="cpu")
    again.sample_all(data[:5])
    np.testing.assert_array_equal(np.sort(again.result()), np.sort(data[:5]))
    assert again.is_open
    with pytest.raises(ValueError, match="single-stream"):
        DeviceSampler(SamplerConfig(max_sample_size=8, num_reservoirs=2), device="cpu")
    with pytest.raises(ValueError, match=r"elements\[1\]"):
        gen2 = DeviceSampler(SamplerConfig(**kw), key=3, device="cpu")
        gen2.sample_all(iter([1, "x"]))


def test_metrics_keys_equal_jax():
    jb, tb = _bridges("uniform")
    for b in (jb, tb):
        b.push(0, np.arange(20, dtype=np.int32))
        b.complete()
    jm, tm = jb.metrics.snapshot(), tb.metrics.snapshot()
    assert set(jm) == set(tm) and set(jm["stages"]) == set(tm["stages"])
    assert tm["elements"] == tm["flushed_elements"] == 20
    assert tm["demotions"] == 0 and tm["stages"]["demux_s"] > 0
    assert tb.metrics.copy_s == 0.0  # no card, no copy


def test_pipelined_thread_stress():
    # many small pushes: many reserve/submit/attach cycles between the
    # producer and the worker, with a short switch interval
    cfg = SamplerConfig(max_sample_size=4, num_reservoirs=8, tile_size=16)
    n = 8 * 16 * 40
    rng = np.random.default_rng(7)
    streams = rng.integers(0, 8, n).astype(np.int32)
    elems = rng.integers(0, 1 << 30, n).astype(np.int32)
    serial = DeviceStreamBridge(cfg, key=15, device="cpu", pipelined=False)
    serial.push_interleaved(streams, elems)
    want = serial.complete()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = [None] * 4

        def run(j):
            b = DeviceStreamBridge(cfg, key=15, device="cpu")
            for off in range(0, n, 37):
                b.push_interleaved(streams[off : off + 37], elems[off : off + 37])
            results[j] = (b.complete(), b.metrics.snapshot())

        threads = [threading.Thread(target=run, args=(j,)) for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for res, m in results:
        assert m["elements"] == m["flushed_elements"] == n
        _same(want, res)


def _two_process_mesh():
    """A mesh over the ranks of two processes, this one process 0's: its
    engine holds process 0's rows only.  A checkpoint of such an engine,
    and a bridge over it, are what the port leaves out of L4."""
    from reservoir_tpu_torch.parallel import Mesh

    return Mesh(["cpu"] * 2, owners=[0, 1], process=0)


@pytest.mark.parametrize(
    "make, label",
    [
        (lambda cfg: DeviceStreamBridge(dataclasses.replace(cfg, mesh_axis="res"), mesh=_two_process_mesh()),
         "L4"),
    ],
    ids=["mesh"],
)
def test_what_the_slice_leaves_out_raises(make, label):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{label}"):
        make(SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=8))


def test_no_card_no_bridge():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStreamBridge(SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSampler(SamplerConfig(max_sample_size=4, num_reservoirs=1, tile_size=8))


def test_input_errors_name_the_stream():
    cfg = SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=8, weighted=True)
    b = DeviceStreamBridge(cfg, key=11, device="cpu")
    with pytest.raises(ValueError, match="stream 1: weighted bridge requires weights"):
        b.push(1, 1)
    with pytest.raises(ValueError, match=r"stream 1: weights must be nonnegative \(weights\[1\]"):
        b.push(1, [1, 2], weights=[1.0, -1.0])
    with pytest.raises(ValueError, match="stream 5 out of range"):
        b.push(5, 1, weights=1.0)
    with pytest.raises(ValueError, match="stream id 7 out of range"):
        b.push_interleaved([0, 7], [1, 2], weights=[1.0, 1.0])
    plain = DeviceStreamBridge(SamplerConfig(max_sample_size=4, num_reservoirs=2, tile_size=8),
                               device="cpu")
    with pytest.raises(ValueError, match="only meaningful with weighted=True"):
        plain.push(0, 1, weights=1.0)
    with pytest.raises(ValueError, match="stream 0: elements not convertible"):
        plain.push(0, "x")
