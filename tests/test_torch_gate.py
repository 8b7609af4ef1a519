"""The port's skip gate against the JAX package's, bit for bit (tolerance
0: integer states compared as integers, floats as their bit patterns): the
plain gated update against the reference's jitted ``update_gated``; the
native (C++) and torch replicas against the reference's jitted
``_build_eval``; the port's gated bridge against its ungated bridge over
chunk splits, interleaved feeds, the fill's fallback and ``push_tile``;
and the port's gated bridge against the JAX package's gated bridge,
reservoirs and gate counters alike.  Small shapes: S <= 64, k <= 16,
B <= 1024, but for one native replica case over 4,133 rows, enough to
split them over threads."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.random as jr

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.stream import gate as JG
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig
from reservoir_tpu_torch import native as tnative
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.stream import SkipGate, gate_ineligible_reason

REPLICAS = pytest.mark.parametrize("native", [True, False], ids=["native", "torch"])


def _cfg(mode="plain", **kw):
    kw.setdefault("max_sample_size", 8)
    kw.setdefault("num_reservoirs", 4)
    kw.setdefault("tile_size", 32)
    return SamplerConfig(distinct=mode == "distinct", weighted=mode == "weighted", **kw)


def _jcfg(cfg):
    return JConfig(max_sample_size=cfg.max_sample_size, num_reservoirs=cfg.num_reservoirs,
                   tile_size=cfg.tile_size, weighted=cfg.weighted, distinct=cfg.distinct)


def _words(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_state(j, t):
    for f in ("samples", "count", "nxt", "log_w"):
        np.testing.assert_array_equal(_words(getattr(j, f)), _words(getattr(t, f).numpy()), err_msg=f)


def _equal(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def _feed(bridge, data, wdata=None, chunk=None):
    """Push every row's stream in ``chunk``-sized pieces (whole row when
    None), round-robin over the rows, then complete."""
    S, N = data.shape
    step = N if chunk is None else chunk
    for off in range(0, N, step):
        for s in range(S):
            w = None if wdata is None else wdata[s, off:off + step]
            bridge.push(s, data[s, off:off + step], weights=w)
    return bridge.complete()


class _Engine:
    """What resync reads of an engine: its state and reset epochs."""

    def __init__(self, state):
        self._state = state
        self.reset_epochs = 0


# ---------------------------------------------------------- gated update


@pytest.mark.parametrize("k", [5, 6, 16])
def test_update_gated_equals_jax_across_the_fill(k):
    """Random candidate tiles, counts and advances from empty on: the fill
    prefix's scatter, its end, and the accept chain with the fused
    ``log_w`` update (k = 5 and 6 round the reciprocal differently)."""
    R, bg = 24, 12
    js = JA.init(jr.key(3), R, k)
    ts = TA.init(key_from_seed(3), R, k)
    rng = np.random.default_rng(k)
    upd = jax.jit(JA.update_gated)
    for step in range(8):
        tile = rng.integers(-(2**31), 2**31 - 1, (R, bg)).astype(np.int32)
        nvalid = rng.integers(0, bg + 1, R).astype(np.int32)
        advance = rng.integers(0, 3 * k, R).astype(np.int32)
        js = upd(js, jnp.asarray(tile), jnp.asarray(nvalid), jnp.asarray(advance))
        ts = TA.update_gated(ts, torch.from_numpy(tile), torch.from_numpy(nvalid),
                             torch.from_numpy(advance))
        _same_state(js, ts)
    assert int(ts.count.min()) >= k  # the fill's end was crossed


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_update_gated_of_the_gates_candidates_equals_the_full_tile(dtype):
    """What the gate ships is enough: the candidates of a tile, applied
    gated, give the state of the whole tile's update (float payloads with
    -0.0 and NaN bits travel as words); the wrapper on CPU tensors runs
    the plain version and counts no launch."""
    R, k, B = 16, 6, 64
    state = TA.init(key_from_seed(1), R, k, sample_dtype=getattr(torch, dtype))
    gate = SkipGate(R, k, B, np.dtype(dtype), cap=B)
    rng = np.random.default_rng(2)
    before = TK.gated_launches
    for _ in range(5):
        gate.resync(_Engine(state))
        bits = rng.integers(-(2**31), 2**31 - 1, (R, B)).astype(np.int32)
        bits[::3, 0] = -(2**31)  # -0.0
        bits[1::3, 1] = 0x7FC00001  # NaN with a payload
        tile = bits.view(dtype)
        valid = rng.integers(0, B + 1, R).astype(np.int32)
        ev = gate.evaluate(valid)
        assert not ev.fallback
        gate.commit(ev)
        gate.append(tile, valid, ev)
        gtile, nvalid, advance, _ = gate.take()
        gated = TK.update_gated_cuda(TA.ReservoirState(*state), torch.from_numpy(gtile),
                                     torch.from_numpy(nvalid), torch.from_numpy(advance))
        state = TA.update(state, torch.from_numpy(tile), torch.from_numpy(valid))
        for f in ("samples", "count", "nxt", "log_w"):
            assert torch.equal(getattr(gated, f).view(torch.int32) if f in ("samples", "log_w")
                               else getattr(gated, f),
                               getattr(state, f).view(torch.int32) if f in ("samples", "log_w")
                               else getattr(state, f)), f
    assert TK.gated_launches == before


# -------------------------------------------------------------- replicas


@REPLICAS
def test_replica_equals_the_jax_replica(native):
    """``evaluate`` and ``evaluate_row`` against the reference's jitted
    ``_build_eval``: accept positions (the last slot overwritten past the
    cap), fill, accepts, the fallback flag and the post-chunk state, over
    ragged chunks, row chunks past the cap, and commits."""
    S, k, B, cap = 24, 6, 64, 16
    jgate = JG.SkipGate(S, k, B, np.int32, cap=cap)

    class JEngine:
        reset_epochs = 0
        _state = JA.init(jr.key(4), S, k)

    jgate.resync(JEngine)
    tgate = SkipGate(S, k, B, np.int32, cap=cap, native=native)
    tgate.resync(_Engine(TA.init(key_from_seed(4), S, k)))
    assert tgate.native == native
    rng = np.random.default_rng(6)
    for it in range(12):
        m = rng.integers(0, B + 1, S).astype(np.int32)
        je, te = jgate.evaluate(m), tgate.evaluate(m)
        for name in ("pos", "fill", "n_acc", "n_cand"):
            np.testing.assert_array_equal(np.asarray(getattr(je, name)), getattr(te, name), err_msg=name)
        for a, b in zip(je.state, te.state):
            np.testing.assert_array_equal(_words(a), _words(b))
        assert je.fallback == te.fallback and te.row is None
        row, n = int(rng.integers(0, S)), int(rng.integers(0, 4 * B))
        jr_, tr_ = jgate.evaluate_row(row, n), tgate.evaluate_row(row, n)
        assert tr_.row == row and tr_.pos.shape == (1, cap)
        np.testing.assert_array_equal(np.asarray(jr_.pos)[row], tr_.pos[0])
        for name in ("fill", "n_acc", "n_cand"):
            assert int(np.asarray(getattr(jr_, name))[row]) == int(getattr(tr_, name)[0]), name
        for a, b in zip(jr_.state, tr_.state):
            assert _words(np.asarray(a)[row:row + 1]).tobytes() == _words(b).tobytes()
        assert jr_.fallback == tr_.fallback
        if it % 2:
            jgate.commit(jr_)
            tgate.commit(tr_)
        jgate.commit(jgate.evaluate(m))
        tgate.commit(tgate.evaluate(m))
    for a, b in ((jgate._count, tgate._count), (jgate._nxt, tgate._nxt), (jgate._logw, tgate._logw)):
        np.testing.assert_array_equal(_words(a), _words(b))


def test_native_replica_split_over_threads_equals_the_jax_replica():
    """Enough rows that the native ``evaluate`` splits them over threads
    (1,024 rows a thread at least; S not a multiple of the split, so the
    last range is short): every row's verdict and post-chunk state equal
    the reference's, over commits from empty into the steady chain."""
    S, k, B, cap = 4096 + 37, 4, 64, 32
    jgate = JG.SkipGate(S, k, B, np.int32, cap=cap)

    class JEngine:
        reset_epochs = 0
        _state = JA.init(jr.key(9), S, k)

    jgate.resync(JEngine)
    tgate = SkipGate(S, k, B, np.int32, cap=cap)
    tgate.resync(_Engine(TA.init(key_from_seed(9), S, k)))
    assert tgate.native
    rng = np.random.default_rng(9)
    for _ in range(4):
        m = rng.integers(0, B + 1, S).astype(np.int32)
        je, te = jgate.evaluate(m), tgate.evaluate(m)
        for name in ("pos", "fill", "n_acc", "n_cand"):
            np.testing.assert_array_equal(np.asarray(getattr(je, name)), getattr(te, name), err_msg=name)
        for a, b in zip(je.state, te.state):
            np.testing.assert_array_equal(_words(a), _words(b))
        jgate.commit(je)
        tgate.commit(te)
    assert int(tgate._count.min()) >= k  # past the fill, into the chain


@REPLICAS
def test_replica_chain_equals_the_ports_engine_updates(native):
    """The replica walks the engine's own chain: after 100 ragged chunks
    its ``(count, nxt, log_w)`` equal the plain update's, bit for bit."""
    S, k, B = 5, 8, 16
    state = TA.init(key_from_seed(3), S, k)
    gate = SkipGate(S, k, B, np.int32, cap=64, native=native)
    gate.resync(_Engine(state))
    rng = np.random.default_rng(0)
    for _ in range(100):
        m = rng.integers(0, B + 1, S).astype(np.int32)
        state = TA.update(state, torch.from_numpy(rng.integers(0, 1 << 30, (S, B)).astype(np.int32)),
                          torch.from_numpy(m))
        gate.commit(gate.evaluate(m))
    np.testing.assert_array_equal(gate._count, state.count.numpy())
    np.testing.assert_array_equal(gate._nxt, state.nxt.numpy())
    np.testing.assert_array_equal(gate._logw.view(np.int32), state.log_w.numpy().view(np.int32))


def test_the_replica_library_builds_with_the_chain_headers_and_a_failed_build_raises(monkeypatch):
    """The library is keyed on the kernels' chain headers as well as its
    source; with no compiler it raises (no silent torch replica)."""
    from reservoir_tpu_torch import _build

    path = _build.build_host(tnative._GATE_SOURCE, tnative.GATE_HEADERS)
    assert "-ffp-contract=off" in _build.CXX_FLAGS and path.endswith(".so")
    monkeypatch.setattr(tnative, "_gate_lib", None)
    monkeypatch.setattr(_build, "CXX", "no-such-compiler-for-the-gate")
    with pytest.raises(RuntimeError, match="not found on PATH"):
        SkipGate(4, 4, 8, np.int32)
    monkeypatch.undo()
    assert SkipGate(4, 4, 8, np.int32).native
    assert not SkipGate(4, 4, 8, np.int32, native=False).native


# ------------------------------------------------ gated == ungated (port)


@pytest.mark.parametrize("mode", ["plain", "weighted", "distinct"])
def test_gated_bridge_equals_ungated_across_modes(mode):
    """Plain mode elides with the same reservoirs; weighted and distinct
    bridges keep the flag inert and say why."""
    S, B, rounds = 4, 32, 6
    cfg = _cfg(mode)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    if mode == "distinct":
        data = (data % 97).astype(np.int32)
    wdata = rng.uniform(0.1, 2.0, data.shape).astype(np.float32) if mode == "weighted" else None
    results, states = [], []
    for gated in (False, True):
        bridge = DeviceStreamBridge(cfg, key=7, gated=gated, gate_tile=16, device="cpu")
        states.append((bridge.gate_active, bridge.gate_inert_reason))
        results.append(_feed(bridge, data, wdata, chunk=B))
        if gated and mode == "plain":
            assert bridge.metrics.gate_bytes_elided > 0
    _equal(results[0], results[1])
    assert states[0] == (False, None)
    if mode == "plain":
        assert states[1] == (True, None)
    else:
        assert not states[1][0] and mode in states[1][1]


@pytest.mark.parametrize("chunk", [7, 16, 53, None], ids=["7", "B", "3B+5", "whole"])
def test_gated_bridge_equals_ungated_across_chunk_splits(chunk):
    """A prime stride, the exact tile, a straddling stride and one bulk push
    (the pre-staging path) all land on the ungated reservoirs."""
    S, B, rounds = 3, 16, 12
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=6)
    data = np.random.default_rng(11).integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    ref = _feed(DeviceStreamBridge(cfg, key=3, device="cpu"), data, chunk=B)
    bridge = DeviceStreamBridge(cfg, key=3, gated=True, gate_tile=12, device="cpu")
    _equal(ref, _feed(bridge, data, chunk=chunk))
    assert bridge.metrics.gated_dispatches >= 1


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "serial"])
def test_gated_interleaved_feed_equals_ungated(pipelined):
    """The staged gate path: an interleaved feed demuxes into staging and
    the gate takes each flushed tile."""
    S, B, rounds = 4, 16, 6
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=4)
    data = np.random.default_rng(5).integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    streams = np.tile(np.arange(S, dtype=np.int32), B)
    results = []
    for gated in (False, True):
        bridge = DeviceStreamBridge(cfg, key=9, gated=gated, gate_tile=8, pipelined=pipelined,
                                    device="cpu")
        for t in range(rounds):
            bridge.push_interleaved(streams, np.ascontiguousarray(data[:, t * B:(t + 1) * B].T.ravel()))
        results.append(bridge.complete())
        if gated:
            m = bridge.metrics
            assert m.gate_bytes_elided > 0 and m.gated_dispatches >= 1 and m.gate_eval_s > 0
    _equal(results[0], results[1])


def test_gated_fill_overflow_falls_back_and_the_steady_tail_elides():
    """k larger than the gate tile: every fill-phase tile overflows and
    ships whole (one ungated flush each), the steady tail elides."""
    S, B, rounds, k = 3, 16, 20, 12
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=k)
    data = np.random.default_rng(13).integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    ref = _feed(DeviceStreamBridge(cfg, key=1, device="cpu"), data, chunk=B)
    bridge = DeviceStreamBridge(cfg, key=1, gated=True, gate_tile=8, device="cpu")
    _equal(ref, _feed(bridge, data, chunk=B))
    m = bridge.metrics
    assert m.gate_bytes_shipped > 0 and m.gate_bytes_elided > 0 and m.gated_dispatches >= 1
    assert m.flushes > m.gated_dispatches  # fallback tiles flushed ungated
    assert m.elements == m.flushed_elements == data.size


def test_push_tile_dispatches_the_pending_buffer_and_marks_the_replica_dirty():
    S, B, k = 2, 8, 2
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=k)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1 << 30, (S, 64)).astype(np.int32)
    tile = rng.integers(0, 1 << 30, (S, B)).astype(np.int32)
    tail = rng.integers(0, 1 << 30, (S, 40)).astype(np.int32)
    results = []
    for gated in (False, True):
        bridge = DeviceStreamBridge(cfg, key=0, gated=gated, gate_tile=8, device="cpu")
        for s in range(S):
            bridge.push(s, data[s])
        if gated:
            assert bridge._gate.pending()
            dispatches = bridge.metrics.gated_dispatches
        bridge.push_tile(tile)
        if gated:
            assert not bridge._gate.pending() and bridge._gate._dirty
            assert bridge.metrics.gated_dispatches == dispatches + 1
        for s in range(S):
            bridge.push(s, tail[s])  # the replica pulls the engine again
        if gated:
            assert not bridge._gate._dirty
        results.append(bridge.complete())
    _equal(results[0], results[1])


def test_gate_eligibility_matrix():
    assert gate_ineligible_reason(_cfg("plain")) is None
    assert "weighted" in gate_ineligible_reason(_cfg("weighted"))
    assert "distinct" in gate_ineligible_reason(_cfg("distinct"))
    assert "WIDE" in gate_ineligible_reason(_cfg("plain", count_dtype="wide"))
    assert "int32" in gate_ineligible_reason(_cfg("plain", count_dtype="int64"))
    assert "mesh" in gate_ineligible_reason(_cfg("plain", mesh_axis="r"))
    # 0 takes the reference's untuned defaults
    bridge = DeviceStreamBridge(_cfg(), gated=True, gate_tile=0, gate_push_chunk=0, device="cpu")
    assert bridge.gate_active and bridge._gate.cap == 64 and bridge.gate_push_chunk == 1 << 20
    bridge.set_gate_push_chunk(0)
    assert bridge.gate_push_chunk == 1
    with pytest.raises(ValueError, match="gate_tile must be positive"):
        DeviceStreamBridge(_cfg(), gated=True, gate_tile=-1, device="cpu")


def test_sample_gated_validations():
    eng = ReservoirEngine(_cfg(num_reservoirs=2), key=0, reusable=True, device="cpu")
    tile = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="nvalid"):
        eng.sample_gated(tile, [5, 0], [8, 8])  # nvalid > Bg
    with pytest.raises(ValueError, match="nvalid"):
        eng.sample_gated(tile, [-1, 0], [8, 8])
    with pytest.raises(ValueError, match="nonnegative"):
        eng.sample_gated(tile, [0, 0], [-1, 0])
    with pytest.raises(ValueError, match="Bg"):
        eng.sample_gated(np.zeros((3, 4), np.int32), [0, 0], [0, 0])
    with pytest.raises(ValueError, match="nvalid/advance"):
        eng.sample_gated(tile, [0, 0, 0], [0, 0])
    for mode in ("weighted", "distinct"):
        other = ReservoirEngine(_cfg(mode, num_reservoirs=2), key=0, reusable=True, device="cpu")
        with pytest.raises(ValueError, match="duplicates mode"):
            other.sample_gated(tile, [0, 0], [0, 0])
    assert eng.reset_epochs == 0
    eng.sample_gated(tile, [0, 0], [3, 5])  # an advance of nothing but skips
    assert eng.state.count.tolist() == [3, 5] and eng._min_count == 3


def test_gate_resync_refuses_a_pending_buffer():
    cfg = _cfg(num_reservoirs=2, tile_size=8, max_sample_size=2)
    bridge = DeviceStreamBridge(cfg, key=0, gated=True, gate_tile=8, device="cpu")
    for s in range(2):
        bridge.push(s, np.arange(64, dtype=np.int32))
    assert bridge._gate.pending()
    with pytest.raises(RuntimeError, match="pending"):
        bridge._gate.resync(bridge.engine)


def test_gated_fuzz_against_ungated():
    """Random partial pushes, spontaneous flushes, ragged tails and gate
    tiles below k (permanent fill fallback) land on the ungated
    reservoirs."""
    rng = np.random.default_rng(42)
    for trial in range(3):
        S = int(rng.integers(2, 6))
        B = int(rng.integers(8, 40))
        k = int(rng.integers(2, 12))
        cap = int(rng.integers(4, 24))
        rounds = int(rng.integers(5, 12))
        cfg = SamplerConfig(max_sample_size=k, num_reservoirs=S, tile_size=B)
        data = {s: rng.integers(0, 1 << 30, rounds * B + int(rng.integers(0, B))).astype(np.int32)
                for s in range(S)}

        def feed(bridge):
            offs = {s: 0 for s in range(S)}
            order = np.random.default_rng(trial)
            while any(offs[s] < len(data[s]) for s in range(S)):
                s = int(order.integers(0, S))
                chunk = data[s][offs[s]:offs[s] + int(order.integers(1, 3 * B))]
                if chunk.size == 0:
                    continue
                bridge.push(s, chunk)
                offs[s] += chunk.size
                if order.random() < 0.1:
                    bridge.flush()
            return bridge.complete()

        ref = feed(DeviceStreamBridge(cfg, key=trial, device="cpu"))
        got = feed(DeviceStreamBridge(cfg, key=trial, gated=True, gate_tile=cap,
                                      gate_push_chunk=int(rng.integers(8, 200)), device="cpu"))
        _equal(ref, got)


# ------------------------------------------------ port == JAX (gated)


_COUNTERS = ("gated_dispatches", "gate_bytes_elided", "gate_bytes_shipped", "gate_buffered_flushes",
             "flushes", "elements", "flushed_elements")


@pytest.mark.parametrize("native", [True, False], ids=["native", "torch"])
@pytest.mark.parametrize("feed", ["push", "interleaved"])
def test_gated_bridge_equals_the_jax_gated_bridge(feed, native):
    """The same feeds through both packages' gated bridges: the same
    reservoirs and the same gate counters (fill fallback, coalesced
    dispatches and a push_tile among them)."""
    S, B, k, rounds = 4, 16, 6, 10
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=k)
    rng = np.random.default_rng(21)
    data = rng.integers(-(2**31), 2**31 - 1, (S, rounds * B)).astype(np.int32)
    tile = rng.integers(0, 1 << 30, (S, B)).astype(np.int32)
    jb = JBridge(_jcfg(cfg), key=5, gated=True, gate_tile=10)
    tb = DeviceStreamBridge(cfg, key=5, gated=True, gate_tile=10, device="cpu", native=native)
    streams = np.tile(np.arange(S, dtype=np.int32), B)
    for b in (jb, tb):
        for t in range(rounds):
            cols = slice(t * B, (t + 1) * B)
            if feed == "push":
                for s in range(S):
                    b.push(s, data[s, cols][: 5 + (s + t) % 7])
                    b.push(s, data[s, cols][5 + (s + t) % 7:])
            else:
                b.push_interleaved(streams, np.ascontiguousarray(data[:, cols].T.ravel()))
            if t == rounds // 2:
                b.push_tile(tile)
    _equal(jb.complete(), tb.complete())
    jm, tm = jb.metrics.snapshot(), tb.metrics.snapshot()
    for key in _COUNTERS:
        assert jm[key] == tm[key], key
    assert tm["gated_dispatches"] >= 1 and tm["gate_bytes_elided"] > 0 and tm["gate_skip_frac"] > 0


def test_gated_bridge_equals_the_jax_gated_bridge_on_a_bulk_push_of_each_row():
    """One bulk push a row (the pre-staging path in slices of
    gate_push_chunk), rows in turn."""
    S, B, k = 3, 32, 8
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=k)
    data = np.random.default_rng(8).integers(0, 1 << 30, (S, 40 * B)).astype(np.int32)
    jb = JBridge(_jcfg(cfg), key=2, gated=True, gate_tile=16, gate_push_chunk=200)
    tb = DeviceStreamBridge(cfg, key=2, gated=True, gate_tile=16, gate_push_chunk=200, device="cpu")
    _equal(_feed(jb, data), _feed(tb, data))
    jm, tm = jb.metrics.snapshot(), tb.metrics.snapshot()
    for key in _COUNTERS:
        assert jm[key] == tm[key], key


def test_the_torch_replica_is_taken_only_when_asked_for():
    gated = DeviceStreamBridge(_cfg(), gated=True, device="cpu")
    plain = DeviceStreamBridge(_cfg(), gated=True, device="cpu", native=False)
    assert gated._gate.native and not plain._gate.native


def test_gated_kill_midstream_recover_replays_bit_exact(tmp_path):
    """An injected fatal fault kills a gated journaling bridge mid-stream;
    ``recover()`` replays the mixed plain and gated journal, the rows
    resume from their durable counts, and the reservoirs equal an
    uninterrupted gated run's; every pushed element counts as flushed at
    completion."""
    from reservoir_tpu_torch.errors import SamplerClosedError
    from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule

    S, B, rounds = 3, 16, 12
    cfg = _cfg(num_reservoirs=S, tile_size=B, max_sample_size=4)
    data = np.random.default_rng(19).integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    whole = DeviceStreamBridge(cfg, key=11, gated=True, gate_tile=8, device="cpu")
    expected = _feed(whole, data, chunk=B)
    assert whole.metrics.elements == whole.metrics.flushed_elements == data.size
    plane = FaultPlane([FaultRule("bridge.dispatch", exc=RuntimeError, after=2, times=1,
                                  message="injected kill")])
    ckdir = str(tmp_path / "ck")
    bridge = DeviceStreamBridge(cfg, key=11, gated=True, gate_tile=8, checkpoint_dir=ckdir,
                                checkpoint_every=3, faults=plane, device="cpu")
    with pytest.raises((RuntimeError, SamplerClosedError)):
        _feed(bridge, data, chunk=B)
    del bridge
    recovered = DeviceStreamBridge.recover(ckdir, device="cpu")
    assert recovered.gate_active
    counts = recovered.engine.state.count.numpy()
    for s in range(S):
        recovered.push(s, data[s, counts[s]:])
    _equal(expected, recovered.complete())
