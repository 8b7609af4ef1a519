"""The port's serving plane (``SessionTable``, ``ReservoirService``) against
the JAX package's, on the CPU: the cases of ``tests/test_serve.py``, each
held against the JAX service fed the same calls.

Snapshots, metrics, errors, the session journal's bytes and recovery are
compared with the JAX service's; ``SessionTable.sub_key`` with
``jr.fold_in`` twice over.  Checkpoint directories recover across the two
packages.  The JAX package's wall-clock test of the sweep's cost is held
here as its work count: a sweep pops exactly the expired heap entries.
"""

from __future__ import annotations

import gc
import os

import jax.random as jr
import numpy as np
import pytest

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu.serve import ReservoirService as JService
from reservoir_tpu.serve import SessionTable as JTable
from reservoir_tpu_torch import ReservoirEngine, ReservoirService, SamplerConfig, SessionTable
from reservoir_tpu_torch.errors import (
    SamplerClosedError,
    ServiceSaturated,
    SessionIngestError,
    StaleSessionError,
    UnknownSessionError,
)
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule
from reservoir_tpu import errors as jerrors

MODES = ["plain", "weighted", "distinct"]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """No global fault plane, and a throwaway knob cache: every service
    takes the builtin knobs."""
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    faults.uninstall()
    yield
    faults.uninstall()


def _kw(mode="plain", **kw):
    kw.setdefault("max_sample_size", 4)
    kw.setdefault("num_reservoirs", 8)
    kw.setdefault("tile_size", 8)
    return dict(distinct=mode == "distinct", weighted=mode == "weighted", **kw)


def _pair(mode="plain", key=0, cfg=None, **kw):
    """A JAX service and the port's (on the CPU), built alike: serial
    bridges unless asked otherwise, since whether a pipelined service
    flushes after a coalesced push depends on its worker's timing, and so
    does ``flushed_seq``."""
    cfg = cfg or {}
    kw.setdefault("pipelined", False)
    return (JService(JConfig(**_kw(mode, **cfg)), key=key, **kw),
            ReservoirService(SamplerConfig(**_kw(mode, **cfg)), key=key, device="cpu", **kw))


def _both(services, fn):
    """``fn`` on each service; their results, which must be equal arrays."""
    out = [fn(s) for s in services]
    np.testing.assert_array_equal(out[0].view(np.uint8), out[1].view(np.uint8))
    return out[1]


def _either(error):
    """``error`` and the JAX package's class of the same name: what either
    service raises."""
    return (error, getattr(jerrors, error.__name__, error))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ session table


def test_table_open_route_close_and_generations():
    table = SessionTable(4, seed=3)
    a, evicted = table.open("a")
    assert evicted == [] and a.row == 0 and a.generation == 0
    assert table.route("a") is a
    assert "a" in table and len(table) == 1
    assert table.close("a") is a
    assert table.generation_of(0) == 1
    with pytest.raises(UnknownSessionError):
        table.route("a")
    with pytest.raises(UnknownSessionError):
        table.close("a")
    with pytest.raises(StaleSessionError):
        table.check(a)
    b, _ = table.open("b")
    assert b.row == 1  # FIFO free list: fresh rows before recycled ones
    with pytest.raises(ValueError, match="already open"):
        table.open("b")
    with pytest.raises(TypeError, match="must be str"):
        table.open(42)


def test_table_lru_eviction_and_recycle_order():
    table = SessionTable(2)
    table.open("a")
    table.open("b")
    table.route("a")
    c, evicted = table.open("c")
    assert [e.key for e in evicted] == ["b"]
    assert c.row == evicted[0].row and c.generation == 1
    with pytest.raises(UnknownSessionError):
        table.route("b")


def test_table_ttl_sweep_and_pressure_eviction():
    clock = _Clock()
    table = SessionTable(2, ttl_s=10.0, clock=clock)
    table.open("a")
    clock.t = 5.0
    table.open("b")
    assert table.sweep() == []
    clock.t = 12.0
    assert [s.key for s in table.sweep()] == ["a"]
    table.route("b")
    clock.t = 30.0
    table.open("c")
    _, evicted = table.open("d")
    assert [e.key for e in evicted] == ["b"]


@pytest.mark.parametrize("n", [1_000, 10_000])
def test_table_sweep_pops_exactly_the_expired_entries(n):
    """The sweep's work is the expired count, whatever the table's size
    (the JAX package times this; its work count is held here)."""
    expired_n = 64
    table = SessionTable(n, ttl_s=10.0, clock=lambda: 0.0)
    for i in range(expired_n):
        table.open(f"d{i}", now=0.0)
    for i in range(n - expired_n):
        table.open(f"s{i}", now=100.0)
    heap_before = len(table._expiry)
    evicted = table.sweep(now=12.0)
    assert sorted(s.key for s in evicted) == sorted(f"d{i}" for i in range(expired_n))
    assert heap_before - len(table._expiry) == expired_n
    assert len(table) == n - expired_n


def test_table_expiry_heap_compacts_under_touch_churn():
    clock = _Clock()
    table = SessionTable(64, ttl_s=10.0, clock=clock)
    for i in range(64):
        table.open(f"s{i}")
    for step in range(2000):
        clock.t += 0.001
        table.route(f"s{step % 64}")
    assert len(table._expiry) <= max(1024, 8 * len(table))
    clock.t += 100.0
    assert len(table.sweep()) == 64 and len(table) == 0


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_sub_key_equals_jax_fold_in_twice(seed):
    table = SessionTable(1 << 20, seed=seed)
    base = jr.key(seed)
    for row, gen in [(0, 0), (1, 1), (3, 7), (1023, 2), (999_999, 12345)]:
        want = np.asarray(jr.key_data(jr.fold_in(jr.fold_in(base, row), gen)))
        got = table.sub_key(row, gen)
        assert got.shape == (2,)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(
            np.asarray(jr.key_data(JTable(4, seed=seed).sub_key(row, gen))), want)
    # deterministic, and fresh per (row, generation) and seed
    k = table.sub_key(1, 1).tolist()
    assert k == table.sub_key(1, 1).tolist()
    for other in (table.sub_key(1, 2), table.sub_key(2, 1), table.sub_key(0, 0),
                  SessionTable(4, seed=seed + 1).sub_key(1, 1)):
        assert other.tolist() != k


def test_table_operations_equal_the_jax_table():
    """A seeded script of opens, routes, closes and sweeps under a fake
    clock: every lease, eviction and sweep equals the JAX table's."""
    rng = np.random.default_rng(5)
    clocks = [_Clock(), _Clock()]
    tables = [JTable(6, ttl_s=3.0, clock=clocks[0]), SessionTable(6, ttl_s=3.0, clock=clocks[1])]
    keys = []
    for step in range(600):
        dt = float(rng.exponential(0.2))
        for c in clocks:
            c.t += dt
        op = rng.random()
        if op < 0.4 or not keys:
            key = f"k{step}"
            outs = [t.open(key) for t in tables]
            assert [(s.row, s.generation, [e.key for e in ev]) for s, ev in outs][0] == \
                [(s.row, s.generation, [e.key for e in ev]) for s, ev in outs][1]
            keys.append(key)
        elif op < 0.75:
            key = keys[int(rng.integers(len(keys)))]
            if key in tables[0]:
                assert tables[0].route(key).row == tables[1].route(key).row
            else:
                for t in tables:
                    with pytest.raises(KeyError):
                        t.route(key)
        elif op < 0.9:
            key = keys[int(rng.integers(len(keys)))]
            if key in tables[0]:
                assert tables[0].close(key).row == tables[1].close(key).row
        else:
            assert [s.key for s in tables[0].sweep()] == [s.key for s in tables[1].sweep()]
        assert [(s.key, s.row, s.generation) for s in tables[0].sessions()] == \
            [(s.key, s.row, s.generation) for s in tables[1].sessions()]
    assert [tables[0].generation_of(r) for r in range(6)] == [tables[1].generation_of(r) for r in range(6)]


# ------------------------------------------------- engine peek + row resets


@pytest.mark.parametrize("mode", MODES)
def test_peek_arrays_is_non_destructive_and_result_unchanged(mode):
    cfg = SamplerConfig(**_kw(mode, num_reservoirs=3))
    eng = ReservoirEngine(cfg, key=5, device="cpu")
    ref = ReservoirEngine(cfg, key=5, device="cpu")
    tile = np.arange(24, dtype=np.int32).reshape(3, 8)
    w = np.linspace(0.5, 2.0, 24, dtype=np.float32).reshape(3, 8)
    kw = {"weights": w} if mode == "weighted" else {}
    eng.sample(tile, **kw)
    ref.sample(tile, **kw)
    peek1 = eng.peek_arrays()
    assert eng.is_open
    eng.sample(tile + 100, **kw)
    ref.sample(tile + 100, **kw)
    peek2 = eng.peek_arrays()
    assert not np.array_equal(peek1[0], peek2[0]) or mode == "distinct"
    res, ref_res = eng.result_arrays(), ref.result_arrays()
    np.testing.assert_array_equal(res[0], ref_res[0])
    np.testing.assert_array_equal(res[1], ref_res[1])
    np.testing.assert_array_equal(peek2[0], res[0])
    assert not eng.is_open
    with pytest.raises(SamplerClosedError):
        eng.peek_arrays()


# ------------------------------------------------------------- the service


@pytest.mark.parametrize("mode", MODES)
def test_service_snapshots_equal_the_jax_service(mode):
    services = _pair(mode, key=11, cfg=dict(num_reservoirs=6, max_sample_size=3), coalesce_bytes=64)
    rng = np.random.default_rng(0)
    fed = {}
    for i in range(6):
        key = f"s{i}"
        elems = ((i + 1) * 1000 + rng.integers(0, 500, 20)).astype(np.int32)
        w = rng.uniform(0.1, 2.0, 20).astype(np.float32) if mode == "weighted" else None
        for svc in services:
            svc.open_session(key)
            assert svc.ingest(key, elems, weights=w) == 20
        fed[key] = (elems, w)
    for i in range(6):
        got = _both(services, lambda s: s.snapshot(f"s{i}"))
        assert got.size > 0
        assert np.all((got >= (i + 1) * 1000) & (got < (i + 1) * 1000 + 500))
    for svc in services:
        svc.ingest("s0", fed["s0"][0] + 7, weights=fed["s0"][1])
    assert _both(services, lambda s: s.snapshot("s0")).size > 0
    assert services[0].metrics.snapshot() == services[1].metrics.snapshot()
    assert services[0].flushed_seq == services[1].flushed_seq


def test_service_snapshot_cache_keyed_by_flushed_seq():
    services = _pair()
    for svc in services:
        svc.open_session("a")
        svc.ingest("a", np.arange(20, dtype=np.int32))
        svc.snapshot("a")
    misses = services[1].metrics.snapshot_misses
    for svc in services:
        for _ in range(5):
            svc.snapshot("a")
    assert services[1].metrics.snapshot_misses == misses
    assert services[1].metrics.snapshot_hits >= 5
    for svc in services:
        svc.ingest("a", np.arange(20, dtype=np.int32))
    _both(services, lambda s: s.snapshot("a"))
    assert services[1].metrics.snapshot_misses == misses + 1
    assert services[0].metrics.snapshot() == services[1].metrics.snapshot()


def test_service_recycle_resets_row_and_cache():
    services = _pair(key=3, cfg=dict(num_reservoirs=2, max_sample_size=4))
    for svc in services:
        svc.open_session("a")
        svc.open_session("b")
        svc.ingest("a", np.arange(1000, 1030, dtype=np.int32))
        svc.snapshot("a")
        svc.close_session("a")
        svc.open_session("c")  # recycles a's row (generation 1)
    assert _both(services, lambda s: s.snapshot("c")).size == 0
    assert services[1].metrics.recycles == 1
    assert services[1].bridge.engine.reset_epochs == 1
    for svc in services:
        svc.ingest("c", np.arange(2000, 2030, dtype=np.int32))
    got = _both(services, lambda s: s.snapshot("c"))
    assert got.size == 4 and np.all(got >= 2000)


@pytest.mark.parametrize("call, kw, error, match", [
    ("ingest", dict(key="ghost", elements=[1]), UnknownSessionError, "ghost"),
    ("snapshot", dict(key="ghost"), UnknownSessionError, "ghost"),
    ("close_session", dict(key="ghost"), UnknownSessionError, "ghost"),
    ("ingest", dict(key="a", elements=["x"]), SessionIngestError, r"session 'a'.*not convertible"),
    ("ingest", dict(key="a", elements=np.zeros((2, 2), np.int32)), SessionIngestError, "must be 1-D"),
    ("ingest", dict(key="a", elements=[1], weights=[1.0]), SessionIngestError, "weights are only meaningful"),
    ("ingest", dict(key="a", elements=np.zeros(1 << 23, np.int32)), SessionIngestError, "exceeds"),
    ("open_session", dict(key="a"), ValueError, "already open"),
], ids=["ingest_unknown", "snapshot_unknown", "close_unknown", "not_convertible", "two_dims",
        "weights_unweighted", "too_big", "open_twice"])
def test_service_routes_errors_per_session(call, kw, error, match):
    services = _pair(cfg=dict(max_sample_size=4))
    msgs = []
    for svc in services:
        svc.open_session("a")
        with pytest.raises(_either(error), match=match) as info:
            getattr(svc, call)(**kw)
        msgs.append(str(info.value))
        # the failed call cost the session nothing and the service is live
        svc.ingest("a", np.arange(10, dtype=np.int32))
    assert msgs[0] == msgs[1]
    assert _both(services, lambda s: s.snapshot("a")).size > 0


@pytest.mark.parametrize("what", ["missing", "shape", "negative"])
def test_weighted_ingest_errors_equal_the_jax_service(what):
    services = _pair("weighted")
    args = {"missing": ([1, 2], None), "shape": ([1, 2], [1.0]), "negative": ([1, 2], [1.0, -3.0])}[what]
    msgs = []
    for svc in services:
        svc.open_session("w")
        with pytest.raises(_either(SessionIngestError)) as info:
            svc.ingest("w", args[0], weights=args[1])
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_an_injected_ingest_fault_is_a_session_error():
    plane = FaultPlane([FaultRule("serve.ingest", exc=RuntimeError, message="boom", times=1)])
    svc = ReservoirService(SamplerConfig(**_kw()), key=0, faults=plane, device="cpu")
    svc.open_session("a")
    with pytest.raises(SessionIngestError, match="RuntimeError: boom"):
        svc.ingest("a", [1, 2])
    assert svc.ingest("a", [1, 2]) == 2


def test_admission_control_rejects_with_retry_after():
    # hold the single zero-copy flush permit with a delay-injected dispatch
    # (a slow device), then overfill the pending budget
    plane = FaultPlane([FaultRule("bridge.dispatch", exc=None, delay=0.5, times=1)])
    svc = ReservoirService(SamplerConfig(**_kw(num_reservoirs=2, tile_size=4)), key=0, faults=plane,
                           coalesce_bytes=16, max_inflight_bytes=64, device="cpu")
    svc.open_session("a")
    svc.ingest("a", np.arange(4, dtype=np.int32))
    with pytest.raises(ServiceSaturated) as exc_info:
        for _ in range(8):
            svc.ingest("a", np.arange(8, dtype=np.int32))
    assert exc_info.value.retry_after_s > 0
    assert svc.metrics.rejections == 1
    svc.sync()
    svc.ingest("a", np.arange(8, dtype=np.int32))
    assert svc.snapshot("a").size > 0


def test_ttl_sweep_through_service():
    clock = _Clock()
    services = _pair(ttl_s=10.0)
    for svc in services:
        svc._table._clock = clock
    clock.t = 0.0
    for svc in services:
        svc.open_session("a")
    clock.t = 5.0
    for svc in services:
        svc.open_session("b")
    clock.t = 12.0
    assert [svc.sweep_expired() for svc in services] == [["a"], ["a"]]
    assert services[1].metrics.evictions == 1
    for svc in services:
        with pytest.raises(_either(UnknownSessionError)):
            svc.snapshot("a")
    assert _both(services, lambda s: s.snapshot("b")).size == 0


def test_autonomous_ttl_sweep_on_idle_but_queried_service():
    clock = _Clock()
    services = _pair(ttl_s=10.0, sweep_interval_s=2.0)
    for svc in services:
        svc._table._clock = clock
        svc._last_sweep = clock.t
        svc.open_session("a")
    clock.t = 1.0
    for svc in services:
        svc.snapshot("a")
    clock.t = 5.0
    for svc in services:
        svc.open_session("b")
    clock.t = 12.0
    _both(services, lambda s: s.snapshot("b"))
    for svc in services:
        assert "a" not in svc.table and "b" in svc.table
        assert svc.metrics.evictions == 1
    clock.t = 30.0
    for svc in services:
        with pytest.raises(_either(UnknownSessionError)):
            svc.snapshot("b")
        assert svc.metrics.evictions == 2
    for svc in services:
        svc.open_session("c")
        svc.ingest("c", np.arange(4, dtype=np.int32))
    clock.t = 45.0
    for svc in services:
        svc.open_session("d")
    clock.t = 58.0
    for svc in services:
        svc.open_session("e")
        svc.ingest("e", np.arange(4, dtype=np.int32))
        assert "c" not in svc.table and "d" not in svc.table
    assert services[0].metrics.snapshot() == services[1].metrics.snapshot()
    # without sweep_interval_s sweeps stay manual
    svc2 = ReservoirService(SamplerConfig(**_kw()), key=1, ttl_s=10.0, device="cpu")
    svc2._table._clock = clock
    svc2.open_session("x")
    clock.t += 100.0
    svc2.open_session("y")
    svc2.snapshot("y")
    assert "x" in svc2.table


# ------------------------------------------------ live migration, the gate


@pytest.mark.parametrize("mode", MODES)
def test_service_export_and_adopt_equal_the_jax_service(mode):
    """Rows exported from one service and adopted by another continue as
    they would have; the destination's snapshots equal the JAX pair's."""
    rng = np.random.default_rng(2)
    srcs = _pair(mode, key=1, coalesce_bytes=64)
    dsts = _pair(mode, key=2, coalesce_bytes=64)
    w = (lambda n: rng.uniform(0.1, 2.0, n).astype(np.float32)) if mode == "weighted" else (lambda n: None)
    for svc in srcs + dsts:
        for i in range(3):
            svc.open_session(f"s{i}")
    for i in range(3):
        elems, ws = rng.integers(0, 1000, 40).astype(np.int32), w(40)
        for svc in srcs:
            svc.ingest(f"s{i}", elems, weights=ws)
    jpart, tpart = srcs[0].export_rows([0, 1]), srcs[1].export_rows([0, 1])
    dsts[0].adopt_rows([2, 0], jpart)
    dsts[1].adopt_rows([2, 0], tpart)
    assert dsts[1].bridge.flushed_seq == dsts[0].bridge.flushed_seq
    elems, ws = rng.integers(0, 1000, 40).astype(np.int32), w(40)
    for svc in dsts:
        svc.ingest("s2", elems, weights=ws)
    for i in range(3):
        _both(dsts, lambda s: s.snapshot(f"s{i}"))


def test_gated_service_equals_the_ungated_one():
    rng = np.random.default_rng(4)
    cfg = SamplerConfig(**_kw(num_reservoirs=16, max_sample_size=4, tile_size=64))
    services = [ReservoirService(cfg, key=7, gated=g, coalesce_bytes=512, device="cpu") for g in (False, True)]
    assert services[1].bridge.gate_active
    for _ in range(60):
        key = f"s{int(rng.integers(20))}"
        chunk = rng.integers(0, 1 << 20, int(rng.integers(1, 120))).astype(np.int32)
        for svc in services:
            if key not in svc.table:
                svc.open_session(key)
            svc.ingest(key, chunk)
    for s in services[0].table.sessions():
        np.testing.assert_array_equal(services[0].snapshot(s.key), services[1].snapshot(s.key))
    assert services[1].bridge.metrics.gated_dispatches > 0


# ----------------------------------------------- recycling fuzz + recovery


def _fuzz(services, mode, steps, seed=42, live_cap=12):
    """Open, ingest, evict and reopen at random, alike on every service;
    returns the keys still open."""
    rng = np.random.default_rng(seed)
    next_id = 0
    live = []
    for _ in range(steps):
        op = rng.random()
        if (op < 0.25 and len(live) < live_cap) or not live:
            key = f"s{next_id}"
            next_id += 1
            for svc in services:
                svc.open_session(key)
            live = [k for k in live if k in services[0].table] + [key]
        elif op < 0.8:
            key = live[int(rng.integers(len(live)))]
            if key not in services[0].table:
                live.remove(key)
                continue
            n = int(rng.integers(1, 12))
            base = (int(key[1:]) + 1) * 10_000
            elems = (base + rng.integers(0, 5000, n)).astype(np.int32)
            w = rng.uniform(0.1, 3.0, n).astype(np.float32) if mode == "weighted" else None
            for svc in services:
                svc.ingest(key, elems, weights=w)
        else:
            key = live[int(rng.integers(len(live)))]
            if key in services[0].table:
                for svc in services:
                    svc.close_session(key)
            live.remove(key)
    return [s.key for s in services[0].table.sessions()]


@pytest.mark.parametrize("mode", MODES)
def test_fuzz_recycle_under_load_with_recovery(tmp_path, mode):
    """Open, ingest, evict and reopen at random in both packages: no
    leakage, snapshots equal the JAX service's, the session journals are
    the same bytes, and each package recovers the other's directory to the
    same snapshots."""
    ck = {p: str(tmp_path / p) for p in ("jax", "port")}
    cfg = dict(num_reservoirs=5, max_sample_size=3, tile_size=8)
    kw = dict(key=21, checkpoint_every=3, coalesce_bytes=64, pipelined=False)
    services = (JService(JConfig(**_kw(mode, **cfg)), checkpoint_dir=ck["jax"], **kw),
                ReservoirService(SamplerConfig(**_kw(mode, **cfg)), checkpoint_dir=ck["port"],
                                 device="cpu", **kw))
    open_keys = _fuzz(services, mode, 120)
    assert services[1].metrics.recycles > 0
    before = {}
    for key in open_keys:
        got = _both(services, lambda s: s.snapshot(key))
        base = (int(key[1:]) + 1) * 10_000
        assert np.all((got >= base) & (got < base + 5000)), key
        before[key] = got
    assert services[0].metrics.snapshot() == services[1].metrics.snapshot()
    seq = [svc.sync() for svc in services]
    assert seq[0] == seq[1]
    with open(os.path.join(ck["jax"], "sessions.jsonl"), "rb") as a, \
            open(os.path.join(ck["port"], "sessions.jsonl"), "rb") as b:
        assert a.read() == b.read()
    del services
    gc.collect()
    for rec in (ReservoirService.recover(ck["port"], device="cpu"),
                ReservoirService.recover(ck["jax"], device="cpu"),
                JService.recover(ck["port"])):
        assert rec.metrics.recoveries == 1 and rec.flushed_seq == seq[1]
        assert sorted(s.key for s in rec.table.sessions()) == sorted(open_keys)
        for key in open_keys:
            np.testing.assert_array_equal(rec.snapshot(key), before[key], err_msg=key)
    rec.open_session("post")
    rec.ingest("post", np.arange(99, dtype=np.int32),
               weights=np.ones(99, np.float32) if mode == "weighted" else None)
    assert rec.snapshot("post").size > 0


def test_recovery_replays_resets_between_journaled_flushes(tmp_path):
    """A recycle's reset after the last checkpoint re-applies between the
    journaled flushes it fell between, in both packages' recovery."""
    cfg = dict(num_reservoirs=2, max_sample_size=4, tile_size=8)
    ck = {p: str(tmp_path / p) for p in ("jax", "port")}
    kw = dict(key=5, checkpoint_every=1000, pipelined=False)
    services = (JService(JConfig(**_kw(**cfg)), checkpoint_dir=ck["jax"], **kw),
                ReservoirService(SamplerConfig(**_kw(**cfg)), checkpoint_dir=ck["port"], device="cpu", **kw))
    for svc in services:
        svc.open_session("a")
        svc.open_session("b")
        svc.ingest("a", np.arange(100, 130, dtype=np.int32))
        svc.close_session("a")
        svc.open_session("c")  # the reset of a's row lands mid-journal
        svc.ingest("c", np.arange(500, 560, dtype=np.int32))
        svc.ingest("b", np.arange(900, 930, dtype=np.int32))
    before = {k: _both(services, lambda s: s.snapshot(k)) for k in ("b", "c")}
    for svc in services:
        svc.sync()
    del services
    gc.collect()
    for rec in (ReservoirService.recover(ck["port"], device="cpu"),
                ReservoirService.recover(ck["jax"], device="cpu")):
        for k, want in before.items():
            np.testing.assert_array_equal(rec.snapshot(k), want)
        assert rec.table.route("c").generation == 1
        assert rec.bridge.engine.reset_epochs == 1


def test_recover_refuses_a_session_journal_of_another_plane(tmp_path):
    from reservoir_tpu_torch.errors import CheckpointMismatch

    ck = str(tmp_path / "ck")
    svc = ReservoirService(SamplerConfig(**_kw()), key=0, checkpoint_dir=ck, device="cpu")
    svc.open_session("a")
    svc.shutdown()
    path = os.path.join(ck, "sessions.jsonl")
    with open(path) as fh:
        text = fh.read().replace('"rows": 8', '"rows": 9')
    with open(path, "w") as fh:
        fh.write(text)
    with pytest.raises(CheckpointMismatch, match="leases 9 rows"):
        ReservoirService.recover(ck, device="cpu")


def test_small_soak_open_ingest_snapshot_evict_reopen(tmp_path):
    """The JAX package's soak at 128 sessions: every row's samples lie in
    its own session's range, recycled sessions equal the JAX service's, and
    recovery after a kill restores the table and the snapshots."""
    S, k, per = 128, 2, 6
    ck = str(tmp_path / "ck")
    cfg = dict(num_reservoirs=S, max_sample_size=k, tile_size=8)
    services = (JService(JConfig(**_kw(**cfg)), key=77, coalesce_bytes=1 << 14),
                ReservoirService(SamplerConfig(**_kw(**cfg)), key=77, checkpoint_dir=ck, checkpoint_every=8,
                                 coalesce_bytes=1 << 14, device="cpu"))  # pipelined, as the JAX soak
    rng = np.random.default_rng(7)

    def feed(key, i):
        elems = (i * 1000 + rng.integers(0, 1000, per)).astype(np.int64)
        for svc in services:
            svc.ingest(key, elems)

    for i in range(S):
        for svc in services:
            svc.open_session(f"u{i}")
        feed(f"u{i}", i)
    services[1].sync()
    samples, sizes = services[1].bridge.engine.peek_arrays()
    owner = np.repeat(np.arange(S), k).reshape(S, k)
    valid = np.arange(k)[None, :] < sizes[:, None]
    assert np.all((samples // 1000 == owner) | ~valid)
    churn = [f"v{i}" for i in range(16)]
    for i in range(16):
        for svc in services:
            svc.close_session(f"u{i}")
    for key in churn:
        for svc in services:
            svc.open_session(key)
    for i, key in enumerate(churn):
        feed(key, S + i)
    assert services[1].metrics.recycles == 16
    probe = list(dict.fromkeys([f"v{i}" for i in rng.integers(0, 16, 8)] +
                               [f"u{i}" for i in rng.integers(16, S, 8)]))
    want = {key: _both(services, lambda s: s.snapshot(key)) for key in probe}
    leases = {s.key: (s.row, s.generation) for s in services[1].table.sessions()}
    seq = services[1].sync()
    del services
    gc.collect()
    rec = ReservoirService.recover(ck, device="cpu")
    assert rec.flushed_seq == seq and rec.metrics.sessions_open == S
    assert {s.key: (s.row, s.generation) for s in rec.table.sessions()} == leases
    for key, w in want.items():
        np.testing.assert_array_equal(rec.snapshot(key), w, err_msg=key)
