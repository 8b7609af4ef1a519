"""The port's sharded serving plane (``shard_of``, ``ShardUnit``,
``ShardedReservoirService``) against the JAX package's, on the CPU: the
cases of ``tests/test_cluster.py`` and the shard fault cases of
``tests/test_faults.py``, each held against a JAX cluster given the same
seed and calls.

- ``shard_of`` equals the JAX route over many keys, shard counts and
  routing epochs;
- ``routing.jsonl``, every snapshot and ``merged_snapshot`` equal the JAX
  cluster's bit for bit, through migrations, kills, fences, promotions and
  recovery; ``merged_snapshot()`` over CPU ranks equals the JAX host merge
  and the port's ``device="host"`` tree;
- without a card, every default placement raises (``StandbyReplica``,
  ``ShardUnit``, ``ShardedReservoirService``, ``devices="spread"``,
  ``merged_snapshot(device="cuda")``): none carries on on the CPU;
- the ``shard.route`` and ``shard.promote`` faults;
- a small chaos soak of kills, fences, promotions, recoveries and
  migrations, after every cycle equal to the JAX cluster.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu.errors import ShardUnavailable as JShardUnavailable
from reservoir_tpu.serve import ShardedReservoirService as JCluster
from reservoir_tpu.serve import shard_of as j_shard_of
from reservoir_tpu.utils import faults as jfaults
from reservoir_tpu.utils.faults import FaultPlane as JFaultPlane
from reservoir_tpu.utils.faults import FaultRule as JFaultRule
from reservoir_tpu_torch import SamplerConfig
from reservoir_tpu_torch.errors import (
    FencedError,
    SessionIngestError,
    ShardUnavailable,
    TransientDeviceError,
)
from reservoir_tpu_torch.serve import ShardedReservoirService, ShardUnit, StandbyReplica, shard_of
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """No global fault plane in either package, and a throwaway knob cache."""
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _kw(mode="plain", **kw):
    kw.setdefault("max_sample_size", 3)
    kw.setdefault("num_reservoirs", 4)
    kw.setdefault("tile_size", 8)
    return dict(distinct=mode == "distinct", weighted=mode == "weighted", **kw)


class _Twin:
    """A JAX cluster and the port's (its shards on the CPU), given the same
    calls; each call returns the port's result after checking that the JAX
    cluster returned the same (arrays as bytes) or raised the same."""

    def __init__(self, tmp_path, n_shards, mode="plain", cfg=None, jfaults_=None, tfaults=None, **kw):
        kw.setdefault("coalesce_bytes", 64)
        kw.setdefault("pipelined", False)
        cfg = _kw(mode, **(cfg or {}))
        self.jdir, self.tdir = str(tmp_path / "jax"), str(tmp_path / "port")
        self.kw = kw
        self.j = JCluster(JConfig(**cfg), n_shards, self.jdir, faults=jfaults_, **kw)
        self.t = ShardedReservoirService(SamplerConfig(**cfg), n_shards, self.tdir, faults=tfaults,
                                         devices=["cpu"] * n_shards, **kw)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            try:
                want = getattr(self.j, name)(*args, **kwargs)
            except Exception as e:  # the port must raise the same class
                with pytest.raises(Exception) as got:
                    getattr(self.t, name)(*args, **kwargs)
                assert type(got.value).__name__ == type(e).__name__, (got.value, e)
                raise got.value
            got = getattr(self.t, name)(*args, **kwargs)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(np.asarray(got).view(np.uint8), want.view(np.uint8))
            return got

        return call

    def routing_equal(self):
        paths = [os.path.join(d, "routing.jsonl") for d in (self.jdir, self.tdir)]
        j, t = (open(p, "rb").read() for p in paths)
        assert j == t
        return [json.loads(line) for line in t.decode().splitlines() if line.strip()]

    def snapshots_equal(self):
        """Every live session on every live shard: the same keys, routes and
        samples in both clusters."""
        n = 0
        for ju, tu in zip(self.j.units, self.t.units):
            assert ju.alive == tu.alive
            if not tu.alive:
                continue
            keys = sorted(s.key for s in tu.table.sessions())
            assert keys == sorted(s.key for s in ju.table.sessions())
            for key in keys:
                np.testing.assert_array_equal(tu.service.snapshot(key).view(np.uint8),
                                              ju.service.snapshot(key).view(np.uint8))
                assert tu.table.route(key).elements == ju.table.route(key).elements
                n += 1
        return n

    def shutdown(self):
        self.j.shutdown()
        self.t.shutdown()


def _key_for_shard(cluster, shard, prefix="k"):
    for i in range(10_000):
        key = f"{prefix}{i}"
        if cluster.shard_of(key) == shard:
            return key
    raise AssertionError("no key found for the shard")


# ---------------------------------------------------------------- routing


def test_shard_of_equals_the_jax_route_over_many_keys_and_epochs():
    keys = [f"s{i}" for i in range(2_000)] + ["", "ключ", "a:b", "x" * 300]
    for n in (1, 3, 4, 7):
        for epoch in range(4):
            routes = [shard_of(k, n, epoch) for k in keys]
            assert routes == [j_shard_of(k, n, epoch) for k in keys]
            assert set(routes) == set(range(n))


def test_routing_journal_and_snapshots_equal_a_jax_cluster(tmp_path):
    twin = _Twin(tmp_path, 4, key=3, routing_epoch=2)
    rng = np.random.default_rng(0)
    keys = [f"s{i}" for i in range(12)]
    for k in keys:
        twin.open_session(k)
        twin.ingest(k, rng.integers(0, 1 << 20, int(rng.integers(5, 40))).astype(np.int32))
    twin.sync()
    recs = twin.routing_equal()
    assert recs[0] == {"op": "base", "v": 1, "shards": 4, "routing_epoch": 2, "key": 3}
    assert {r["key"]: r["shard"] for r in recs[1:]} == {k: shard_of(k, 4, 2) for k in keys}
    assert twin.snapshots_equal() == 12
    # migrations: no stale read, the override journaled, the same in both
    for k in keys[:4]:
        before = twin.snapshot(k)
        dst = (twin.t.shard_of(k) + 1) % 4
        twin.migrate(k, dst)
        assert twin.t.shard_of(k) == dst
        np.testing.assert_array_equal(twin.snapshot(k), before)
        twin.ingest(k, rng.integers(0, 1 << 20, 9).astype(np.int32))
    twin.sync()
    assert [r["op"] for r in twin.routing_equal()[-4:]] == ["migrate"] * 4
    assert twin.snapshots_equal() == 12
    twin.merged_snapshot(keys, merge_key=17)
    twin.shutdown()


def test_recover_re_routes_identically_and_tolerates_a_torn_tail(tmp_path):
    twin = _Twin(tmp_path, 3, key=11)
    fed = {}
    for i in range(6):
        k = f"s{i}"
        twin.open_session(k)
        fed[k] = (100 * (i + 1) + np.arange(20)).astype(np.int32)
        twin.ingest(k, fed[k])
    twin.migrate("s0", (twin.t.shard_of("s0") + 1) % 3)
    twin.sync()
    want = {k: twin.snapshot(k) for k in fed}
    routes = {k: twin.t.shard_of(k) for k in fed}
    twin.shutdown()
    for d in (twin.jdir, twin.tdir):  # a crash mid-append
        with open(os.path.join(d, "routing.jsonl"), "a") as fh:
            fh.write('{"op": "route", "key": "s9", "sh')
    jrec = JCluster.recover(twin.jdir, pipelined=False)
    rec = ShardedReservoirService.recover(twin.tdir, devices=["cpu"] * 3, pipelined=False)
    for k in fed:
        assert rec.shard_of(k) == jrec.shard_of(k) == routes[k]
        np.testing.assert_array_equal(rec.snapshot(k), want[k])
        assert (rec.unit(routes[k]).table.route(k).elements
                == jrec.unit(routes[k]).table.route(k).elements)
    # a migrated session's count comes back from its migrate record
    assert rec.unit(routes["s0"]).table.route("s0").elements == len(fed["s0"])
    rec.ingest("s1", np.arange(8, dtype=np.int32))  # serving and journaling
    rec.sync()
    rec.shutdown()
    jrec.shutdown()
    # a route record that disagrees with the hash is a hard error
    bad = str(tmp_path / "bad")
    cl = ShardedReservoirService(SamplerConfig(**_kw()), 3, bad, key=11, devices=["cpu"] * 3)
    cl.open_session("x1")
    cl.sync()
    cl.shutdown()
    with open(os.path.join(bad, "routing.jsonl"), "a") as fh:
        fh.write(json.dumps({"op": "route", "key": "x1", "shard": (shard_of("x1", 3) + 1) % 3}))
        fh.write('\n{"op": "pad"}\n')
    with pytest.raises(ValueError, match="diverged|unknown op"):
        ShardedReservoirService.recover(bad, devices=["cpu"] * 3)


# ---------------------------------------------------------- partial failure


def test_a_killed_shard_rejects_only_its_sessions_and_its_standby_takes_over(tmp_path):
    twin = _Twin(tmp_path, 3, key=5)
    keys = [f"s{i}" for i in range(9)]
    for k in keys:
        twin.open_session(k)
        twin.ingest(k, np.arange(16, dtype=np.int32))
    twin.sync()
    twin.poll()
    victim = twin.t.shard_of(keys[0])
    victims = [k for k in keys if twin.t.shard_of(k) == victim]
    others = [k for k in keys if twin.t.shard_of(k) != victim]
    before = {k: twin.snapshot(k) for k in keys}
    twin.j.kill_shard(victim)
    zombie = twin.t.kill_shard(victim)
    for k in victims:
        with pytest.raises(ShardUnavailable) as ei:
            twin.ingest(k, np.arange(8, dtype=np.int32))
        assert ei.value.shard == victim and ei.value.retry_after_s > 0 and ei.value.reason == "killed"
    for k in others:  # every other shard serves reads and writes
        twin.ingest(k, np.arange(8, dtype=np.int32))
        assert twin.snapshot(k).size > 0
    twin.promote_shard(victim, reason="chaos kill")
    journal = os.path.join(twin.t.shard_dir(victim), "journal.bin")
    journal_before = open(journal, "rb").read()
    with pytest.raises(FencedError):
        zombie.sync()
    with pytest.raises(FencedError):
        zombie.ingest(victims[0], np.arange(64, dtype=np.int32))
        zombie.sync()
    assert open(journal, "rb").read() == journal_before
    for k in victims:
        np.testing.assert_array_equal(twin.snapshot(k), before[k])
        twin.ingest(k, np.arange(8, dtype=np.int32))
    twin.sync()
    assert twin.snapshots_equal() == 9
    twin.shutdown()


def test_a_fenced_shard_is_marked_down_alone_and_recovers_by_promotion(tmp_path):
    twin = _Twin(tmp_path, 2, key=9)
    a, b = _key_for_shard(twin.t, 0, "a"), _key_for_shard(twin.t, 1, "b")
    for k in (a, b):
        twin.open_session(k)
        twin.ingest(k, np.arange(24, dtype=np.int32))
    twin.sync()
    twin.poll()
    want_a = twin.snapshot(a)
    twin.fence_shard(0)
    with pytest.raises(ShardUnavailable) as ei:
        twin.ingest(a, np.arange(64, dtype=np.int32))
    assert ei.value.shard == 0 and ei.value.reason == "fenced"
    assert not twin.t.unit(0).alive
    twin.ingest(b, np.arange(8, dtype=np.int32))
    assert set(twin.sync()) == {1}
    twin.promote_shard(0, reason="fence trip")
    np.testing.assert_array_equal(twin.snapshot(a), want_a)
    assert twin.snapshots_equal() == 2
    twin.shutdown()


def test_a_killed_shard_without_a_standby_recovers_in_place(tmp_path):
    twin = _Twin(tmp_path, 2, key=13, standby=False)
    k0 = _key_for_shard(twin.t, 0, "r")
    twin.open_session(k0)
    twin.ingest(k0, np.arange(30, dtype=np.int32))
    twin.sync()
    want = twin.snapshot(k0)
    twin.j.kill_shard(0)
    twin.t.kill_shard(0)
    with pytest.raises(ShardUnavailable):
        twin.snapshot(k0)
    assert twin.t.unit(0).standby is None
    twin.recover_shard(0)
    assert twin.t.unit(0).service.device == torch.device("cpu")
    np.testing.assert_array_equal(twin.snapshot(k0), want)
    twin.shutdown()


def test_cluster_heartbeat_equals_the_jax_clusters_apart_from_its_timestamp(tmp_path):
    twin = _Twin(tmp_path, 3, key=2)
    for i in range(6):
        twin.open_session(f"s{i}")
        twin.ingest(f"s{i}", np.arange(8, dtype=np.int32))
    twin.sync()
    for kill in (False, True):
        if kill:
            twin.j.kill_shard(1)
            twin.t.kill_shard(1)
        beats = [twin.j.beat(), twin.t.beat()]
        files = [json.load(open(os.path.join(d, "heartbeat.json"))) for d in (twin.jdir, twin.tdir)]
        for p in beats + files:
            p.pop("ts")
        assert beats[0] == beats[1] == files[0] == files[1]
        assert beats[1]["worst"] == ("page" if kill else "ok")
    twin.shutdown()


# --------------------------------------------------------- merged snapshots


def test_merged_snapshot_equals_the_jax_host_merge(tmp_path):
    twin = _Twin(tmp_path, 3, key=21)
    rng = np.random.default_rng(0)
    keys = [f"m{i}" for i in range(6)]
    for i, k in enumerate(keys):
        twin.open_session(k)
        twin.ingest(k, rng.integers(0, 1 << 20, 10 + 5 * i).astype(np.int32))
    twin.sync()
    assert len({twin.t.shard_of(k) for k in keys}) > 1
    for merge_key in (17, 4):
        for group in (keys, keys[:1], keys[1:4], keys[::-1]):
            # the port's default, the merge over the shards' devices as
            # ranks (here CPU ranks), against the JAX host merge
            got = twin.merged_snapshot(group, merge_key=merge_key)
            np.testing.assert_array_equal(
                twin.t.merged_snapshot(group, merge_key=merge_key, device="host"), got)
    for impl in ("xla", "pallas", "auto"):
        with pytest.raises(ValueError, match="'cuda' \\(the same, card ranks only\\) or 'host'"):
            twin.t.merged_snapshot(keys, device=impl)
    with pytest.raises(ValueError, match="needs CUDA ranks"):
        twin.t.merged_snapshot(keys, device="cuda")
    twin.shutdown()
    weighted = ShardedReservoirService(SamplerConfig(**_kw("weighted")), 2, str(tmp_path / "w"), key=1,
                                       devices=["cpu"] * 2)
    weighted.open_session("a")
    weighted.ingest("a", np.arange(4, dtype=np.int32), weights=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="uniform-mode only"):
        weighted.merged_snapshot(["a"])
    weighted.shutdown()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise of a host without a card")
def test_without_a_card_every_default_placement_raises(tmp_path):
    cfg = SamplerConfig(**_kw())
    ck = str(tmp_path / "ck")
    cluster = ShardedReservoirService(cfg, 2, ck, key=1, devices=["cpu"] * 2)
    cluster.open_session("a")
    cluster.ingest("a", np.arange(8, dtype=np.int32))
    cluster.sync()
    for make in (
        lambda: StandbyReplica(cluster.shard_dir(cluster.shard_of("a"))),
        lambda: ShardUnit(cfg, 0, str(tmp_path / "unit"), key=1),
        lambda: ShardedReservoirService(cfg, 2, str(tmp_path / "default"), key=1),
        lambda: ShardedReservoirService(cfg, 2, str(tmp_path / "spread"), key=1, devices="spread"),
        lambda: ShardedReservoirService.recover(ck),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="needs CUDA ranks"):
        cluster.merged_snapshot(["a"], device="cuda")
    with pytest.raises(ValueError, match="devices= accepts"):
        ShardedReservoirService(cfg, 2, str(tmp_path / "bad"), devices="everywhere")
    cluster.shutdown()


# --------------------------------------------------------------- the faults


def test_shard_route_fault_is_typed_and_the_cluster_stays_live(tmp_path):
    plane = FaultPlane([FaultRule("shard.route", exc=TransientDeviceError, after=2, times=1,
                                  message="injected route fault")])
    cluster = ShardedReservoirService(SamplerConfig(**_kw()), 2, str(tmp_path / "cl"), key=7,
                                      faults=plane, devices=["cpu"] * 2)
    cluster.open_session("a")  # hit 0
    cluster.open_session("b")  # hit 1
    with pytest.raises(SessionIngestError, match="shard routing") as ei:
        cluster.ingest("a", np.arange(8, dtype=np.int32))  # hit 2: injected
    assert isinstance(ei.value.__cause__, TransientDeviceError)
    shard_a = cluster.shard_of("a")
    cluster.ingest("a", np.arange(8, dtype=np.int32))
    cluster.ingest("b", np.arange(8, dtype=np.int32))
    assert cluster.shard_of("a") == shard_a
    assert cluster.snapshot("a").size > 0 and cluster.snapshot("b").size > 0
    assert plane.hits()["shard.route"] >= 3
    cluster.shutdown()


def test_shard_promote_fault_leaves_the_standby_unpromoted_and_retryable(tmp_path):
    plane = FaultPlane([FaultRule("shard.promote", exc=TransientDeviceError, times=1)])
    cluster = ShardedReservoirService(SamplerConfig(**_kw()), 2, str(tmp_path / "cl"), key=8,
                                      faults=plane, devices=["cpu"] * 2)
    cluster.open_session("a")
    cluster.ingest("a", np.arange(24, dtype=np.int32))
    cluster.sync()
    cluster.poll()
    want = cluster.snapshot("a")
    victim = cluster.shard_of("a")
    unit = cluster.unit(victim)
    epoch_before = unit.epoch
    cluster.kill_shard(victim)
    with pytest.raises(TransientDeviceError):
        cluster.promote_shard(victim)
    assert not unit.alive and unit.epoch == epoch_before
    assert unit.standby is not None and not unit.standby.is_promoted
    cluster.promote_shard(victim)
    assert unit.alive and unit.epoch == epoch_before + 1
    np.testing.assert_array_equal(cluster.snapshot("a"), want)
    cluster.shutdown()


# --------------------------------------------------------------- chaos soak


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_chaos_soak_equals_the_jax_cluster_after_every_cycle(tmp_path, gated):
    """Four cycles on three shards: traffic (opens that recycle rows,
    ingests, closes), a migration, then one of kill-and-promote,
    fence-and-promote, kill-and-recover and a second migration on a chosen
    shard, under faults at ``shard.promote`` and ``replica.ship`` in both
    packages.  After every cycle, both clusters hold the same sessions on
    the same shards with the same samples, and their routing journals are
    byte-equal."""
    rules = [("shard.promote", dict(after=1, every=3)), ("replica.ship", dict(after=3, every=11))]
    jplane = JFaultPlane([JFaultRule(s, exc=TransientDeviceError, **kw) for s, kw in rules], seed=5)
    tplane = FaultPlane([FaultRule(s, exc=TransientDeviceError, **kw) for s, kw in rules], seed=5)
    twin = _Twin(tmp_path, 3, key=31, cfg=dict(num_reservoirs=3), jfaults_=jplane, tfaults=tplane,
                 gated=gated)
    rng = np.random.default_rng(31)
    live, next_id = [], 0
    for cycle, lever in enumerate(("kill", "fence", "recover", "migrate")):
        for _ in range(10):
            op = rng.random()
            if op < 0.3 or not live:
                key = f"c{next_id}"
                next_id += 1
                try:
                    twin.open_session(key)
                except (ShardUnavailable, JShardUnavailable):
                    continue
                live.append(key)
            elif op < 0.85:
                key = live[int(rng.integers(len(live)))]
                n = int(rng.integers(1, 20))
                twin.ingest(key, ((int(key[1:]) + 1) * 10_000 + rng.integers(0, 5000, n)).astype(np.int32))
            else:
                twin.close_session(live.pop(int(rng.integers(len(live)))))
            live = [k for k in live if any(k in u.table for u in twin.t.units if u.alive)]
        twin.sync()
        twin.poll()
        key = live[0]
        twin.migrate(key, (twin.t.shard_of(key) + 1) % 3)
        victim = cycle % 3
        if lever in ("kill", "recover"):
            twin.j.kill_shard(victim)
            twin.t.kill_shard(victim)
        elif lever == "fence":
            twin.fence_shard(victim)
            twin.sync()  # the fenced primary trips and is marked down
        if lever in ("kill", "fence"):
            for _ in range(6):
                try:
                    twin.promote_shard(victim, reason=lever)
                    break
                except TransientDeviceError:
                    continue
        elif lever == "recover":
            twin.j.recover_shard(victim, pipelined=False)
            twin.t.recover_shard(victim, pipelined=False)
        else:
            key = live[-1]
            twin.migrate(key, (twin.t.shard_of(key) + 2) % 3)
        assert all(u.alive for u in twin.t.units)
        assert twin.snapshots_equal() == len(live)
        twin.routing_equal()
    for site, _ in rules:
        assert tplane.hits()[site] == jplane.hits()[site] > 0
    twin.shutdown()
