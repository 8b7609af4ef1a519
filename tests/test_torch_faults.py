"""The port's fault plane against the JAX package's: every registered site
is crossed by one CPU run of the port (the all-sites sweep of
``tests/test_faults.py``), the engine's ``engine.update`` site fires where
the reference's does and a bridge retries a transient engine failure as the
JAX bridge does, and the latency attribution of a trace, or of a flight
bundle, defaults to the reference's root."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.errors import RetryPolicy as JRetryPolicy
from reservoir_tpu.errors import TransientDeviceError as JTransient
from reservoir_tpu.obs import flight as jflight
from reservoir_tpu.obs import trace as jtrace
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu.utils import faults as jfaults
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.errors import RetryPolicy, TransientDeviceError
from reservoir_tpu_torch.obs import flight, trace
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule


@pytest.fixture(autouse=True)
def _no_global_plane():
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _kw(**kw):
    kw.setdefault("max_sample_size", 4)
    kw.setdefault("num_reservoirs", 2)
    kw.setdefault("tile_size", 8)
    return kw


def test_all_sites_exercised(tmp_path):
    # a rule-free global plane counts hits without raising: one bridge
    # stream with checkpoints, one service ingest, a standby's poll and a
    # heartbeat, a cluster's route and a shard promotion cross every site
    from reservoir_tpu_torch.serve import (HeartbeatWriter, ReservoirService,
                                           ShardedReservoirService, StandbyReplica)

    cfg = SamplerConfig(**_kw())
    with faults.active(FaultPlane()) as plane:
        bridge = DeviceStreamBridge(cfg, key=3, checkpoint_dir=str(tmp_path / "ck"),
                                    checkpoint_every=2, device="cpu")
        bridge.push(0, np.arange(32, dtype=np.int32))
        bridge.push_interleaved(np.zeros(8, np.int32), np.arange(8, dtype=np.int32))
        bridge.complete()
        ha_dir = str(tmp_path / "ha")
        svc = ReservoirService(cfg, key=0, checkpoint_dir=ha_dir, device="cpu")
        svc.open_session("s")
        svc.ingest("s", np.arange(4, dtype=np.int32))
        svc.sync()
        standby = StandbyReplica(ha_dir, device="cpu")
        standby.poll()
        HeartbeatWriter(ha_dir, service=svc).beat()
        cluster = ShardedReservoirService(cfg, 2, str(tmp_path / "cl"), key=1, devices=["cpu"] * 2)
        cluster.open_session("t")
        cluster.ingest("t", np.arange(4, dtype=np.int32))
        cluster.sync()
        cluster.poll()
        victim = cluster.shard_of("t")
        cluster.kill_shard(victim)
        cluster.promote_shard(victim)
        cluster.shutdown()
        svc.shutdown()
        hits = plane.hits()
    # the sweep's coverage, by name: the registry holds these and no other
    swept = ("bridge.dispatch", "bridge.demux", "engine.update", "checkpoint.write",
             "native.staging", "serve.ingest", "replica.ship", "replica.apply",
             "ha.heartbeat", "shard.route", "shard.promote")
    assert sorted(faults.SITES) == sorted(swept)
    for site in swept:
        assert hits.get(site, 0) >= 1, (site, hits)


def test_static_site_inventory_matches_runtime_sweep():
    """The port's lint reads the same registry as the sweep above: every
    site has a call site in the package, and the scan knows no other."""
    from reservoir_tpu_torch.analysis import site_inventory

    inv = site_inventory()
    assert set(inv) == set(faults.SITES)
    assert not sorted(s for s, where in inv.items() if not where)


def test_engine_update_is_a_site_and_its_spec_parses_as_in_the_jax_package():
    assert "engine.update" in faults.SITES and "engine.update" in jfaults.SITES
    spec = "seed=5;engine.update:exc=none,delay=0.0;engine.update:exc=TransientDeviceError,after=2,times=1"
    got, want = faults.from_spec(spec), jfaults.from_spec(spec)
    assert got._rng.random() == want._rng.random()  # the same seed

    def rules(plane):
        return [(r.site, None if r.exc is None else r.exc.__name__,
                 {f.name: getattr(r, f.name) for f in dataclasses.fields(r) if f.name not in ("site", "exc")})
                for rs in plane._rules.values() for r in rs]

    assert rules(got) == rules(want)


def _drive(engine, gated_tile):
    """sample, sample_gated, an unfused stream of 2.5 tiles and a fused
    one: ``engine.update``'s hits after each."""
    R, B = 2, 8
    seen = []
    engine.sample(np.arange(R * B, dtype=np.int32).reshape(R, B))
    seen.append(engine._faults.hits()["engine.update"])
    tile, nvalid, advance = gated_tile
    engine.sample_gated(tile, nvalid, advance)
    seen.append(engine._faults.hits()["engine.update"])
    stream = np.arange(R * 20, dtype=np.int32).reshape(R, 20)
    engine.sample_stream(stream)
    seen.append(engine._faults.hits()["engine.update"])
    engine.sample_stream(stream, fused=True)
    seen.append(engine._faults.hits()["engine.update"])
    return seen


def test_engine_update_fires_where_the_reference_fires():
    gated = (np.full((2, 4), 9, np.int32), np.array([4, 2], np.int32), np.array([4, 2], np.int32))
    port = ReservoirEngine(SamplerConfig(**_kw()), key=0, reusable=True, device="cpu", faults=FaultPlane())
    ref = JEngine(JConfig(**_kw()), key=0, reusable=True, faults=jfaults.FaultPlane())
    got, want = _drive(port, gated), _drive(ref, gated)
    # one a tile update: 1 + 1 + 3 tiles unfused + (the fused pair, the tail)
    assert got == want == [1, 2, 5, 7]
    np.testing.assert_array_equal(port.peek_arrays()[0], np.asarray(ref.result_arrays()[0]))


def test_engine_update_failure_leaves_the_state_untouched():
    plane = FaultPlane([FaultRule("engine.update", exc=TransientDeviceError, after=1, times=1)])
    faulty = ReservoirEngine(SamplerConfig(**_kw()), key=4, reusable=True, device="cpu", faults=plane)
    clean = ReservoirEngine(SamplerConfig(**_kw()), key=4, reusable=True, device="cpu")
    tiles = [np.arange(16, dtype=np.int32).reshape(2, 8) + 16 * t for t in range(3)]
    for t in tiles:
        clean.sample(t)
        try:
            faulty.sample(t)
        except TransientDeviceError:
            faulty.sample(t)  # the failed call changed nothing: feed it again
    assert plane.hits()["engine.update"] == 4
    for a, b in zip(faulty.peek_arrays(), clean.peek_arrays()):
        np.testing.assert_array_equal(a, b)


def test_bridge_retries_a_transient_engine_failure_as_the_jax_bridge_does():
    data = np.random.default_rng(8).integers(0, 1 << 30, (2, 40)).astype(np.int32)
    bridges = {}
    for name, cls, cfg, plane, rule, policy, exc in (
        ("port", DeviceStreamBridge, SamplerConfig(**_kw()), FaultPlane, FaultRule, RetryPolicy,
         TransientDeviceError),
        ("jax", JBridge, JConfig(**_kw()), jfaults.FaultPlane, jfaults.FaultRule, JRetryPolicy, JTransient),
    ):
        kw = {"device": "cpu"} if name == "port" else {}
        fp = plane([rule("engine.update", exc=exc, after=1, every=2, times=2)])
        bridge = cls(cfg, key=6, faults=fp, retry_policy=policy(max_retries=3, base_backoff_s=0.001), **kw)
        for s in range(2):
            bridge.push(s, data[s])
        bridges[name] = (bridge.complete(), bridge.metrics, fp.hits())
    (got, gm, gh), (want, wm, wh) = bridges["port"], bridges["jax"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert gm.retries == wm.retries == 2 and gm.failures == wm.failures == 0
    assert gh["engine.update"] == wh["engine.update"]


def _spans(mod, seed: int):
    """One seeded mix of service-rooted and bridge-rooted traces, recorded
    by ``mod``'s tracer under an injected clock."""
    rng = np.random.default_rng(seed)
    now = [0.0]

    def clock():
        now[0] += float(rng.uniform(1e-4, 1e-2))
        return now[0]

    tr = mod.Tracer(sample_every=1, clock=clock, wall=lambda: 1.0e9)
    for i in range(12):
        root = "serve.ingest" if i % 3 else "bridge.dispatch"
        with tr.span(root, key=i, session=f"s{i}"):
            with tr.span("bridge.queue"):
                pass
            if i % 2:
                with tr.span("bridge.journal", flush_seq=i):
                    pass
            with tr.span("engine.update"):
                pass
    return tr


def test_attribution_defaults_to_the_reference_root():
    got = trace.attribution(_spans(trace, 3).spans())
    want = jtrace.attribution(_spans(jtrace, 3).spans())
    assert got["root"] == want["root"] == "serve.ingest"
    assert got == want
    # the bridge's own root, asked for by name, agrees too
    assert trace.attribution(_spans(trace, 3).spans(), root="bridge.dispatch") == \
        jtrace.attribution(_spans(jtrace, 3).spans(), root="bridge.dispatch")


def test_flight_bundle_attribution_defaults_to_the_reference_root(tmp_path):
    bundles = []
    for mod, fmod, sub in ((trace, flight, "port"), (jtrace, jflight, "jax")):
        with mod.active(_spans(mod, 4)):
            recorder = fmod.FlightRecorder(str(tmp_path / sub))
            bundles.append(fmod.read_bundle(recorder.dump("probe")))
    got, want = bundles
    assert got["attribution"]["root"] == "serve.ingest"
    assert got["attribution"] == want["attribution"]
