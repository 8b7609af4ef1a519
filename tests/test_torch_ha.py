"""The port's HA plane (``JournalFollower``, ``StandbyReplica``,
``HeartbeatWriter``, ``FailoverController``) against the JAX package's, on
the CPU: the cases of ``tests/test_ha.py`` and the HA fault cases of
``tests/test_faults.py``, each held against the JAX package fed the same
calls.

- the followers of both packages read the same journal alike: a torn tail,
  a rotation, a rotation that keeps the file's size, and a gap;
- a standby equals its primary bit for bit after every poll, in the three
  modes and gated, and across the packages: a checkpoint directory written
  by the JAX primary and tailed by the port's standby equals the JAX
  standby, and one written by the port's primary and tailed by the JAX
  standby equals the port's;
- ``promote`` fences the old primary without changing the journal, and is
  refused while the tail cannot be read;
- the controller's verdicts and trigger tags under an injected clock, and
  ``heartbeat.json`` apart from its timestamp, equal the JAX package's;
- a small chaos soak of kills, promotions and re-follows under faults at
  the three HA sites equals an uninterrupted JAX service.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu import errors as jerrors
from reservoir_tpu.serve import FailoverController as JController
from reservoir_tpu.serve import HeartbeatWriter as JHeartbeat
from reservoir_tpu.serve import JournalFollower as JFollower
from reservoir_tpu.serve import ReservoirService as JService
from reservoir_tpu.serve import StandbyReplica as JStandby
from reservoir_tpu.serve import read_heartbeat as j_read_heartbeat
from reservoir_tpu.utils import faults as jfaults
from reservoir_tpu_torch import SamplerConfig
from reservoir_tpu_torch.errors import CheckpointMismatch, FencedError, TransientDeviceError
from reservoir_tpu_torch.serve import (
    FailoverController,
    HeartbeatWriter,
    JournalFollower,
    ReservoirService,
    StandbyReplica,
    read_heartbeat,
)
from reservoir_tpu_torch.stream.bridge import _FlushJournal
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule

MODES = ["plain", "weighted", "distinct", "gated"]


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


def _primaries(mode, ck_jax, ck_port, key, cfg=None, **kw):
    """A JAX primary and the port's (on the CPU) with their checkpoint
    directories, built alike; serial bridges, so that both flush at the
    same calls and their journals hold the same frames."""
    kw.setdefault("pipelined", False)
    kw.setdefault("checkpoint_every", 1000)
    kw.setdefault("coalesce_bytes", 64)
    gated = mode == "gated"
    cfg = _kw(mode, **(cfg or {}))
    return (
        JService(JConfig(**cfg), key=key, checkpoint_dir=ck_jax, gated=gated, **kw),
        ReservoirService(SamplerConfig(**cfg), key=key, checkpoint_dir=ck_port, gated=gated,
                         device="cpu", **kw),
    )


def _journal_bytes(ckdir: str) -> bytes:
    path = os.path.join(ckdir, "journal.bin")
    return open(path, "rb").read() if os.path.exists(path) else b""


def _ingest(services, key, rng, mode, n):
    elems = (1000 * (1 + int(key[1:])) + rng.integers(0, 500, n)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32) if mode == "weighted" else None
    for s in services:
        s.ingest(key, elems, weights=w)


def _equal(arrays):
    for a in arrays[1:]:
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(arrays[0]).view(np.uint8))


def _engines_equal(*holders):
    """Every holder's engine state (samples and sizes), equal as bytes."""
    got = [h.bridge.engine.peek_arrays() for h in holders]
    _equal([g[0] for g in got])
    _equal([g[1] for g in got])


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# --------------------------------------------------------- journal follower


def _poll_view(result):
    records, rotated, gap = result
    return [(end, seq, tile.tobytes(), valid.tobytes()) for end, seq, tile, valid, _, _ in records], rotated, gap


def _both_poll(followers):
    """Poll the JAX follower and the port's; both see the same; acknowledge
    every record read on both."""
    views = [f.poll() for f in followers]
    assert _poll_view(views[0]) == _poll_view(views[1])
    for f in followers:
        for end, seq, *_ in views[1][0]:
            f.advance(seq, end)
    return views[1]


def test_follower_tails_torn_tails_rotations_and_gaps_as_the_jax_follower(tmp_path):
    path = str(tmp_path / "journal.bin")
    S, B = 2, 4
    journal = _FlushJournal(path, S, B, np.int32, weighted=False)

    def rec(seq):
        return np.full((S, B), seq, np.int32), np.full(S, B, np.int32), None

    for seq in (1, 2):
        journal.append(seq, *rec(seq))
    followers = [JFollower(path, S, B, np.int32, False), JournalFollower(path, S, B, np.int32, False)]
    records, rotated, gap = _both_poll(followers)
    assert [r[1] for r in records] == [1, 2] and not rotated and not gap
    for end, seq, tile, *_ in records:
        np.testing.assert_array_equal(tile, rec(seq)[0])
    assert _both_poll(followers) == ([], False, False)  # caught up
    journal.append(3, *rec(3))
    assert [r[1] for r in _both_poll(followers)[0]] == [3]
    # a torn tail (the primary mid-append): read again, the cursor holds
    full = os.path.getsize(path)
    journal.append(4, *rec(4))
    with open(path, "r+b") as fh:
        fh.truncate(full + 9)
    assert _both_poll(followers) == ([], False, False)
    journal.close()
    journal = _FlushJournal(path, S, B, np.int32, weighted=False)
    with open(path, "r+b") as fh:
        fh.truncate(full)
    journal.append(4, *rec(4))
    assert [r[1] for r in _both_poll(followers)[0]] == [4]
    # rotation: truncated, then the next seq: rescanned from byte 0, no gap
    journal.rotate()
    journal.append(5, *rec(5))
    records, rotated, gap = _both_poll(followers)
    assert [r[1] for r in records] == [5] and rotated and not gap
    # a rotation that dropped a record never seen: a gap
    journal.rotate()
    journal.append(7, *rec(7))
    assert _both_poll(followers)[0] == [] and followers[1].poll()[2]
    journal.close()


def test_follower_detects_a_rotation_that_keeps_the_size(tmp_path):
    path = str(tmp_path / "journal.bin")
    S, B = 2, 4
    journal = _FlushJournal(path, S, B, np.int32, weighted=False)
    tile, valid = np.ones((S, B), np.int32), np.full(S, B, np.int32)
    journal.append(1, tile, valid, None)
    followers = [JFollower(path, S, B, np.int32, False), JournalFollower(path, S, B, np.int32, False)]
    _both_poll(followers)
    journal.rotate()
    journal.append(3, tile, valid, None)  # the same size, seq 2 lost
    records, rotated, gap = _both_poll(followers)
    assert records == [] and rotated and gap
    journal.close()


# ------------------------------------------------------------- the standby


@pytest.mark.parametrize("mode", MODES)
def test_standby_equals_its_primary_and_the_jax_standby_across_packages(tmp_path, mode):
    """Four standbys: each package's on its own primary's directory, and
    each package's on the other's.  After every poll all four and both
    primaries hold the same state; the row recycled by a close and an open
    replicates too; the two journals hold the same bytes."""
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc, tsvc = _primaries(mode, ck_j, ck_t, key=9, cfg=dict(num_reservoirs=3))
    rng = np.random.default_rng(1)
    for i in range(3):
        for s in (jsvc, tsvc):
            s.open_session(f"s{i}")
        _ingest((jsvc, tsvc), f"s{i}", rng, mode, 30)
    for s in (jsvc, tsvc):
        s.sync()
    standbys = [JStandby(ck_j), StandbyReplica(ck_j, device="cpu"),
                JStandby(ck_t), StandbyReplica(ck_t, device="cpu")]
    for rounds in range(3):
        for sb in standbys:
            sb.poll()
            assert sb.lag()[0] == 0 and sb.applied_seq == tsvc.flushed_seq == jsvc.flushed_seq
        _engines_equal(jsvc, tsvc, *(sb.service for sb in standbys))
        for key in [s.key for s in tsvc.table.sessions()]:
            _equal([jsvc.snapshot(key), tsvc.snapshot(key)] + [sb.snapshot(key) for sb in standbys])
        assert _journal_bytes(ck_j) == _journal_bytes(ck_t)
        # a recycled row replicates at its place between the flushes
        old, new = f"s{rounds}", f"s{rounds + 3}"
        for s in (jsvc, tsvc):
            s.close_session(old)
            s.open_session(new)
        _ingest((jsvc, tsvc), new, rng, mode, 40)
        _ingest((jsvc, tsvc), f"s{rounds + 1}", rng, mode, 17)
        for s in (jsvc, tsvc):
            s.sync()
    for sb in standbys:
        sb.poll()
        assert sb.table.route("s5").generation == 1
    _engines_equal(jsvc, tsvc, *(sb.service for sb in standbys))


def test_standby_rebootstraps_when_rotation_outruns_the_tail(tmp_path):
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc, tsvc = _primaries("plain", ck_j, ck_t, key=2, cfg=dict(num_reservoirs=3),
                            checkpoint_every=2, coalesce_bytes=32)
    for s in (jsvc, tsvc):
        s.open_session("a")
        s.ingest("a", np.arange(50, dtype=np.int32))
        s.sync()
    jsb, tsb = JStandby(ck_j), StandbyReplica(ck_t, device="cpu")
    jsb.poll(), tsb.poll()
    for i in range(4):  # checkpoint rotations while the standbys sleep
        for s in (jsvc, tsvc):
            s.ingest("a", np.arange(i * 100, i * 100 + 40, dtype=np.int32))
            s.sync()
    assert jsb.poll() == tsb.poll()
    assert tsb.metrics.bootstraps == jsb.metrics.bootstraps >= 2
    assert tsb.applied_seq == jsb.applied_seq == tsvc.flushed_seq
    _equal([jsvc.snapshot("a"), tsvc.snapshot("a"), jsb.snapshot("a"), tsb.snapshot("a")])


# ------------------------------------------------- promotion and the fence


def test_promote_fences_the_old_primary_without_changing_the_journal(tmp_path):
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jold, old = _primaries("plain", ck_j, ck_t, key=5, cfg=dict(num_reservoirs=3))
    hb = HeartbeatWriter(ck_t, service=old)
    for s in (jold, old):
        s.open_session("a")
        s.ingest("a", np.arange(40, dtype=np.int32))
        s.sync()
    hb.beat()
    before = old.snapshot("a")
    jsb, standby = JStandby(ck_j), StandbyReplica(ck_t, device="cpu")
    jsb.poll(), standby.poll()
    jpromoted, promoted = jsb.promote(), standby.promote()
    assert standby.is_promoted and standby.metrics.promotions == 1
    _equal([before, promoted.snapshot("a"), jpromoted.snapshot("a")])
    # the fenced old primary fails its next durable write, and an ingest
    # that forces a flush too, with the journal untouched
    journal_before = _journal_bytes(ck_t)
    with pytest.raises(FencedError):
        old.sync()
    with pytest.raises(FencedError):
        old.ingest("a", np.arange(100, dtype=np.int32))
        old.sync()
    assert _journal_bytes(ck_t) == journal_before
    assert old.bridge.metrics.fenced_writes >= 1
    with pytest.raises(FencedError):  # the fenced beacon claims nothing
        hb.beat()
    assert hb.metrics.fenced_writes == 1
    # the promoted primaries journal on; a re-following standby catches up
    for s in (jpromoted, promoted):
        s.ingest("a", np.arange(500, 540, dtype=np.int32))
        s.sync()
    refollow = StandbyReplica(ck_t, device="cpu")
    refollow.poll()
    _equal([refollow.snapshot("a"), promoted.snapshot("a"), jpromoted.snapshot("a")])
    # a second promotion fences the first promoted primary in turn
    promoted2 = refollow.promote()
    with pytest.raises(FencedError):
        promoted.sync()
    assert promoted2.snapshot("a").size > 0


def test_promote_is_refused_while_the_tail_is_unreadable(tmp_path):
    ck = str(tmp_path / "ck")
    svc = ReservoirService(SamplerConfig(**_kw(num_reservoirs=2)), key=7, checkpoint_dir=ck,
                           checkpoint_every=1000, coalesce_bytes=32, device="cpu")
    svc.open_session("a")
    svc.ingest("a", np.arange(40, dtype=np.int32))
    svc.sync()
    standby = StandbyReplica(ck, device="cpu",
                             faults=FaultPlane([FaultRule("replica.ship", exc=TransientDeviceError)]))
    with pytest.raises(RuntimeError, match="tail not drained"):
        standby.promote(drain_attempts=3)
    assert not standby.is_promoted and standby.metrics.promotions == 0
    assert standby.metrics.ship_errors == 3


def test_recover_preflight_rejects_a_fenced_lineage(tmp_path):
    ck = str(tmp_path / "ck")
    svc = ReservoirService(SamplerConfig(**_kw(num_reservoirs=2)), key=3, checkpoint_dir=ck,
                           checkpoint_every=1000, coalesce_bytes=32, device="cpu")
    svc.open_session("a")
    svc.ingest("a", np.arange(40, dtype=np.int32))
    svc.sync()
    standby = StandbyReplica(ck, device="cpu")
    standby.poll()
    # promoted without the handoff checkpoint: the fence passes the only
    # checkpoint's recorded epoch
    promoted = standby.promote(checkpoint=False)
    with pytest.raises(CheckpointMismatch, match="fence is at epoch"):
        ReservoirService.recover(ck, device="cpu")
    want = promoted.snapshot("a")
    promoted.bridge._save_snapshot()
    promoted.shutdown()
    np.testing.assert_array_equal(ReservoirService.recover(ck, device="cpu").snapshot("a"), want)


# ------------------------------------------------------ controller, beacon


def _report_view(report):
    return (report.healthy, report.should_promote, report.reasons, report.triggers,
            report.heartbeat_age_s, report.heartbeat)


def test_controller_verdicts_and_trigger_tags_equal_the_jax_controller(tmp_path):
    """The same primaries' signals under one injected clock: a healthy
    primary, demotions (degraded, not promote-worthy), a tripped watchdog
    (promote, tagged first), a stale heartbeat, then the promotion, whose
    reason and tags both controllers record alike; and a heartbeat that
    never existed ages from the first check."""
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc, tsvc = _primaries("plain", ck_j, ck_t, key=12, cfg=dict(num_reservoirs=2))
    clock = _Clock()
    for s in (jsvc, tsvc):
        s.open_session("a")
        s.ingest("a", np.arange(20, dtype=np.int32))
        s.sync()
    # a primary that never beat is as dead: missing beats age from the
    # controller's first check
    pairs = []
    for sb_cls, ctl_cls, ck, kw in ((JStandby, JController, ck_j, {}),
                                    (StandbyReplica, FailoverController, ck_t, {"device": "cpu"})):
        sb = sb_cls(ck, **kw)
        sb.poll()
        pairs.append((sb, ctl_cls(sb, heartbeat_timeout_s=5.0, clock=clock)))
    views = [_report_view(ctl.health()) for _, ctl in pairs]
    assert views[0] == views[1] and views[1][0]  # healthy: grace
    clock.t += 10.0
    views = [_report_view(ctl.health()) for _, ctl in pairs]
    assert views[0] == views[1] and "no heartbeat" in views[1][2][0] and views[1][3] == ["staleness"]
    # with beacons, from a fresh clock
    clock.t = 2000.0
    beacons = [JHeartbeat(ck_j, service=jsvc, clock=clock), HeartbeatWriter(ck_t, service=tsvc, clock=clock)]
    ctls = [JController(pairs[0][0], heartbeat_timeout_s=5.0, clock=clock),
            FailoverController(pairs[1][0], heartbeat_timeout_s=5.0, clock=clock)]
    steps = []
    for step in ("healthy", "demotions", "watchdog", "stale"):
        for svc in (jsvc, tsvc):
            if step == "demotions":
                svc.bridge.metrics.demotions = 2
            if step == "watchdog":
                svc.bridge.metrics.watchdog_trips = 1
        if step == "stale":
            clock.t += 10.0
        else:
            for b in beacons:
                b.beat()
        views = [_report_view(ctl.health()) for ctl in ctls]
        assert views[0] == views[1], step
        steps.append(views[1])
    assert steps[0][0] and steps[1][3] == ["demotions"] and not steps[1][1]
    assert steps[2][1] and steps[2][3][0] == "watchdog"
    assert "staleness" in steps[3][3]
    promoted = [ctl.maybe_promote() for ctl in ctls]
    assert all(p is not None for p in promoted)
    assert ctls[0].last_promotion_reason == ctls[1].last_promotion_reason
    assert ctls[0].last_promotion_triggers == ctls[1].last_promotion_triggers == steps[3][3]
    with pytest.raises(FencedError):
        tsvc.sync()
    with pytest.raises(jerrors.FencedError):
        jsvc.sync()


def test_heartbeat_json_equals_the_jax_primarys_apart_from_its_timestamp(tmp_path):
    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsvc, tsvc = _primaries("plain", ck_j, ck_t, key=3, cfg=dict(num_reservoirs=2))
    for s in (jsvc, tsvc):
        s.open_session("a")
        s.ingest("a", np.arange(20, dtype=np.int32))
        s.sync()
    payloads = [JHeartbeat(ck_j, service=jsvc).beat(), HeartbeatWriter(ck_t, service=tsvc).beat()]
    files = [j_read_heartbeat(ck_j), read_heartbeat(ck_t)]
    assert payloads[1] == files[1]
    for p in payloads + files:
        assert isinstance(p.pop("ts"), float)
    assert payloads[0] == payloads[1] == files[0]
    assert sorted(payloads[1]) == ["demotions", "epoch", "failures", "rejections", "seq",
                                   "sessions_open", "watchdog_trips"]
    assert read_heartbeat(str(tmp_path / "nowhere")) is None


# --------------------------------------------------------------- the faults


def _port_primary(tmp_path, key=8):
    ck = str(tmp_path / "ha")
    svc = ReservoirService(SamplerConfig(**_kw()), key=key, checkpoint_dir=ck, checkpoint_every=1000,
                           coalesce_bytes=32, device="cpu")
    svc.open_session("a")
    svc.ingest("a", np.arange(40, dtype=np.int32))
    svc.sync()
    return svc, ck


def test_replica_ship_fault_retries_and_lag_grows_never_corrupts(tmp_path):
    svc, ck = _port_primary(tmp_path)
    plane = FaultPlane([FaultRule("replica.ship", exc=TransientDeviceError, after=1, times=2)])
    standby = StandbyReplica(ck, faults=plane, device="cpu")
    assert standby.poll() > 0 and standby.lag()[0] == 0  # hit 0: clean
    svc.ingest("a", np.arange(500, 540, dtype=np.int32))
    svc.sync()
    assert standby.poll() == 0  # hit 1: the injected failure
    assert standby.metrics.ship_errors == 1
    assert isinstance(standby.last_error, TransientDeviceError)
    assert standby.applied_seq < svc.flushed_seq  # behind, not wrong
    assert standby.poll() == 0 and standby.metrics.ship_errors == 2
    assert standby.poll() > 0  # the rule is spent: it converges
    assert standby.lag() == (0, 0.0)
    np.testing.assert_array_equal(standby.snapshot("a"), svc.snapshot("a"))


def test_replica_apply_fault_retries_the_tile_bit_exactly(tmp_path):
    svc, ck = _port_primary(tmp_path, key=9)
    plane = FaultPlane([FaultRule("replica.apply", exc=RuntimeError, after=2, times=1)])
    standby = StandbyReplica(ck, faults=plane, device="cpu")
    polls = 0
    while standby.lag()[0] or standby.applied_seq < svc.flushed_seq:
        standby.poll()
        polls += 1
        assert polls < 10, "the standby did not converge past the apply fault"
    assert standby.metrics.apply_errors == 1
    _engines_equal(svc, standby.service)


def test_heartbeat_fault_starves_the_beacon_and_the_controller_promotes(tmp_path):
    svc, ck = _port_primary(tmp_path, key=10)
    clock = _Clock()
    plane = FaultPlane([FaultRule("ha.heartbeat", exc=OSError, after=1)])
    hb = HeartbeatWriter(ck, service=svc, clock=clock, faults=plane)
    hb.beat()  # hit 0: the last beat that lands
    standby = StandbyReplica(ck, device="cpu")
    standby.poll()
    ctl = FailoverController(standby, heartbeat_timeout_s=5.0, clock=clock)
    assert not ctl.health().should_promote
    clock.t += 10.0
    with pytest.raises(OSError):
        hb.beat()
    assert ctl.health().should_promote
    assert ctl.maybe_promote() is not None and standby.metrics.promotions == 1
    with pytest.raises(FencedError):
        svc.sync()


# --------------------------------------------------------------- chaos soak


@pytest.mark.parametrize("mode", MODES)
def test_chaos_soak_kill_promote_refollow_equals_an_uninterrupted_jax_service(tmp_path, mode):
    """Three cycles of traffic (opens that recycle rows, ingests, closes),
    a kill, a promotion and a re-follow, under faults at ``replica.ship``,
    ``replica.apply`` and ``ha.heartbeat``.  After every promotion each
    live session's snapshot equals an uninterrupted JAX service's fed the
    same calls; the fenced zombie fails typed with its journal untouched."""
    cycles = 3
    cfg = _kw(mode, num_reservoirs=4)
    ck = str(tmp_path / "ck")
    plane = FaultPlane(
        [
            FaultRule("replica.ship", exc=TransientDeviceError, after=2, every=5),
            FaultRule("replica.apply", exc=TransientDeviceError, after=1, every=7),
            FaultRule("ha.heartbeat", exc=OSError, after=1, every=4),
        ],
        seed=11,
    )
    seed = 40 + len(mode)
    gated = mode == "gated"
    ref = JService(JConfig(**cfg), key=seed, coalesce_bytes=64, gated=gated, pipelined=False)
    primary = ReservoirService(SamplerConfig(**cfg), key=seed, checkpoint_dir=ck, checkpoint_every=9,
                               coalesce_bytes=64, faults=plane, gated=gated, device="cpu")
    hb = HeartbeatWriter(ck, service=primary, faults=plane)
    standby = StandbyReplica(ck, faults=plane, device="cpu")
    rng = np.random.default_rng(seed)
    live, next_id = [], 0
    for cycle in range(cycles):
        for _ in range(8):
            op = rng.random()
            if (op < 0.3 and len(live) < 6) or not live:
                key = f"s{next_id}"
                next_id += 1
                for s in (ref, primary):
                    s.open_session(key)
                live = [k for k in live if k in primary.table] + [key]
            elif op < 0.85:
                key = live[int(rng.integers(len(live)))]
                if key not in primary.table:
                    live.remove(key)
                    continue
                n = int(rng.integers(1, 14))
                elems = ((int(key[1:]) + 1) * 10_000 + rng.integers(0, 5000, n)).astype(np.int32)
                w = rng.uniform(0.1, 3.0, n).astype(np.float32) if mode == "weighted" else None
                for s in (ref, primary):
                    s.ingest(key, elems, weights=w)
            else:
                key = live.pop(int(rng.integers(len(live))))
                if key in primary.table:
                    for s in (ref, primary):
                        s.close_session(key)
            if rng.random() < 0.3:
                try:
                    hb.beat()
                except OSError:
                    pass
        primary.sync()
        for _ in range(3):
            standby.poll()
        old, old_hb = primary, hb
        promoted = standby.promote()
        journal_before = _journal_bytes(ck)
        with pytest.raises(FencedError):
            old.sync()
        assert _journal_bytes(ck) == journal_before
        with pytest.raises((FencedError, OSError)):
            while True:  # the first beat the fault lets through hits the fence
                old_hb.beat()
        keys = sorted(s.key for s in promoted.table.sessions())
        assert keys == sorted(s.key for s in ref.table.sessions())
        for key in keys:
            _equal([ref.snapshot(key), promoted.snapshot(key)])
        primary = promoted
        hb = HeartbeatWriter(ck, service=primary, faults=plane)
        standby = StandbyReplica(ck, faults=plane, device="cpu")
    hits = plane.hits()
    for site in ("replica.ship", "replica.apply", "ha.heartbeat"):
        assert hits.get(site, 0) >= cycles, (site, hits)
