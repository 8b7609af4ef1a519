"""The port's bridge journal, checkpoints and recovery against the JAX
package's: a checkpoint directory written by either package's bridge
recovers in the other, bit-identical to an uninterrupted run, in all three
modes; the journal's frames are the same bytes; epoch fencing crosses the
packages; and the robustness plane (retry, watchdog, checkpoint faults)."""

from __future__ import annotations

import gc
import logging
import os

import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.stream.bridge import DeviceStreamBridge as JBridge
from reservoir_tpu.stream.bridge import _FlushJournal as JJournal
from reservoir_tpu.utils.checkpoint import advance_epoch as j_advance_epoch
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.errors import (
    CheckpointMismatch,
    FencedError,
    FlushTimeout,
    RetryPolicy,
    SamplerClosedError,
    TransientDeviceError,
)
from reservoir_tpu_torch.stream.bridge import _FlushJournal
from reservoir_tpu_torch.utils import checkpoint, faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule

S, B, K = 3, 8, 4


@pytest.fixture(autouse=True)
def _no_global_faults():
    faults.uninstall()
    yield
    faults.uninstall()


def _kw(mode):
    return dict(max_sample_size=K, num_reservoirs=S, tile_size=B,
                weighted=mode == "weighted", distinct=mode == "distinct")


def _port(mode, **kw):
    return DeviceStreamBridge(SamplerConfig(**_kw(mode)), key=7, device="cpu", **kw)


def _jax(mode, **kw):
    return JBridge(JConfig(**_kw(mode)), key=7, **kw)


def _feed(mode, rounds, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 30, (rounds, S, B)).astype(np.int32)
    if mode == "distinct":
        data %= 97
    w = rng.uniform(0.1, 2.0, (rounds, S, B)).astype(np.float32) if mode == "weighted" else None
    return data, w


def _round(bridge, feed, r):
    data, w = feed
    for s in range(S):
        bridge.push(s, data[r, s], weights=None if w is None else w[r, s])


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
def test_recover_across_packages_is_bit_identical(tmp_path, mode, direction):
    rounds, crash = 6, 4
    feed = _feed(mode, rounds)
    ref = _port(mode)
    for r in range(rounds):
        _round(ref, feed, r)
    expected = ref.complete()

    ckdir = str(tmp_path / "ck")
    writer = (_jax if direction == "jax_to_port" else _port)(
        mode, checkpoint_dir=ckdir, checkpoint_every=5
    )
    for r in range(crash):
        _round(writer, feed, r)
    writer.drain_barrier()
    assert writer.flushed_seq == crash * S
    del writer  # the crash: no complete(), no clean shutdown
    gc.collect()

    if direction == "jax_to_port":
        recovered = DeviceStreamBridge.recover(ckdir, device="cpu")
    else:
        recovered = JBridge.recover(ckdir)
    assert recovered.metrics.recoveries == 1
    assert recovered.flushed_seq == crash * S
    for r in range(crash, rounds):
        _round(recovered, feed, r)
    _same(expected, recovered.complete())


@pytest.mark.parametrize("weighted", [False, True])
def test_journal_frames_are_the_jax_packages_bytes(tmp_path, weighted):
    rng = np.random.default_rng(3)
    paths = [str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")]
    journals = [_FlushJournal(paths[0], S, B, np.int32, weighted),
                JJournal(paths[1], S, B, np.int32, weighted)]
    for seq in (1, 2, 3):
        tile = rng.integers(0, 1 << 30, (S, B)).astype(np.int32)
        valid = rng.integers(0, B + 1, S).astype(np.int32)
        w = rng.random((S, B)).astype(np.float32) if weighted else None
        for j in journals:
            j.append(seq, tile, valid, w)
    for j in journals:
        j.close()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got = list(_FlushJournal.replay(paths[1], S, B, np.int32, weighted))
    want = list(JJournal.replay(paths[0], S, B, np.int32, weighted))
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for x, y in zip(g[1:4], w[1:4]):
            np.testing.assert_array_equal(x, y)


def test_journal_tolerates_truncated_and_corrupt_tail(tmp_path):
    path = str(tmp_path / "journal.bin")
    journal = _FlushJournal(path, 2, 4, np.int32, weighted=False)
    tiles = []
    for seq in range(1, 4):
        tile = np.full((2, 4), seq, np.int32)
        journal.append(seq, tile, np.full(2, 4, np.int32), None)
        tiles.append(tile)
    journal.close()
    full = os.path.getsize(path)
    with open(path, "r+b") as fh:  # a torn last record
        fh.truncate(full - 7)
    recs = list(_FlushJournal.replay(path, 2, 4, np.int32, False))
    assert [r[0] for r in recs] == [1, 2]
    np.testing.assert_array_equal(recs[1][1], tiles[1])
    with open(path, "r+b") as fh:  # a flipped byte in record 2: its CRC fails
        off = full // 3 + _FlushJournal._HEADER.size + 5
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 0xFF]))
    assert [r[0] for r in _FlushJournal.replay(path, 2, 4, np.int32, False)] == [1]


@pytest.mark.parametrize("fencer", ["jax", "port"])
def test_fenced_by_either_packages_advance_epoch(tmp_path, fencer):
    ckdir = str(tmp_path / "ck")
    bridge = _port("uniform", checkpoint_dir=ckdir, checkpoint_every=100)
    jbridge = _jax("uniform", checkpoint_dir=str(tmp_path / "jck"), checkpoint_every=100)
    feed = _feed("uniform", 2)
    _round(bridge, feed, 0)
    _round(jbridge, feed, 0)
    advance = j_advance_epoch if fencer == "jax" else checkpoint.advance_epoch
    assert advance(ckdir) == 1
    with pytest.raises(FencedError) as info:
        _round(bridge, feed, 1)
    assert (info.value.observed_epoch, info.value.own_epoch) == (1, 0)
    assert bridge.metrics.fenced_writes == 1
    # and a JAX bridge is fenced by the port's epoch file
    checkpoint.advance_epoch(str(tmp_path / "jck"))
    with pytest.raises(Exception, match="fenced"):
        _round(jbridge, feed, 1)
    # a lineage older than the persisted epoch is not recovered
    with pytest.raises(CheckpointMismatch, match="promoted past this lineage"):
        DeviceStreamBridge.recover(ckdir, device="cpu")


def _adopt_midstream(bridge, feed, crash):
    """Rounds 0-1, an adoption of rows 0 and 2 into rows 2 and 1 (the
    bridge's own exported rows: a live migration within one engine), then
    rounds 2 .. crash - 1."""
    for r in range(2):
        _round(bridge, feed, r)
    bridge.drain_barrier()
    bridge.adopt_rows([2, 1], bridge.engine.export_rows([0, 2]))
    for r in range(2, crash):
        _round(bridge, feed, r)
    bridge.drain_barrier()


def _engine_words(state):
    """A state of either package as numpy words, keys as key data."""
    import jax.random as jr

    out = []
    for v in state:
        if v is None:
            out.append(None)
            continue
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
            out.append(v.astype(np.uint32) if v.dtype == np.int64 else v)
            continue
        try:
            v = jr.key_data(v)
        except TypeError:
            pass
        out.append(np.asarray(v))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
def test_recover_replays_adopt_frames_across_packages(tmp_path, mode, writer):
    """A row adoption journaled as an ``RTJA`` frame by either package's
    bridge replays in both packages' recovery at its place between the
    flushes, to the JAX package's recovered state and the live writer's,
    bit for bit; each package's reader unpacks the other's frame."""
    from reservoir_tpu.stream.bridge import _unpack_adopt_payload as j_unpack
    from reservoir_tpu_torch.stream.bridge import _unpack_adopt_payload as t_unpack

    rounds, crash = 6, 4
    feed = _feed(mode, rounds)
    ckdir = str(tmp_path / "ck")
    live = (_jax if writer == "jax" else _port)(mode, checkpoint_dir=ckdir, checkpoint_every=100)
    _adopt_midstream(live, feed, crash)
    want = _engine_words(live.engine.state)
    del live
    gc.collect()
    path = os.path.join(ckdir, "journal.bin")
    subs = []
    for reader, unpack in ((JJournal, j_unpack), (_FlushJournal, t_unpack)):
        recs = list(reader.replay(path, S, B, np.int32, mode == "weighted"))
        adopts = [r for r in recs if r[4] is reader.ADOPT]
        assert [r[0] for r in adopts] == [2 * S + 1]
        rows, sub = unpack(adopts[0][1])
        assert rows.tolist() == [2, 1]
        subs.append(_engine_words(sub))
    for a, b in zip(*subs):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape[0] == 2
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    port = DeviceStreamBridge.recover(ckdir, device="cpu")
    assert port.flushed_seq == crash * S + 1
    assert port.engine.reset_epochs == 1 and port.metrics.flushes == crash * S + 1
    for got in (_engine_words(port.engine.state), _engine_words(JBridge.recover(ckdir).engine.state)):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    # and the recovered bridge goes on: the rest of the stream equals an
    # uninterrupted run that adopted at the same place
    ref = _port(mode)
    _adopt_midstream(ref, feed, rounds)
    for r in range(crash, rounds):
        _round(port, feed, r)
    _same(ref.complete(), port.complete())


def test_an_adopt_is_fenced_and_checked_before_it_is_journaled(tmp_path):
    ckdir = str(tmp_path / "ck")
    bridge = _port("uniform", checkpoint_dir=ckdir, checkpoint_every=100)
    _round(bridge, _feed("uniform", 1), 0)
    bridge.drain_barrier()
    seq = bridge.flushed_seq
    part = bridge.engine.export_rows([0])
    with pytest.raises(ValueError, match="out of range"):
        bridge.adopt_rows([S], part)
    with pytest.raises(ValueError, match="leading axis"):
        bridge.adopt_rows([0, 1], part)
    checkpoint.advance_epoch(ckdir)
    with pytest.raises(FencedError):
        bridge.adopt_rows([1], part)
    assert bridge.flushed_seq == seq and bridge.engine.reset_epochs == 0
    path = os.path.join(ckdir, "journal.bin")
    assert all(r[4] is None for r in _FlushJournal.replay(path, S, B, np.int32, False))


def test_a_checkpoint_after_an_adopt_covers_it(tmp_path):
    """An adopt takes a flush sequence number and may trigger the
    auto-checkpoint; recovery from that checkpoint equals the live state."""
    ckdir = str(tmp_path / "ck")
    bridge = _port("uniform", checkpoint_dir=ckdir, checkpoint_every=2 * S + 1)
    _adopt_midstream(bridge, _feed("uniform", 4), 2)
    assert bridge.metrics.checkpoints == 2  # the seq-0 anchor and the adopt's
    want = _engine_words(bridge.engine.state)
    del bridge
    gc.collect()
    got = _engine_words(DeviceStreamBridge.recover(ckdir, device="cpu").engine.state)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_recover_rejects_a_plain_engine_checkpoint(tmp_path):
    eng = ReservoirEngine(SamplerConfig(**_kw("uniform")), key=0, reusable=True, device="cpu")
    eng.sample(np.arange(S * B, dtype=np.int32).reshape(S, B))
    eng.save(str(tmp_path / "engine.npz"))
    with pytest.raises(ValueError, match="auto-checkpointing bridge"):
        DeviceStreamBridge.recover(str(tmp_path), device="cpu")


def test_transient_fault_is_retried_to_the_same_result():
    data = np.arange(40, dtype=np.int32)
    plane = FaultPlane([FaultRule("bridge.dispatch", exc=TransientDeviceError, times=2)])
    faulty = _port("uniform", faults=plane, retry_policy=RetryPolicy(max_retries=3, base_backoff_s=0.001))
    clean = _port("uniform")
    faulty.push(0, data)
    clean.push(0, data)
    _same(clean.complete(), faulty.complete())
    assert faulty.metrics.retries == 2 and faulty.metrics.failures == 0
    assert plane.hits()["bridge.dispatch"] >= 3


def test_retries_exhausted_and_fatal_faults_fail_the_stream():
    exhausted = _port(
        "uniform",
        faults=FaultPlane([FaultRule("bridge.dispatch", exc=TransientDeviceError)]),
        retry_policy=RetryPolicy(max_retries=2, base_backoff_s=0.001),
    )
    exhausted.push(0, np.arange(8, dtype=np.int32))  # fills a row: a flush
    with pytest.raises(TransientDeviceError):
        exhausted.drain_barrier()
    assert isinstance(exhausted.sample.exception(timeout=2), TransientDeviceError)
    assert exhausted.metrics.retries == 2 and exhausted.metrics.failures == 1
    with pytest.raises(SamplerClosedError):
        exhausted.push(0, 1)
    fatal = _port(
        "uniform",
        faults=FaultPlane([FaultRule("bridge.dispatch", exc=RuntimeError, message="fatal")]),
        retry_policy=RetryPolicy(max_retries=5, base_backoff_s=0.001),
    )
    fatal.push(0, np.arange(8, dtype=np.int32))
    assert isinstance(fatal.sample.exception(timeout=2), RuntimeError)
    assert fatal.metrics.retries == 0  # fatal: no retry spent


def test_watchdog_trips_on_a_hung_flush():
    plane = FaultPlane([FaultRule("bridge.dispatch", exc=None, delay=0.5)])
    bridge = _port("uniform", faults=plane, flush_timeout_s=0.05)
    bridge.push(0, np.arange(8, dtype=np.int32))
    assert isinstance(bridge.sample.exception(timeout=2), FlushTimeout)
    assert bridge.metrics.watchdog_trips == 1
    with pytest.raises(FlushTimeout):
        bridge.drain_barrier()
    with pytest.raises(SamplerClosedError):
        bridge.push(0, 1)
    import time

    time.sleep(0.6)  # let the delayed worker finish before teardown


def test_checkpoint_faults_keep_the_previous_checkpoint_and_the_stream(tmp_path, caplog):
    # a crash inside the checkpoint writer leaves the previous file intact
    # and no temporary file
    eng = ReservoirEngine(SamplerConfig(**_kw("uniform")), key=0, reusable=True, device="cpu")
    tile = np.arange(S * B, dtype=np.int32).reshape(S, B)
    eng.sample(tile)
    path = tmp_path / "e.npz"
    eng.save(str(path))
    before = path.read_bytes()
    eng.sample(tile + 100)
    with faults.active(FaultPlane([FaultRule("checkpoint.write", exc=OSError, times=1)])):
        with pytest.raises(OSError):
            eng.save(str(path))
    assert path.read_bytes() == before and sorted(os.listdir(tmp_path)) == ["e.npz"]
    # failing periodic checkpoints are logged once and sampling goes on;
    # the seq-0 anchor and the longer journal still recover everything
    rounds = 6
    feed = _feed("uniform", rounds, seed=2)
    ref = _port("uniform")
    for r in range(rounds):
        _round(ref, feed, r)
    expected = ref.complete()
    ckdir = str(tmp_path / "ck")
    with faults.active(FaultPlane([FaultRule("checkpoint.write", exc=OSError, after=1)])):
        bridge = _port("uniform", checkpoint_dir=ckdir, checkpoint_every=3, durability="fsync")
        with caplog.at_level(logging.WARNING, "reservoir_tpu_torch.stream.bridge"):
            for r in range(4):
                _round(bridge, feed, r)
        bridge.drain_barrier()
        assert bridge.metrics.checkpoints == 1  # the seq-0 anchor only
        assert bridge.metrics.journal_syncs >= 4 * S
        assert len([r for r in caplog.records if "auto-checkpoint failed" in r.message]) == 1
        del bridge
        gc.collect()
    recovered = DeviceStreamBridge.recover(ckdir, device="cpu")
    assert recovered.flushed_seq == 4 * S
    for r in range(4, rounds):
        _round(recovered, feed, r)
    _same(expected, recovered.complete())


def test_push_tile_is_journaled_and_replayed(tmp_path):
    rng = np.random.default_rng(5)
    tiles = [rng.integers(0, 1 << 30, (S, B)).astype(np.int32) for _ in range(4)]
    valids = [None, rng.integers(0, B + 1, S).astype(np.int32), None, None]
    ref = _port("uniform")
    for t, v in zip(tiles, valids):
        ref.push_tile(t, valid=v)
    expected = ref.complete()
    ckdir = str(tmp_path / "ck")
    bridge = _port("uniform", checkpoint_dir=ckdir, checkpoint_every=100)
    for t, v in zip(tiles[:3], valids[:3]):
        bridge.push_tile(t, valid=v)
    with pytest.raises(ValueError, match="configured element dtype"):
        bridge.push_tile(tiles[3].astype(np.int64))
    del bridge
    gc.collect()
    recovered = JBridge.recover(ckdir)  # replayed by the JAX package
    recovered.push_tile(tiles[3])
    _same(expected, recovered.complete())


def test_state_and_metadata_round_trip_across_packages(tmp_path):
    from reservoir_tpu.utils import checkpoint as jckpt

    eng = ReservoirEngine(SamplerConfig(**_kw("weighted")), key=3, device="cpu")
    eng.sample(np.arange(S * B, dtype=np.int32).reshape(S, B), weights=np.ones((S, B), np.float32))
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, eng.state, metadata={"seq": 9})
    jstate, meta = jckpt.load_state(path, with_metadata=True)
    assert meta == {"seq": 9}
    back = str(tmp_path / "back.npz")
    jckpt.save_state(back, jstate, metadata={"seq": 10})
    state, meta = checkpoint.load_state(back, with_metadata=True)
    assert meta == {"seq": 10}
    for a, b in zip(eng.state, state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    eng.save(str(tmp_path / "engine.npz"), metadata={"bridge": {"seq": 4}})
    assert checkpoint.read_engine_metadata(str(tmp_path / "engine.npz")) == {"bridge": {"seq": 4}}
    _, meta = checkpoint.load_engine(str(tmp_path / "engine.npz"), device="cpu", with_metadata=True)
    assert meta == {"bridge": {"seq": 4}}
    assert checkpoint.read_epoch(str(tmp_path)) == 0
    assert checkpoint.write_epoch(str(tmp_path), 4) == 4 and jckpt.read_epoch(str(tmp_path)) == 4


# ------------------------------------------------------------- skip gate


def _gated_run(bridge, data, rounds):
    """Rounds of per-row pushes (two pieces a row, the first straddling
    the gate's pre-staging path and the staging)."""
    for r in range(rounds):
        for s in range(S):
            row = data[s, r * B:(r + 1) * B]
            bridge.push(s, row[:3])
            bridge.push(s, row[3:])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gated_recovery_across_packages_is_bit_identical(tmp_path, direction):
    """A gated journaling bridge of one package is dropped mid-stream; the
    other package recovers it, replaying its plain and gated (``RTJG``)
    frames, and resumes each row from its durable count: the reservoirs of
    an uninterrupted gated run of the writer's package."""
    rounds, crash = 16, 9
    data = np.random.default_rng(31).integers(0, 1 << 30, (S, rounds * B)).astype(np.int32)
    make_writer = _jax if direction == "jax_to_port" else _port
    whole = make_writer("uniform", gated=True, gate_tile=4)
    _gated_run(whole, data, rounds)
    expected = whole.complete()
    assert whole.metrics.gated_dispatches >= 2

    ckdir = str(tmp_path / "ck")
    writer = make_writer("uniform", gated=True, gate_tile=4, checkpoint_dir=ckdir, checkpoint_every=4)
    _gated_run(writer, data, crash)
    writer.drain_barrier()
    gated_frames = writer.metrics.gated_dispatches
    del writer  # the crash: the staged rows and the gate's buffer are lost
    gc.collect()
    frames = [rec[5] is not None for rec in JJournal.read_records(
        os.path.join(ckdir, "journal.bin"), S, B, np.int32, False)]
    assert gated_frames >= 1 and any(frames), "the journal must hold a gated frame to replay"

    if direction == "jax_to_port":
        recovered = DeviceStreamBridge.recover(ckdir, device="cpu")
        counts = recovered.engine.state.count.numpy()
    else:
        recovered = JBridge.recover(ckdir)
        counts = np.asarray(recovered.engine._state.count)
    assert recovered.gate_active  # the metadata carries the gate
    for s in range(S):
        recovered.push(s, data[s, counts[s]:])
    _same(expected, recovered.complete())


def test_gated_frames_are_the_jax_packages_bytes_and_a_torn_gated_tail_is_dropped(tmp_path):
    """Plain and gated frames interleave in one journal, byte for byte the
    JAX package's; the reader recovers Bg from a gated frame's length; a
    tail torn inside the gated frame stops the replay before it, as the
    reference's reader does, and recovery then resumes from the rows'
    durable counts."""
    bg = 5
    rng = np.random.default_rng(4)
    tile = rng.integers(0, 1 << 30, (S, B)).astype(np.int32)
    gtile = rng.integers(0, 1 << 30, (S, bg)).astype(np.int32)
    nvalid = np.asarray([2, 0, 5], np.int32)
    advance = np.asarray([17, 40, 9], np.int32)
    valid = np.full(S, B, np.int32)
    paths = {}
    for name, journal_cls in (("jax", JJournal), ("port", _FlushJournal)):
        paths[name] = str(tmp_path / f"{name}.bin")
        journal = journal_cls(paths[name], S, B, np.int32, False)
        journal.append(1, tile, valid, None)
        journal.append_gated(2, gtile, nvalid, advance)
        journal.append(3, tile + 5, valid, None)
        journal.close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    recs = list(_FlushJournal.replay(paths["port"], S, B, np.int32, False))
    assert [r[0] for r in recs] == [1, 2, 3] and recs[0][4] is None and recs[2][4] is None
    np.testing.assert_array_equal(recs[1][1], gtile)
    np.testing.assert_array_equal(recs[1][2], nvalid)
    np.testing.assert_array_equal(recs[1][4], advance)
    plain_frame = _FlushJournal._HEADER.size + S * 4 + S * B * 4 + 4
    with open(paths["port"], "r+b") as fh:
        fh.truncate(plain_frame + 10)  # inside the gated frame
    for reader in (_FlushJournal, JJournal):
        assert [r[0] for r in reader.replay(paths["port"], S, B, np.int32, False)] == [1]

    # a gated bridge torn inside its last gated frame recovers to the
    # frames before it, and the rows resume from their durable counts
    data = rng.integers(0, 1 << 30, (S, 14 * B)).astype(np.int32)
    expected = _port("uniform", gated=True, gate_tile=4)
    _gated_run(expected, data, 14)
    expected = expected.complete()
    ckdir = str(tmp_path / "ck")
    writer = _port("uniform", gated=True, gate_tile=4, checkpoint_dir=ckdir, checkpoint_every=1000)
    _gated_run(writer, data, 8)
    writer.flush()  # the pending candidates become the journal's last frame
    writer.drain_barrier()
    del writer
    gc.collect()
    path = os.path.join(ckdir, "journal.bin")
    ends = [(rec[0], rec[5] is not None) for rec in _FlushJournal.read_records(path, S, B, np.int32, False)]
    assert ends[-1][1], "the last frame must be gated"
    with open(path, "r+b") as fh:
        fh.truncate(ends[-1][0] - 3)
    recovered = DeviceStreamBridge.recover(ckdir, device="cpu")
    assert recovered.flushed_seq == len(ends) - 1
    counts = recovered.engine.state.count.numpy()
    for s in range(S):
        recovered.push(s, data[s, counts[s]:])
    _same(expected, recovered.complete())
