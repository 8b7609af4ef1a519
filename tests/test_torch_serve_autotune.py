"""The port's service-knob cache and online tuner against the JAX package's
(``tests/test_serve_autotune.py``'s cases), on the CPU.

- the knob cache: bands, keys, round trips, the ``any`` fallback, and one
  file written by either package and read by the other;
- consumption at construction: a cached winner is taken, explicit
  arguments win, an empty cache gives the builtin defaults;
- the tuner's control law: driven by the same scripted verdicts, the
  port's ``ServiceTuner`` takes the JAX tuner's decisions and leaves the
  same knobs; driven by measured ingest latency (a delay fault against a
  latency objective, judged by the port's ``SLOPlane`` from its
  ``serve.ingest_s`` histogram), it backs off within one window,
  re-probes after a healthy dwell and stays inside its bounds;
- a tuner at its optimum leaves the journals byte-identical.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from reservoir_tpu import SamplerConfig as JConfig
from reservoir_tpu.ops import autotune as jstore
from reservoir_tpu.serve import ReservoirService as JService
from reservoir_tpu.serve import ServiceTuner as JTuner
from reservoir_tpu.serve import autotune as jtune
from reservoir_tpu_torch import ReservoirService, SamplerConfig
from reservoir_tpu_torch.obs import registry as obs
from reservoir_tpu_torch.obs.slo import SLOPlane, SLOSpec
from reservoir_tpu_torch.ops import autotune as store
from reservoir_tpu_torch.serve import ServiceTuner
from reservoir_tpu_torch.serve.autotune import (
    DEFAULT_BOUNDS,
    DEFAULT_KNOBS,
    KnobBounds,
    ServiceKnobs,
    device_kind_of,
    lookup_knobs,
    make_serve_key,
    rate_band,
    record_knobs,
    service_fingerprint,
    zipf_band,
)
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule

WINNER = ServiceKnobs(1 << 14, 1 << 22, 256, 0.5, 1 << 16)
CHUNK = np.arange(16, dtype=np.int32)


def _cfg(**kw):
    kw.setdefault("max_sample_size", 4)
    kw.setdefault("num_reservoirs", 8)
    kw.setdefault("tile_size", 8)
    return kw


def _service(**kw):
    return ReservoirService(SamplerConfig(**_cfg()), key=0, device="cpu", **kw)


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Both packages' store at one throwaway file."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", path)
    faults.uninstall()
    yield path
    faults.uninstall()


@pytest.fixture
def registry():
    reg = obs.enable(obs.Registry())
    yield reg
    obs.disable()


def _burn_spec():
    """The JAX package's test objective: ``serve.ingest_s`` over 0.1 ms at
    p90, one-second windows."""
    return SLOSpec(
        name="ingest_latency_p99",
        kind="latency_quantile",
        instrument="serve.ingest_s",
        threshold=1e-4,
        quantile=0.9,
        short_window_s=1.0,
        long_window_s=1.0,
    )


class _ScriptedPlane:
    """A plane whose verdicts are a script, one an evaluation."""

    def __init__(self, verdicts):
        self._verdicts = list(verdicts)
        self._i = -1

    def evaluate(self, now=None):
        self._i += 1

    def worst(self):
        return self._verdicts[self._i]


# --------------------------------------------------------------- the cache


class TestBands:
    @pytest.mark.parametrize("rate", [None, 0, 500, 8000, 10_000, 3.7e6])
    def test_rate_band_equals_jax(self, rate):
        assert rate_band(rate) == jtune.rate_band(rate)

    @pytest.mark.parametrize("s", [None, -1.0, 0.3, 1.1, 1.3, 2.0])
    def test_zipf_band_equals_jax(self, s):
        assert zipf_band(s) == jtune.zipf_band(s)

    def test_key_shape(self):
        key = make_serve_key("NVIDIA H100 80GB HBM3", 65536, 128, "plain", True, 8000, 1.1)
        assert key == ("serve|NVIDIA H100 80GB HBM3|R=65536|k=128|mode=plain|gated=1"
                       "|rate=1e3|zipf=1.0")
        assert key == jtune.make_serve_key("NVIDIA H100 80GB HBM3", 65536, 128, "plain", True, 8000, 1.1)

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="mode"):
            make_serve_key("cpu", 8, 4, "blorp", False)

    def test_device_kind(self):
        assert device_kind_of("cpu") == "cpu"
        assert device_kind_of(object()) == "cpu"  # never raises
        # no card here: None (the card) reads as the CPU, as the reference
        # reads an unreachable backend
        assert device_kind_of(None) == "cpu"


class TestKnobCache:
    def test_record_lookup_roundtrip(self, cache):
        key = record_knobs("cpu", 8, 4, "plain", False, WINNER, rate=8000, zipf_s=1.1,
                           elem_per_sec=1e6, source="test")
        assert key.startswith("serve|cpu|")
        assert lookup_knobs("cpu", 8, 4, "plain", False, rate=8000, zipf_s=1.1) == WINNER

    def test_any_band_fallback(self, cache):
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        assert lookup_knobs("cpu", 8, 4, "plain", False, rate=123, zipf_s=2.0) == WINNER

    def test_exact_band_beats_any(self, cache):
        other = WINNER._replace(coalesce_bytes=1 << 15)
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        record_knobs("cpu", 8, 4, "plain", False, other, rate=8000, zipf_s=1.1)
        assert lookup_knobs("cpu", 8, 4, "plain", False, rate=8000, zipf_s=1.1) == other
        assert lookup_knobs("cpu", 8, 4, "plain", False) == WINNER

    def test_miss_is_none(self, cache):
        assert lookup_knobs("cpu", 8, 4, "plain", False) is None

    def test_corrupt_entry_is_none(self, cache):
        store.record_raw(make_serve_key("cpu", 8, 4, "plain", False), {"coalesce_bytes": "nan?"}, cache)
        assert lookup_knobs("cpu", 8, 4, "plain", False) is None

    def test_corrupt_file_reads_as_empty(self, cache):
        with open(cache, "w") as fh:
            fh.write("{not json")
        assert store.load() == {}
        assert lookup_knobs("cpu", 8, 4, "plain", False) is None

    def test_unknown_entry_kind_refused(self, cache):
        with pytest.raises(ValueError, match="entry kind"):
            store.record_raw("blorp|x", {})

    def test_serve_entries_ride_schema_3(self, cache):
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        with open(cache) as f:
            assert json.load(f)["_schema"] == store._SCHEMA == jstore._SCHEMA

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_a_knob_file_one_package_wrote_the_other_reads(self, cache, writer):
        from reservoir_tpu_torch.serve import autotune as ttune

        rec, reader = (jtune, ttune) if writer == "jax" else (ttune, jtune)
        other = WINNER._replace(checkpoint_every=32)
        rec.record_knobs("cpu", 8, 4, "weighted", True, other, rate=8000, source=writer)
        got = reader.lookup_knobs("cpu", 8, 4, "weighted", True, rate=9000)
        assert tuple(got) == tuple(other)
        assert store.load() == jstore.load()

    def test_a_schema_1_file_migrates_as_in_the_jax_package(self, cache):
        with open(cache, "w") as fh:
            json.dump({"cpu|R=8|k=4|B=8|int32": {"block_r": 8, "chunk_b": 0, "gather_chunk": 0}}, fh)
        assert store.load() == jstore.load() == {
            "algl|cpu|R=8|k=4|B=8|int32": {"block_r": 8, "chunk_b": 0, "gather_chunk": 0}}
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        with open(cache) as f:
            raw = json.load(f)
        assert "algl|cpu|R=8|k=4|B=8|int32" in raw and raw["_schema"] == 3
        assert jstore.lookup("cpu", 8, 4, 8, np.int32).block_r == 8


# --------------------------------------------- construction-time consumption


class TestConstructionConsumption:
    def test_cached_winner_consumed(self):
        record_knobs(device_kind_of("cpu"), 8, 4, "plain", False, WINNER)
        assert _service().live_knobs() == WINNER

    def test_a_winner_the_jax_package_recorded_is_consumed(self):
        jtune.record_knobs("cpu", 8, 4, "plain", False, WINNER)
        live = _service(ttl_s=60.0).live_knobs()
        assert tuple(live) == tuple(WINNER)

    def test_cached_sweep_interval_consumed(self):
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        assert _service(ttl_s=60.0).live_knobs().sweep_interval_s == 0.5

    def test_explicit_kwargs_win(self):
        record_knobs("cpu", 8, 4, "plain", False, WINNER)
        live = _service(coalesce_bytes=1 << 13).live_knobs()
        assert live.coalesce_bytes == 1 << 13
        assert live.checkpoint_every == WINNER.checkpoint_every

    def test_empty_cache_means_builtin_defaults(self):
        live = _service().live_knobs()
        jlive = JService(JConfig(**_cfg()), key=0).live_knobs()
        assert tuple(live)[:3] == tuple(DEFAULT_KNOBS)[:3] == tuple(jlive)[:3]
        assert live.gate_push_chunk == jlive.gate_push_chunk == 1 << 20

    def test_fingerprint_matches_lookup_key(self):
        device_kind, R, k, mode, gated = service_fingerprint(_service())
        assert (device_kind, R, k, mode, gated) == ("cpu", 8, 4, "plain", False)

    @pytest.mark.parametrize("bad", [dict(coalesce_bytes=0), dict(coalesce_bytes=128, max_inflight_bytes=64)])
    def test_knob_validation_equals_jax(self, bad):
        with pytest.raises(ValueError) as a:
            _service(**bad)
        with pytest.raises(ValueError) as b:
            JService(JConfig(**_cfg()), key=0, **bad)
        assert str(a.value) == str(b.value)

    def test_apply_knobs_validates_and_applies(self):
        svc = _service(ttl_s=5.0, checkpoint_dir=None)
        svc.apply_knobs(WINNER)
        assert svc.live_knobs() == WINNER
        assert svc.bridge.checkpoint_every == WINNER.checkpoint_every
        with pytest.raises(ValueError, match="must not exceed"):
            svc.apply_knobs(WINNER._replace(coalesce_bytes=1 << 23))
        svc.apply_knobs(WINNER._replace(sweep_interval_s=0.0))
        assert svc._sweep_interval_s is None


# --------------------------------------------------------- the online tuner


SCRIPT = ["warn", "warn", "ok", "ok", "ok", "page", "ok", "ok", "ok", "ok", "ok", "warn", "ok", "ok",
          "ok", "ok", "ok", "ok", "ok", "ok"]


@pytest.mark.parametrize("setup", [
    dict(),
    dict(ttl_s=30.0, sweep_interval_s=1.0),
    dict(gated=True, gate_push_chunk=1 << 16),
    dict(tuner=dict(backoff_factor=0.25, probe_step=1.0, healthy_dwell=1)),
    dict(tuner=dict(bounds=KnobBounds(coalesce_bytes=(1 << 15, 1 << 20)))),
], ids=["default", "ttl", "gated", "steep", "bounds"])
def test_tuner_decisions_equal_the_jax_tuner(setup):
    """The control law, on the same scripted verdicts: every decision
    (verdict, action, knobs, streak) and the knobs it leaves equal the JAX
    tuner's."""
    setup = dict(setup)
    tkw = setup.pop("tuner", {})
    if "bounds" in tkw:
        jkw = dict(tkw, bounds=jtune.KnobBounds(**{k: getattr(tkw["bounds"], k)
                                                   for k in ("coalesce_bytes", "max_inflight_bytes",
                                                             "checkpoint_every", "sweep_interval_s",
                                                             "gate_push_chunk")}))
    else:
        jkw = tkw
    knobs = dict(coalesce_bytes=1 << 16, max_inflight_bytes=1 << 24, checkpoint_every=64)
    svc = _service(**knobs, **setup)
    jsvc = JService(JConfig(**_cfg()), key=0, **knobs, **setup)
    t = ServiceTuner(svc, _ScriptedPlane(SCRIPT), interval_s=0.0, clock=lambda: 0.0, **tkw)
    j = JTuner(jsvc, _ScriptedPlane(SCRIPT), interval_s=0.0, clock=lambda: 0.0, **jkw)
    assert t._active == j._active
    for step in range(len(SCRIPT)):
        a, b = t.observe(float(step)), j.observe(float(step))
        assert (a.verdict, a.action, tuple(a.knobs), a.healthy_streak) == \
            (b.verdict, b.action, tuple(b.knobs), b.healthy_streak), step
        assert tuple(svc.live_knobs()) == tuple(jsvc.live_knobs())
    assert (t.backoffs, t.probes) == (j.backoffs, j.probes)
    assert t.backoffs > 0 and t.probes > 0


def _tuned_service(fake, *, fault_times=30, dwell=2, probe_step=0.25, ttl_s=None):
    clock = lambda: fake[0]  # noqa: E731
    fp = FaultPlane([FaultRule(site="serve.ingest", exc=None, delay=0.002, times=fault_times)])
    svc = _service(ttl_s=ttl_s, faults=fp, coalesce_bytes=DEFAULT_KNOBS.coalesce_bytes,
                   max_inflight_bytes=DEFAULT_KNOBS.max_inflight_bytes,
                   checkpoint_every=DEFAULT_KNOBS.checkpoint_every)
    tuner = ServiceTuner(svc, SLOPlane([_burn_spec()], clock=clock), interval_s=1.0, healthy_dwell=dwell,
                         probe_step=probe_step, clock=clock)
    svc.open_session("s")
    return svc, tuner


class TestTunerBackoff:
    def test_warn_backs_off_within_one_window(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake)
        before = svc.live_knobs()
        svc.ingest("s", CHUNK)  # delayed 2 ms, far past the 0.1 ms threshold
        assert tuner.backoffs == 1 and len(tuner.decisions) == 1
        d = tuner.decisions[0]
        assert d.verdict == "warn" and d.action == "backoff"
        after = svc.live_knobs()
        assert after.coalesce_bytes == before.coalesce_bytes // 2
        assert after.max_inflight_bytes == before.max_inflight_bytes // 2
        assert after.checkpoint_every == before.checkpoint_every * 2

    def test_frozen_clock_rate_limits_the_hook(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake)
        for _ in range(5):
            svc.ingest("s", CHUNK)
        assert len(tuner.decisions) == 1

    def test_inert_knobs_never_touched(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake, ttl_s=None)
        before = svc.live_knobs()
        svc.ingest("s", CHUNK)
        after = svc.live_knobs()
        assert after.sweep_interval_s == before.sweep_interval_s
        assert after.gate_push_chunk == before.gate_push_chunk

    def test_sustained_burn_parks_at_the_bounds(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake, fault_times=10_000)
        for step in range(12):
            svc.ingest("s", CHUNK)
            fake[0] = float(step + 1) * 2.0
        live = svc.live_knobs()
        assert live.coalesce_bytes == DEFAULT_BOUNDS.coalesce_bytes[0]
        assert live.max_inflight_bytes == DEFAULT_BOUNDS.max_inflight_bytes[0]
        assert live.checkpoint_every == DEFAULT_BOUNDS.checkpoint_every[1]
        assert tuner.decisions[-1].action == "hold"

    def test_param_validation(self):
        svc = _service()
        for bad in ({"backoff_factor": 0.0}, {"backoff_factor": 1.0}, {"probe_step": 0.0},
                    {"healthy_dwell": 0}):
            with pytest.raises(ValueError):
                ServiceTuner(svc, _ScriptedPlane([]), attach=False, **bad)


class TestTunerRecovery:
    def test_healthy_dwell_reprobes_to_the_optimum(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake, fault_times=1, probe_step=1.0)
        optimum = tuner.optimum
        svc.ingest("s", CHUNK)
        assert tuner.backoffs == 1
        assert svc.live_knobs() != optimum
        for step in range(1, 4):
            fake[0] = float(step) * 2.0
            svc.ingest("s", CHUNK)
        assert tuner.probes >= 1
        assert svc.live_knobs() == optimum
        fake[0] += 2.0
        svc.ingest("s", CHUNK)
        assert tuner.decisions[-1].action == "hold"

    def test_probe_approaches_monotonically_without_overshoot(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake, fault_times=1, probe_step=0.25)
        optimum = tuner.optimum
        svc.ingest("s", CHUNK)
        seen = [svc.live_knobs().coalesce_bytes]
        for step in range(1, 12):
            fake[0] = float(step) * 2.0
            svc.ingest("s", CHUNK)
            seen.append(svc.live_knobs().coalesce_bytes)
        assert all(b >= a for a, b in zip(seen, seen[1:]))
        assert all(v <= optimum.coalesce_bytes for v in seen)
        assert seen[-1] > seen[0]


class TestTunerTelemetry:
    def test_decisions_land_in_instruments(self, registry):
        fake = [0.0]
        svc, tuner = _tuned_service(fake, fault_times=1, probe_step=1.0)
        svc.ingest("s", CHUNK)
        for step in range(1, 4):
            fake[0] = float(step) * 2.0
            svc.ingest("s", CHUNK)
        assert tuner.backoffs >= 1 and tuner.probes >= 1
        assert registry.counter("tune.backoffs").value == tuner.backoffs
        assert registry.counter("tune.probes").value == tuner.probes
        live = svc.live_knobs()
        assert registry.gauge("tune.coalesce_bytes").value == float(live.coalesce_bytes)
        assert registry.gauge("tune.checkpoint_every").value == float(live.checkpoint_every)

    def test_decision_deque_is_bounded(self):
        svc = _service()
        tuner = ServiceTuner(svc, _ScriptedPlane(["ok"] * 10), interval_s=0.0, clock=lambda: 0.0,
                             max_decisions=4)
        for step in range(10):
            tuner.observe(float(step))
        assert len(tuner.decisions) == 4


# ------------------------------------------------------- advisory-only proof


def _drive(ckdir, with_tuner):
    svc = ReservoirService(SamplerConfig(**_cfg()), key=3, ttl_s=60.0, checkpoint_dir=ckdir,
                           checkpoint_every=2, coalesce_bytes=DEFAULT_KNOBS.coalesce_bytes,
                           max_inflight_bytes=DEFAULT_KNOBS.max_inflight_bytes, device="cpu")
    if with_tuner:
        fake = [0.0]
        tuner = ServiceTuner(svc, SLOPlane([_burn_spec()], clock=lambda: fake[0]), interval_s=0.0, clock=lambda: fake[0])
    for i in range(4):
        svc.open_session(f"s{i}")
    rng = np.random.default_rng(7)
    for step in range(12):
        if with_tuner:
            fake[0] = float(step)
        svc.ingest(f"s{step % 4}", rng.integers(0, 1 << 20, 64).astype(np.int32))
    svc.close_session("s1")
    svc.sync()
    svc.shutdown()
    if with_tuner:
        assert len(tuner.decisions) > 0 and tuner.backoffs == tuner.probes == 0
    out = {}
    for name in sorted(os.listdir(ckdir)):
        path = os.path.join(ckdir, name)
        if os.path.isfile(path) and name != "engine.npz":  # the npz zip stamps its write time
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def test_tuner_at_optimum_is_byte_invisible(tmp_path):
    a = _drive(str(tmp_path / "plain"), with_tuner=False)
    b = _drive(str(tmp_path / "tuned"), with_tuner=True)
    assert set(a) == set(b) and "sessions.jsonl" in a and "journal.bin" in a
    for name in a:
        assert a[name] == b[name], name
