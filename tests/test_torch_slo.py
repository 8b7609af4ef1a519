"""The port's SLO plane and exporters (``obs/slo.py``, ``obs/export.py``)
against the JAX package's, on the CPU.

- ``default_slos`` (scoped or not) and every spec's validation, budget and
  objective line equal the JAX package's;
- over the same recorded events (counters, latency histograms, an injected
  clock) the port's ``SLOPlane`` gives the JAX plane's verdicts, burn
  rates and values at every evaluation, and the Prometheus text and the
  JSON snapshot of the two registries are equal;
- the plane judges the port's service: a delay fault at ``serve.ingest``
  pages the latency objective, a failing ingest pages the error rate, a
  heartbeat carries the worst verdict, and a shard unit judges its own
  scoped instruments.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from reservoir_tpu.obs import export as jexport
from reservoir_tpu.obs import registry as jobs
from reservoir_tpu.obs import slo as jslo
from reservoir_tpu_torch import SamplerConfig
from reservoir_tpu_torch.errors import SessionIngestError, TransientDeviceError
from reservoir_tpu_torch.obs import registry as obs
from reservoir_tpu_torch.obs import slo as tslo
from reservoir_tpu_torch.obs.export import json_snapshot, prometheus_text
from reservoir_tpu_torch.obs.slo import KINDS, SLOPlane, SLOSpec, default_slos
from reservoir_tpu_torch.serve import HeartbeatWriter, ReservoirService, ShardUnit
from reservoir_tpu_torch.serve import service as service_module
from reservoir_tpu_torch.utils import faults
from reservoir_tpu_torch.utils.faults import FaultPlane, FaultRule


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    obs.disable()
    jobs.disable()
    faults.uninstall()
    yield
    obs.disable()
    jobs.disable()
    faults.uninstall()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _spec_view(spec):
    return dataclasses.astuple(spec), spec.error_budget(), spec.objective()


def _cfg(**kw):
    kw.setdefault("max_sample_size", 4)
    kw.setdefault("num_reservoirs", 8)
    kw.setdefault("tile_size", 16)
    return SamplerConfig(**kw)


# ------------------------------------------------------------------ the specs


@pytest.mark.parametrize("scope", [None, "shard0", "shard3"])
def test_default_slos_equal_the_jax_packages(scope):
    kw = dict(ingest_p99_s=0.02, staleness_s=5.0, error_budget=0.05, short_window_s=30.0)
    ours, theirs = default_slos(scope=scope, **kw), jslo.default_slos(scope=scope, **kw)
    assert [_spec_view(s) for s in ours] == [_spec_view(s) for s in theirs]
    assert KINDS == jslo.KINDS


@pytest.mark.parametrize(
    "bad",
    [
        dict(kind="nope"),
        dict(kind="latency_quantile", quantile=1.0, threshold=1.0),
        dict(kind="latency_quantile", threshold=0.0),
        dict(kind="error_rate"),
        dict(kind="error_rate", total_instrument="t", budget=0.0),
        dict(kind="staleness", threshold=1.0, short_window_s=10, long_window_s=5),
        dict(kind="staleness", threshold=1.0, warn_burn=20.0, page_burn=10.0),
    ],
)
def test_spec_validation_equals_the_jax_packages(bad):
    with pytest.raises(ValueError) as ours:
        SLOSpec("x", instrument="h", **bad)
    with pytest.raises(ValueError) as theirs:
        jslo.SLOSpec("x", instrument="h", **bad)
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------- the verdicts


def _specs(module):
    return [
        module.SLOSpec("lat", "latency_quantile", "h", threshold=0.01, quantile=0.99,
                       short_window_s=60, long_window_s=600),
        module.SLOSpec("stale", "staleness", "s", threshold=1.0, quantile=0.9,
                       short_window_s=30, long_window_s=300),
        module.SLOSpec("err", "error_rate", "bad", total_instrument="total", budget=0.01,
                       short_window_s=60, long_window_s=600),
        module.SLOSpec("quality", "sample_quality", "q_bad", total_instrument="q_total",
                       budget=0.05, value_instrument="q_value"),
        module.SLOSpec("unfed", "error_rate", "never", total_instrument="never_total"),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_verdicts_equal_the_jax_planes_over_the_same_events(seed):
    """Bursts of slow and failing requests between quiet stretches, each
    step fed to both registries and judged by both planes at the same
    injected time: every verdict, burn rate, delta and value is equal, and
    so are both exporters' output."""
    clock = _Clock()
    regs = [obs.Registry(), jobs.Registry()]
    planes = [SLOPlane(_specs(tslo), regs[0], clock=clock), jslo.SLOPlane(_specs(jslo), regs[1], clock=clock)]
    rng = np.random.default_rng(seed)
    seen = set()
    for step in range(40):
        burst = rng.random() < 0.25
        n = int(rng.integers(0, 200))
        lat = np.exp(rng.uniform(np.log(1e-4), np.log(0.5 if burst else 0.02), n))
        stale = rng.uniform(0.0, 3.0 if burst else 0.8, n // 4)
        bad = int(rng.binomial(n, 0.3 if burst else 0.002))
        qbad = int(rng.integers(0, 3))
        value = float(rng.uniform(0, 0.2))
        for reg in regs:
            for x in lat:
                reg.histogram("h").observe(float(x))
            for x in stale:
                reg.histogram("s").observe(float(x))
            reg.counter("total").inc(n)
            reg.counter("bad").inc(bad)
            reg.counter("q_total").inc(10)
            reg.counter("q_bad").inc(qbad)
            reg.gauge("q_value").set(value)
        clock.t += float(rng.uniform(1, 90))
        got = [{k: v.as_dict() for k, v in p.evaluate().items()} for p in planes]
        assert got[0] == got[1], step
        assert planes[0].worst() == planes[1].worst()
        seen.update(v["verdict"] for v in got[0].values())
    assert seen == {"ok", "warn", "page"}
    assert prometheus_text(regs[0], include_blocks=False) == jexport.prometheus_text(
        regs[1], include_blocks=False)
    fixed = lambda: 5.0  # noqa: E731
    assert json_snapshot(regs[0], include_blocks=False, clock=fixed) == jexport.json_snapshot(
        regs[1], include_blocks=False, clock=fixed)
    assert regs[0].slo_plane is planes[0]


def test_a_plane_without_a_registry_is_inert_and_detached_planes_do_not_attach():
    plane = SLOPlane()
    assert plane.evaluate() == {} and plane.worst() == "ok"
    reg = obs.Registry()
    SLOPlane(default_slos(scope="shard1"), reg, attach=False)
    assert getattr(reg, "slo_plane", None) is None
    with pytest.raises(ValueError, match="duplicate SLO names"):
        SLOPlane([SLOSpec("a", "staleness", "h", threshold=1.0)] * 2, reg)


# ------------------------------------------------------- over the port's service


def _drive(svc, n=30, chunk=32):
    svc.open_session("u1")
    pos = 0
    for _ in range(n):
        svc.ingest("u1", np.arange(pos, pos + chunk, dtype=np.int32))
        pos += chunk


def test_a_delay_fault_at_ingest_pages_the_latency_objective():
    spec = SLOSpec("ingest_latency_p99", "latency_quantile", "serve.ingest_s", threshold=0.005,
                   quantile=0.99)
    with obs.active() as reg:
        plane = SLOPlane([spec], reg)
        _drive(ReservoirService(_cfg(), coalesce_bytes=1 << 20, device="cpu"))
        assert plane.evaluate()["ingest_latency_p99"].verdict == "ok"
    with obs.active() as reg:
        plane = SLOPlane([spec], reg)
        svc = ReservoirService(_cfg(), coalesce_bytes=1 << 20, device="cpu",
                               faults=FaultPlane([FaultRule("serve.ingest", exc=None, delay=0.02)]))
        _drive(svc, n=10)
        v = plane.evaluate()["ingest_latency_p99"]
        assert v.verdict == "page" and v.value > 0.005


def test_failing_ingests_page_the_error_rate_objective():
    spec = SLOSpec("ingest_error_rate", "error_rate", "serve.ingest_errors",
                   total_instrument="serve.ingest_total", budget=0.01)
    rule = FaultRule("serve.ingest", exc=TransientDeviceError, after=2, every=2)
    with obs.active() as reg:
        plane = SLOPlane([spec], reg)
        svc = ReservoirService(_cfg(), coalesce_bytes=1 << 20, device="cpu", faults=FaultPlane([rule]))
        svc.open_session("u1")
        failures = 0
        for _ in range(20):
            try:
                svc.ingest("u1", np.arange(16, dtype=np.int32))
            except SessionIngestError:
                failures += 1
        v = plane.evaluate()["ingest_error_rate"]
        assert failures > 0 and v.verdict == "page" and v.total == 20 and v.bad == failures


def test_the_heartbeat_carries_the_worst_verdict(tmp_path):
    spec = SLOSpec("err", "error_rate", "bad", total_instrument="total", budget=0.01)
    with obs.active() as reg:
        SLOPlane([spec], reg)
        reg.counter("bad").inc(10)
        reg.counter("total").inc(10)
        svc = ReservoirService(_cfg(), checkpoint_dir=str(tmp_path), coalesce_bytes=1 << 20,
                               device="cpu")
        payload = HeartbeatWriter(str(tmp_path), service=svc).beat()
        assert payload["slo_worst"] == "page"
        assert payload["telemetry"]["slo"]["verdicts"]["err"]["verdict"] == "page"
        svc.shutdown()


class _SteppedClock:
    """The ``time`` module of the service and of the fault plane, as a test
    sees it: ``perf_counter`` reads a clock that only ``sleep`` moves, so an
    ingest's recorded latency is its injected delay and nothing of the
    host's scheduling (which stalls a process for 5 ms and more now and
    then, with no work in its way); every other name is the real module's."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds

    def __getattr__(self, name):
        return getattr(time, name)


def test_a_shard_unit_judges_its_own_scoped_instruments(tmp_path, monkeypatch):
    """Unit 0's ingests take 20 ms (a delay fault), unit 1's none, on the
    stepped clock: unit 0's latency objective (5 ms) pages and every
    objective of unit 1 stays ok, which it does only while each unit's plane
    reads its own scoped instruments (both planes take their baseline
    before either unit ingests, so a plane that read the other unit's
    observations would see them)."""
    clock = _SteppedClock()
    monkeypatch.setattr(service_module, "time", clock)
    monkeypatch.setattr(faults, "time", clock)
    with obs.active() as reg:
        units = [ShardUnit(_cfg(), i, str(tmp_path / f"shard{i}"), key=i, device="cpu",
                           slo_kwargs={"ingest_p99_s": 0.005}) for i in range(2)]
        units[0].service._faults = FaultPlane([FaultRule("serve.ingest", exc=None, delay=0.02)])
        for unit in units:  # each plane's baseline, before either unit ingests
            assert set(unit.slo_verdicts().values()) == {"ok"}
        for unit in units:
            _drive(unit.service, n=6)
        verdicts = [unit.slo_verdicts() for unit in units]
        # what a failure reports: each ingest histogram that exists, by name
        names = [obs.scoped("serve.ingest_s", u.obs_scope) for u in units] + ["serve.ingest_s"]
        latencies = {n: reg.peek(n).snapshot() for n in names if reg.peek(n) is not None}
        assert sorted(verdicts[0]) == sorted(s.name for s in default_slos())
        assert verdicts[0]["ingest_latency_p99"] == "page", (verdicts[0], latencies)
        assert set(verdicts[1].values()) == {"ok"}, (verdicts[1], latencies)
        assert units[0].status()["slo_worst"] == "page"
        for unit in units:
            unit.shutdown()
    assert units[1].slo_verdicts() == {}
