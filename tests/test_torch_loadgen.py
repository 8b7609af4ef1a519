"""The port's serving-plane load tools (``reservoir_tpu_torch/tools/``)
against the JAX package's ``tools/loadgen.py`` and
``tools/serve_knob_sweep.py``: ``run_load`` on the port's service on the
CPU, under an injected clock, counts what the JAX harness counts on the
JAX service for the same ``LoadSpec`` (a Poisson schedule, and a bursty
one with churn and eviction pressure); ``sweep_knobs`` over a two-candidate
grid picks the JAX sweep's winner by the lexicographic rule; the module
runs as ``python -m reservoir_tpu_torch.tools.loadgen --device cpu``; and
``tools/reservoir_top.py`` and ``tools/postmortem.py`` render a heartbeat
of the port's ``HeartbeatWriter`` and a bundle of its ``FlightRecorder``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reservoir_tpu import obs as jobs
from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.serve import ReservoirService as JService
from reservoir_tpu.serve.autotune import DEFAULT_KNOBS as J_DEFAULT_KNOBS
from reservoir_tpu_torch import SamplerConfig, obs
from reservoir_tpu_torch.serve import HeartbeatWriter, ReservoirService, StandbyReplica
from reservoir_tpu_torch.serve.autotune import DEFAULT_KNOBS
from reservoir_tpu_torch.tools import loadgen, serve_knob_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
import loadgen as jloadgen  # noqa: E402
import postmortem  # noqa: E402
import reservoir_top  # noqa: E402
from tools import serve_knob_sweep as jsweep  # noqa: E402

del sys.path[:2]

#: seconds a child process may take
TIMEOUT = 120
#: the table's rows, k and tile: a universe of 60 sessions over 16 rows
#: evicts and recycles
ROWS, K, TILE = 16, 4, 32
#: explicit knobs (no knob-cache read): a 4 KiB coalesce buffer flushes
#: every few arrivals
KNOBS = dict(coalesce_bytes=4096, max_inflight_bytes=1 << 20, checkpoint_every=1 << 30, gate_push_chunk=1 << 20,
             sweep_interval_s=None)
SPECS = {
    "poisson": dict(duration_s=0.5, rate=200.0, sessions=60, zipf_s=0.6, chunk=16, snapshot_every=7, seed=1),
    "bursty_churn": dict(duration_s=0.5, rate=240.0, arrivals="bursty", sessions=60, zipf_s=0.6, chunk=16,
                         churn=0.1, snapshot_every=5, seed=2),
}


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


class _Clock:
    """A clock that only the harness moves: each read advances it 0.1 ms
    (the work between reads), each sleep by what it asks."""

    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 1e-4
        return self.t

    def sleep(self, d: float) -> None:
        self.t += d


def _services():
    cfg = dict(max_sample_size=K, num_reservoirs=ROWS, tile_size=TILE)
    return (JService(JConfig(**cfg), key=0, pipelined=False, **KNOBS),
            ReservoirService(SamplerConfig(**cfg), key=0, pipelined=False, device="cpu", **KNOBS))


@pytest.mark.parametrize("shape", list(SPECS))
def test_run_load_counts_what_the_jax_harness_counts(shape):
    jsvc, tsvc = _services()
    results = []
    for module, svc, plane in ((jloadgen, jsvc, jobs), (loadgen, tsvc, obs)):
        plane.enable(plane.Registry())
        clock = _Clock()
        results.append(module.run_load(svc, module.LoadSpec(**SPECS[shape]), clock=clock, sleep=clock.sleep))
        plane.disable()
    want, got = (r.snapshot() for r in results)
    assert got["offered"] > 50 and got["opens"] > 0 and got["snapshots"] > 0
    if shape == "bursty_churn":
        assert got["closes"] > 0
    assert got["reopens"] > 0  # the table evicted leases under pressure
    # every count, the waits on the injected clock included
    assert got == want
    tm = tsvc.metrics.snapshot()
    assert tm["evictions"] > 0 and tm["recycles"] > 0
    assert tm == jsvc.metrics.snapshot()
    tsvc.shutdown()
    jsvc.shutdown()


def test_sweep_knobs_picks_the_jax_sweeps_winner(tmp_path):
    """Two candidates: one whose admission budget is below a request's
    bytes (every ingest an error: its error-rate objective pages) ahead of
    the defaults.  The lexicographic rule puts the defaults first in both
    sweeps, and both record them under the same fingerprints."""
    cfg = dict(max_sample_size=K, num_reservoirs=ROWS, tile_size=TILE)
    spec = dict(duration_s=0.2, rate=200.0, sessions=60, chunk=16, seed=3)
    reports = []
    for sweep, svc_cls, config, defaults, plane, kw in (
        (jsweep, JService, JConfig, J_DEFAULT_KNOBS, jobs, {}),
        (serve_knob_sweep, ReservoirService, SamplerConfig, DEFAULT_KNOBS, obs, {"device": "cpu"}),
    ):
        def make(knobs, svc_cls=svc_cls, config=config, kw=kw):
            return svc_cls(config(**cfg), key=0, pipelined=False, coalesce_bytes=knobs.coalesce_bytes,
                           max_inflight_bytes=knobs.max_inflight_bytes, checkpoint_every=knobs.checkpoint_every,
                           sweep_interval_s=knobs.sweep_interval_s or None, gate_push_chunk=knobs.gate_push_chunk,
                           **kw)

        tight = defaults._replace(coalesce_bytes=32, max_inflight_bytes=32)
        errors_only = [s for s in plane.default_slos() if s.name == "ingest_error_rate"]
        reports.append(sweep.sweep_knobs(
            make, sweep.LoadSpec(**spec), [tight, defaults],
            slo_factory=lambda plane=plane, specs=errors_only: plane.SLOPlane(specs),
            cache_path=str(tmp_path / f"{plane.__name__}.json"),
        ))
    want, got = reports
    assert got["winner_index"] == want["winner_index"] == 1
    assert got["winner"] == want["winner"]
    for w, g in zip(want["candidates"], got["candidates"]):
        assert (g["pages"], g["warns"], g["completed"], g["errors"]) == (w["pages"], w["warns"], w["completed"],
                                                                       w["errors"])
        assert g["slo"] == w["slo"]
    assert got["candidates"][0]["pages"] == 1 and got["candidates"][0]["completed"] == 0
    assert got["recorded"] == want["recorded"] and len(got["recorded"]) == 2  # the fingerprints


def test_loadgen_runs_as_a_module_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "reservoir_tpu_torch.tools.loadgen", "--device", "cpu", "--rate", "100",
         "--duration", "0.3", "--sessions", "40", "--churn", "0.05", "--k", "4", "--tile", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["result"]["offered"] == report["result"]["completed"] > 0
    assert report["spec"]["rate"] == 100.0
    assert set(report["slo"]) >= {"ingest_latency_p99", "sample_quality"}


def test_reservoir_top_renders_the_ports_heartbeat_and_standby(tmp_path):
    with obs.active():
        ckdir = str(tmp_path / "ck")
        svc = ReservoirService(SamplerConfig(max_sample_size=4, num_reservoirs=4, tile_size=16), device="cpu",
                               checkpoint_dir=ckdir, checkpoint_every=1 << 30, coalesce_bytes=64)
        svc.open_session("u1")
        svc.ingest("u1", np.arange(64, dtype=np.int32))
        svc.sync()
        standby = StandbyReplica(ckdir, status_path=str(tmp_path / "standby.json"), device="cpu")
        standby.poll()
        HeartbeatWriter(ckdir, service=svc).beat()
        frame = reservoir_top.render(reservoir_top.collect(ckdir, str(tmp_path / "standby.json")))
        assert f"seq={svc.flushed_seq}" in frame
        assert "fence: ok" in frame
        assert "standby: applied_seq=" in frame and "lag_seq=0" in frame
        assert "ingest admission" in frame
        assert "flush (device dispatch)" in frame
        svc.shutdown()


def test_postmortem_renders_a_bundle_of_the_ports_flight_recorder(tmp_path, capsys):
    obs.enable(obs.Registry())
    tracer = obs.trace.enable(sample_every=1)
    recorder = obs.flight.install(dir=str(tmp_path), config={"root_span": "serve.ingest"})
    try:
        svc = ReservoirService(SamplerConfig(max_sample_size=4, num_reservoirs=4, tile_size=16), key=3,
                               device="cpu")
        svc.open_session("a")
        svc.ingest("a", np.arange(64, dtype=np.int32))
        svc.sync()
        svc.close_session("a")
        path = recorder.dump("manual", shard=0)
        svc.shutdown()
    finally:
        obs.flight.uninstall()
        obs.trace.disable()
    assert tracer is not None
    bundle = postmortem.load(str(tmp_path))
    assert bundle["_path"] == path
    text = postmortem.render(bundle)
    assert "reason='manual'" in text
    assert "context: shard=0" in text
    assert "config: root_span=serve.ingest" in text
    assert "span tree" in text and "serve.ingest" in text
    assert postmortem.main([str(tmp_path), "--json", "attribution"]) == 0
    assert json.loads(capsys.readouterr().out)["root"] == "serve.ingest"
