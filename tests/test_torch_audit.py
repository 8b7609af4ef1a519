"""The port's ``SampleQualityAuditor`` (``obs/audit.py``) against the JAX
package's: fed the same ingests and snapshots, it publishes the same
``audit.*`` counters and gauges and keeps the same last readings, in each
of the reference's scenarios; and a port ``ReservoirService`` with the
port's auditor publishes the same ``audit.*`` instruments as the JAX
service with the JAX auditor."""

from __future__ import annotations

import numpy as np
import pytest

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.obs import registry as jobs
from reservoir_tpu.obs.audit import SampleQualityAuditor as JAuditor
from reservoir_tpu.serve.service import ReservoirService as JService
from reservoir_tpu_torch import SamplerConfig
from reservoir_tpu_torch.obs import registry as obs
from reservoir_tpu_torch.obs.audit import SampleQualityAuditor
from reservoir_tpu_torch.serve import ReservoirService


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("RESERVOIR_ALGL_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _audit_view(reg) -> dict:
    """A registry's ``audit.*`` counters and gauges."""
    snap = reg.snapshot()
    return {kind: {name: value for name, value in snap[kind].items() if name.startswith("audit.")}
            for kind in ("counters", "gauges")}


def _honest(aud, rng):
    for _ in range(40):
        aud.observe_snapshot("s", rng.integers(0, 5000, 16), 5000)


def _low_half(aud, rng):
    for _ in range(40):
        aud.observe_snapshot("s", rng.integers(0, 2500, 16), 5000)


def _opaque(aud, rng):
    for _ in range(20):
        aud.observe_snapshot("s", np.full(16, 10_000_000, np.int64), 100)


def _strata(aud, rng):
    for _ in range(40):
        aud.record_ingest("s", rng.integers(0, 4096, 128))
        aud.observe_snapshot("s", rng.integers(0, 2048, 16) * 2, 4096)


#: scenario -> (auditor arguments, feed)
SCENARIOS = {
    "honest": ({"min_pool": 256}, _honest),
    "low_half_bias": ({"min_pool": 256}, _low_half),
    "opaque_values": ({"min_pool": 64}, _opaque),
    "stratum_bias": ({"min_pool": 512, "strata": 4, "min_stratum_count": 256, "stratum_gate": 0.5},
                     _strata),
    "scoped": ({"min_pool": 64, "obs_scope": "shard3"}, _low_half),
    "custom_strata": ({"min_pool": 128, "strata": 3, "stratum_of": lambda a: (a // 7) % 3,
                       "min_stratum_count": 64}, _strata),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_auditor_publishes_the_jax_auditors_instruments(scenario):
    kwargs, feed = SCENARIOS[scenario]
    views, lasts = [], []
    for cls, plane in ((JAuditor, jobs), (SampleQualityAuditor, obs)):
        aud = cls(**kwargs)
        with plane.active() as reg:
            feed(aud, np.random.default_rng(3))
            views.append(_audit_view(reg))
        lasts.append((aud.last_ks, aud.last_stratum_dev, aud._pool_n,
                      aud._ingested.tolist(), aud._included.tolist()))
    assert views[0] == views[1]
    assert lasts[0] == lasts[1]
    if scenario != "opaque_values":
        assert views[1]["counters"]  # something was checked


def test_auditor_is_a_no_op_while_telemetry_is_off():
    aud = SampleQualityAuditor(min_pool=8)
    aud.record_ingest("s", np.arange(100))
    aud.observe_snapshot("s", np.arange(16), 100)
    assert aud.last_ks is None
    assert aud._pool_n == 0 and int(aud._ingested.sum()) == 0


@pytest.mark.parametrize("args, match", [({"min_pool": 4}, "min_pool"), ({"strata": 1}, "strata")])
def test_auditor_rejects_what_the_jax_auditor_rejects(args, match):
    with pytest.raises(ValueError, match=match) as want:
        JAuditor(**args)
    with pytest.raises(ValueError, match=match) as got:
        SampleQualityAuditor(**args)
    assert str(got.value) == str(want.value)


def test_service_with_the_ports_auditor_equals_the_jax_service_with_the_jax_auditor():
    views = []
    for svc_cls, cfg_cls, aud_cls, plane, kw in (
        (JService, JConfig, JAuditor, jobs, {}),
        (ReservoirService, SamplerConfig, SampleQualityAuditor, obs, {"device": "cpu"}),
    ):
        with plane.active() as reg:
            svc = svc_cls(cfg_cls(max_sample_size=8, num_reservoirs=8, tile_size=16), key=0,
                          auditor=aud_cls(min_pool=64, strata=4, min_stratum_count=32),
                          coalesce_bytes=256, **kw)
            pos = {"u1": 0, "u2": 0}
            for key in pos:
                svc.open_session(key)
            for _ in range(12):
                for key in pos:
                    svc.ingest(key, np.arange(pos[key], pos[key] + 64, dtype=np.int32))
                    pos[key] += 64
                    svc.snapshot(key)  # sync read: the audited path
                svc.snapshot("u1", sync=False)  # not audited
            views.append(_audit_view(reg))
    assert views[0] == views[1]
    assert views[1]["counters"]["audit.ks_checks"] >= 1
