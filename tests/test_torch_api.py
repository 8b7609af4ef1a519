"""The port's host API (``reservoir_tpu_torch.api``) against the JAX
package's (``reservoir_tpu.api``): factory validation, the lifecycle matrix
{uniform, uniform pre-allocated, distinct} x {single-use, reusable},
``SampleView`` snapshots, the closed-sampler errors and the host weighted
sampler.  Each case runs through both packages from one seed; results,
exception types and messages must be equal."""

from __future__ import annotations

import operator

import numpy as np
import pytest

import reservoir_tpu.api as JA
import reservoir_tpu_torch as T
import reservoir_tpu_torch.api as TA
from reservoir_tpu import MAX_SIZE as J_MAX_SIZE
from reservoir_tpu.errors import SamplerClosedError as JClosed
from reservoir_tpu_torch import MAX_SIZE, SamplerClosedError

PACKAGES = {"jax": (JA, JClosed), "port": (TA, SamplerClosedError)}

FACTORIES = {
    "dup": lambda api, k, **kw: api.sampler(k, **kw),
    "dup_prealloc": lambda api, k, **kw: api.sampler(k, pre_allocate=True, **kw),
    "distinct": lambda api, k, **kw: api.distinct(k, **kw),
}


def _both(fn):
    """``fn(api, closed_error)`` through each package: the outcomes, where
    an exception counts as its type name and message."""
    out = []
    for api, closed in PACKAGES.values():
        try:
            out.append(fn(api, closed))
        except Exception as e:  # noqa: BLE001 - the outcome under comparison
            out.append((type(e).__name__, str(e)))
    return out


def _ints(values):
    return [(type(v).__name__, int(v)) for v in values]


def test_max_size_and_package_exports():
    assert MAX_SIZE == J_MAX_SIZE
    assert T.sampler is TA.sampler and T.distinct is TA.distinct and T.Sampler is TA.Sampler
    with pytest.raises(AttributeError):
        T.no_such_name  # noqa: B018


@pytest.mark.parametrize("bad", [-1, 0, MAX_SIZE + 1, 5.0, True, "map"])
@pytest.mark.parametrize("make", sorted(FACTORIES))
def test_validation_equals_the_jax_package(make, bad):
    def run(api, _):
        if bad == "map":
            FACTORIES[make](api, 5, map_fn="not callable")
        else:
            FACTORIES[make](api, bad)
        return "built"

    out = _both(run)
    assert out[0] == out[1] and out[0] != "built"


def test_distinct_requires_a_callable_hash_as_the_jax_package_does():
    out = _both(lambda api, _: api.distinct(5, hash_fn=42))
    assert out[0] == out[1] and out[0][0] == "TypeError"


@pytest.mark.parametrize("make", sorted(FACTORIES))
def test_max_size_constructs_without_allocating(make):
    assert _both(lambda api, _: FACTORIES[make](api, MAX_SIZE).is_open) == [True, True]


@pytest.mark.parametrize("make", sorted(FACTORIES))
def test_single_use_lifecycle_equals_the_jax_package(make):
    def run(api, closed):
        s = FACTORIES[make](api, 4, rng=0)
        trace = [s.is_open]
        s.sample(1)
        s.sample_all(range(10))
        s.sample_all(np.arange(10, 5_000, dtype=np.int64))
        trace.append(s.is_open)
        trace.append(_ints(s.result()))
        trace.append(s.is_open)
        for op in (lambda: s.sample(1), lambda: s.sample_all([1]), s.result):
            with pytest.raises(closed) as info:
                op()
            trace.append(str(info.value))
        return trace

    out = _both(run)
    assert out[0] == out[1]
    assert out[1][-3:] == ["this sampler is single-use, and no longer open"] * 3


@pytest.mark.parametrize("make", sorted(FACTORIES))
def test_reusable_lifecycle_and_snapshots_equal_the_jax_package(make):
    def run(api, _):
        s = FACTORIES[make](api, 8, reusable=True, rng=1)
        s.sample_all(range(100))
        snap1 = s.result()
        frozen = list(snap1)
        s.sample_all(range(100, 1000))
        s.sample_all(np.arange(1000, 100_000, dtype=np.int64))
        snap2 = s.result()
        return (s.is_open, _ints(snap1), list(snap1) == frozen, _ints(snap2),
                type(snap1).__name__)

    out = _both(run)
    assert out[0] == out[1]
    assert out[1][0] and out[1][2]


def test_sample_view_is_an_immutable_zero_copy_snapshot_as_in_the_jax_package():
    def run(api, _):
        s = api.sampler(16, reusable=True, rng=1)
        s.sample_all(np.arange(1000, dtype=np.int64))
        first = s.result()
        copy = list(first)
        s.sample_all(np.arange(1000, 200_000, dtype=np.int64))
        second = s.result()
        trace = [list(first) == copy, len(second), s.result()._data is s.result()._data,
                 second == list(second), second == tuple(second), second[2:5], repr(second)[:10],
                 hash(second) == hash(tuple(second)), second.__eq__(3) is NotImplemented]
        for op in (lambda: operator.setitem(second, 0, 123), lambda: second.sort()):
            try:
                op()
            except (TypeError, AttributeError) as e:
                trace.append(type(e).__name__)
        return trace, _ints(second)

    out = _both(run)
    assert out[0] == out[1]
    assert out[1][0][-2:] == ["TypeError", "AttributeError"]


def test_duplicates_and_distinct_on_repeats_equal_the_jax_package():
    def run(api, _):
        d = api.sampler(10, rng=0)
        d.sample_all([7] * 10)
        u = api.distinct(10, rng=0)
        u.sample_all([7] * 10)
        m = api.sampler(4, map_fn=lambda x: x * 3, rng=2)
        m.sample_all(range(50))
        g = api.sampler(4, rng=np.random.default_rng(5))
        g.sample_all(range(20))
        return d.result(), u.result(), m.result(), g.result()

    out = _both(run)
    assert out[0] == out[1]
    assert out[1][0] == [7] * 10 and out[1][1] == [7]


@pytest.mark.parametrize("native", [True, False])
def test_native_false_gives_the_same_samples(native):
    z = np.minimum(np.random.default_rng(3).random(50_000) ** -10.0, 1e7).astype(np.int64)
    s = TA.sampler(32, rng=3, native=native)
    s.sample_all(range(300_000))
    d = TA.distinct(64, rng=3, native=native)
    d.sample_all(z)
    j = JA.sampler(32, rng=3)
    j.sample_all(range(300_000))
    jd = JA.distinct(64, rng=3)
    jd.sample_all(z)
    assert _ints(s.result()) == _ints(j.result()) and _ints(d.result()) == _ints(jd.result())


@pytest.mark.parametrize("case", ["single_use", "reusable_zero_weights", "negative", "naive",
                                  "arrays", "bad_arrays"])
def test_weighted_host_sampler_equals_the_jax_package(case):
    def run(api, closed):
        if case == "single_use":
            s = api.weighted(4, rng=0)
            s.sample_all((i, 1.0) for i in range(100))
            res = [s.is_open, _ints(s.result()), s.is_open]
            with pytest.raises(closed):
                s.sample(1, 1.0)
            return res
        if case == "reusable_zero_weights":
            s = api.weighted(4, rng=1, reusable=True)
            s.sample_all((i, 0.0 if i % 2 else 1.0) for i in range(200))
            first = _ints(s.result())
            s.sample(7, 2.0)
            return first, s.is_open, _ints(s.result())
        if case == "negative":
            return api.weighted(4, rng=2).sample(1, -0.5)
        if case == "naive":
            s = api.weighted(3, rng=3, naive=True)
            s.sample_all((i, 1.0) for i in range(10))
            return _ints(s.result())
        rng = np.random.default_rng(5)
        elems = np.arange(10_000, dtype=np.int64)
        wts = rng.random(10_000) + 0.1
        s = api.weighted(32, rng=9)
        if case == "bad_arrays":
            return s.sample_all(elems, wts[:-1])
        s.sample_all(elems, wts)
        t = api.weighted(32, rng=9)
        t.sample_all(zip(elems.tolist(), wts.tolist()))
        return _ints(s.result()), _ints(t.result())

    out = _both(run)
    assert out[0] == out[1]
    if case in ("negative", "bad_arrays"):
        assert out[1][0] == "ValueError"
