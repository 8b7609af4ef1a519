"""The port's pass-through operator (``reservoir_tpu_torch.stream.operator``)
against the JAX package's (``reservoir_tpu.stream.operator``).

The protocol cases of the JAX package's own operator tests (eager
validation, a fresh sampler a run, pass-through and backpressure,
completion, upstream failure, graceful and caused cancellation, the abrupt
termination backstop, a sampler that fails, distinct flows, ``map_fn``,
async runs, a shared closed sampler) run through both packages with one
seed: what each run emits, delivers or raises must be equal.
``Sample.device(..., device="cpu")`` (the plain torch version behind the
card's kernels) must equal the JAX package's ``Sample.device`` (XLA on the
CPU) under the same key, bit for bit, uniform and distinct, sync and
async; the tolerance is zero."""

from __future__ import annotations

import asyncio
import gc
import types

import numpy as np
import pytest
import torch

import reservoir_tpu.api as JA
import reservoir_tpu_torch.api as TA
from reservoir_tpu.errors import AbruptStreamTermination as JAbrupt
from reservoir_tpu.errors import SamplerClosedError as JClosed
from reservoir_tpu.stream import Sample as JSample
from reservoir_tpu_torch import AbruptStreamTermination, Sample, SamplerClosedError
from reservoir_tpu_torch.stream import AsyncRunningSample, RunningSample

PACKAGES = {
    "jax": types.SimpleNamespace(Sample=JSample, api=JA, Abrupt=JAbrupt, Closed=JClosed),
    "port": types.SimpleNamespace(Sample=Sample, api=TA, Abrupt=AbruptStreamTermination,
                                  Closed=SamplerClosedError),
}


def _norm(x):
    """Results as plain comparable values: ints with their type names,
    exceptions as their type names and messages."""
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.name, x.tolist())
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return (type(x).__name__, int(x))
    return x


class _ExplodingSampler:
    is_open = True

    def sample(self, element):
        raise RuntimeError("sampler exploded")

    def result(self):  # pragma: no cover
        return []


def _case_eager_validation(p):
    out = []
    for build in (lambda: p.Sample(0), lambda: p.Sample(-5), lambda: p.Sample.distinct(0),
                  lambda: p.Sample.distinct(4, hash_fn=42), lambda: p.Sample(4, map_fn=3),
                  lambda: p.Sample.device(0)):
        try:
            build()
            out.append("built")
        except (TypeError, ValueError) as e:
            out.append(type(e).__name__)
    return out


def _case_fresh_sampler_per_run(p):
    flow = p.Sample(4, rng=0)
    return flow.run(range(4)).drain(), flow.run(range(4)).drain(), flow.run(range(100)).drain()


def _case_passthrough(p):
    run = p.Sample(3, rng=1).run(range(100))
    return list(run), run.sample.result(timeout=1)


def _case_pull_based(p):
    consumed = []

    def source():
        for i in range(10):
            consumed.append(i)
            yield i

    run = p.Sample(2, rng=2).run(source())
    trace = [list(consumed)]
    next(run)
    trace.append(list(consumed))
    next(run)
    trace.append(list(consumed))
    return trace


def _case_upstream_finish(p):
    run = p.Sample(8, rng=3).run(range(5))
    for _ in run:
        pass
    return run.sample.result(timeout=1), p.Sample(16, rng=4).run(range(1000)).drain()


def _case_upstream_failure(p):
    boom = RuntimeError("upstream exploded")

    def source():
        yield 1
        yield 2
        raise boom

    run = p.Sample(4, rng=5).run(source())
    seen = []
    with pytest.raises(RuntimeError, match="upstream exploded"):
        for x in run:
            seen.append(x)
    return seen, run.sample.exception(timeout=1) is boom


def _case_graceful_cancel(p):
    run = p.Sample(10, rng=6).run(range(1000))
    for _ in range(5):
        next(run)
    run.cancel()
    res = run.sample.result(timeout=1)
    run.cancel()  # idempotent
    return res, list(run)


def _case_cancel_with_cause(p):
    cause = ValueError("downstream gave up")
    run = p.Sample(10, rng=7).run(range(1000))
    next(run)
    run.cancel(cause)
    run.close()  # the alias, idempotent
    return run.sample.exception(timeout=1) is cause


def _case_abrupt_termination(p):
    run = p.Sample(4, rng=8).run(range(100))
    next(run)
    fut = run.sample
    del run
    gc.collect()
    exc = fut.exception(timeout=1)
    return isinstance(exc, p.Abrupt), str(exc)


def _case_sampler_error(p):
    run = p.Sample.from_factory(lambda: _ExplodingSampler()).run(range(10))
    with pytest.raises(RuntimeError, match="sampler exploded"):
        next(run)
    return run.sample.exception(timeout=1), list(run)


def _case_distinct_and_duplicates(p):
    return (p.Sample.distinct(8, rng=9).run([7] * 100).drain(),
            p.Sample(10, rng=10).run([7] * 10).drain(),
            p.Sample.distinct(16, rng=9).run(np.arange(5_000) % 300).drain(),
            p.Sample.distinct(4, rng=1, hash_fn=lambda v: int(v) * 7,
                              map_fn=lambda v: v % 50).run(range(500)).drain())


def _case_map_fn(p):
    return p.Sample(10, rng=11, map_fn=lambda x: x * 2).run(range(5)).drain(), \
        p.Sample(4, rng=11, map_fn=lambda x: -x, pre_allocate=True).run(range(500)).drain()


def _case_sometimes_sampled(p):
    hits = [5 in p.Sample(3, rng=1000 + t).run(range(6)).drain() for t in range(200)]
    assert 0 < sum(hits) < 200
    return hits


def _case_async_complete(p):
    async def go():
        async def source():
            for i in range(50):
                yield i

        run = p.Sample(8, rng=12).run_async(source())
        seen = [x async for x in run]
        return seen, run.sample.result(timeout=1), [x async for x in run]

    return asyncio.run(go())


def _case_async_failure(p):
    async def go():
        async def source():
            yield 1
            raise RuntimeError("async boom")

        run = p.Sample(8, rng=13).run_async(source())
        with pytest.raises(RuntimeError, match="async boom"):
            async for _ in run:
                pass
        return run.sample

    return asyncio.run(go()).exception(timeout=1)


def _case_async_drain_and_cancel(p):
    async def go():
        async def source():
            for i in range(300):
                yield i

        full = await p.Sample(5, rng=14).run_async(source()).drain()
        run = p.Sample(5, rng=15).run_async(source())
        for _ in range(3):
            await run.__anext__()
        run.cancel()
        return full, run.sample.result(timeout=1)

    return asyncio.run(go())


def _case_shared_closed_sampler(p):
    shared = p.api.sampler(3, rng=42)
    flow = p.Sample.from_factory(lambda: shared)
    first = flow.run(range(10)).drain()
    run2 = flow.run(iter([]))
    with pytest.raises(p.Closed) as info:
        run2.drain()
    return first, str(info.value)


PROTOCOL_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
                  if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_operator_protocol_equals_the_jax_package(case):
    fn = PROTOCOL_CASES[case]
    want, got = (_norm(fn(p)) for p in PACKAGES.values())
    assert got == want


def test_operator_classes_are_exported():
    run = Sample(2, rng=0).run(range(3))
    assert isinstance(run, RunningSample)

    async def go():
        async def source():
            yield 1

        return Sample(2, rng=0).run_async(source())

    assert isinstance(asyncio.run(go()), AsyncRunningSample)


def test_stream_uniformity_5_sigma():
    trials, n, k = 2000, 10, 5
    counts = np.zeros(n)
    flow = Sample(k, rng=np.random.default_rng(8))
    for _ in range(trials):
        for x in flow.run(range(n)).drain():
            counts[x] += 1
    expect = trials * k / n
    sigma = np.sqrt(trials * (k / n) * (1 - k / n))
    assert np.all(np.abs(counts - expect) < 5 * sigma)


# --------------------------------------------------------- Sample.device


def _streams(kind: str):
    rng = np.random.default_rng(21)
    if kind == "uniform":
        return np.arange(1_000, dtype=np.int32) * 7 - 3_000
    if kind == "below_k":
        return np.arange(10, dtype=np.int32)
    keys = np.minimum(rng.random(2_000) ** -10.0, 1e7).astype(np.int64)
    if kind == "distinct64":
        return keys * np.int64(0x9E3779B97F4A7C15 - 2**64)
    return keys.astype(np.int32)


_DEVICE_FLOWS = {
    "uniform": dict(max_sample_size=16, key=3, tile_size=64),
    "below_k": dict(max_sample_size=16, key=0, tile_size=8),
    "distinct32": dict(max_sample_size=16, key=4, tile_size=64, distinct=True),
    "distinct64": dict(max_sample_size=16, key=5, tile_size=64, distinct=True,
                       element_dtype="int64"),
}


@pytest.mark.parametrize("mode", ["sync", "async", "cancel"])
@pytest.mark.parametrize("flow", sorted(_DEVICE_FLOWS))
def test_sample_device_on_the_cpu_equals_the_jax_package(flow, mode):
    kw = _DEVICE_FLOWS[flow]
    stream = _streams(flow)
    out = []
    for make in (lambda: JSample.device(**kw), lambda: Sample.device(**kw, device="cpu")):
        f = make()
        if mode == "sync":
            res = f.run(iter(stream)).drain()
        elif mode == "async":
            async def go(f=f):
                async def source():
                    for x in stream:
                        yield x

                return await f.run_async(source()).drain()

            res = asyncio.run(go())
        else:
            run = f.run(iter(stream))
            for _ in range(len(stream) * 2 // 3):
                next(run)
            run.cancel()
            res = run.sample.result(timeout=5)
        out.append(np.asarray(res))
    assert out[0].dtype == out[1].dtype
    np.testing.assert_array_equal(out[1], out[0])


def test_sample_device_runs_a_fresh_sampler_a_run_and_is_reusable_on_request():
    f = Sample.device(8, key=1, tile_size=32, device="cpu")
    a, b = f.run(range(500)).drain(), f.run(range(500)).drain()
    np.testing.assert_array_equal(a, b)
    j = JSample.device(8, key=1, tile_size=32, reusable=True).run(range(500))
    t = Sample.device(8, key=1, tile_size=32, reusable=True, device="cpu").run(range(500))
    np.testing.assert_array_equal(t.drain(), j.drain())


def test_sample_device_without_a_card_raises_when_the_flow_is_built():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sample.device(8)
    with pytest.raises(ValueError):
        Sample.device(0, device="cpu")
