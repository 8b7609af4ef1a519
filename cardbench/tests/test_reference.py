"""The references against the program's plain versions on the CPU, which
the program's own tests hold against its kernels on the card: the same
words at every step.  Only the tests import the program; the references do
not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench.reference import common
from cardbench.reference import distinct as dref
from cardbench.reference import weighted as wref
from reservoir_tpu_torch.ops import distinct as pd
from reservoir_tpu_torch.ops import fmath, prefix
from reservoir_tpu_torch.ops import weighted as pw
from reservoir_tpu_torch.ops.threefry import threefry2x32


def _promotion_states():
    """NumPy's promotion rules under which the references must give the same
    words: the running NumPy's, and the legacy ones where it can switch."""
    return ["legacy", "weak"] if hasattr(np, "_set_promotion_state") else [None]


@pytest.fixture(params=_promotion_states())
def promotion(request):
    if request.param is None:
        yield
        return
    old = np._get_promotion_state()
    np._set_promotion_state(request.param)
    try:
        yield
    finally:
        np._set_promotion_state(old)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def test_the_float_steps_round_as_the_programs(promotion):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(20000).astype(np.float32) * 40,
                        np.array([0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, 1e38, -88, 89, 1.0], np.float32)])
    pos = np.abs(x)
    assert (_bits(wref.log(pos)) == _bits(fmath.log(torch.from_numpy(pos)).numpy())).all()
    assert (_bits(wref.exp(x)) == _bits(fmath.exp(torch.from_numpy(x)).numpy())).all()
    a, b, c = x[:-7], x[7:][::-1].copy(), np.roll(x, 3)[:-7]
    assert (_bits(wref.fma(a, b, c)) == _bits(fmath.fma(*map(torch.from_numpy, (a, b, c))).numpy())).all()
    w = np.exp(rng.standard_normal((5, 1000))).astype(np.float32)
    w[:, ::9] = 0
    w[1, ::4] = 1e-40
    assert (_bits(wref.lane_cumsum(w)) == _bits(prefix.lane_cumsum(torch.from_numpy(w)).numpy())).all()


def test_the_scalar_steps_round_as_the_arrays():
    from cardbench.reference import scalar32 as s

    rng = np.random.default_rng(4)
    xs = np.concatenate([np.abs(rng.standard_normal(3000)).astype(np.float32) * 3,
                         rng.random(3000).astype(np.float32), np.array([1.0, 2.0**-24, 1e-40], np.float32)])
    assert [s.log(float(v)) for v in xs] == [float(v) for v in wref.log(xs)]
    ys = -xs * 20
    assert [s.exp(float(v)) for v in ys] == [float(v) for v in wref.exp(ys)]
    a, b, c = xs, xs[::-1].copy(), np.roll(ys, 5)
    assert [s.fma(float(p), float(q), float(r)) for p, q, r in zip(a, b, c)] == [float(v) for v in wref.fma(a, b, c)]


def test_threefry_and_the_salts_are_the_programs():
    rng = np.random.default_rng(5)
    k1, k2, x0, x1 = (rng.integers(0, 2**32, 500, dtype=np.uint64) for _ in range(4))
    want = threefry2x32(*(torch.from_numpy(v.astype(np.int64)) for v in (k1, k2, x0, x1)))
    got = common.threefry2x32(k1, k2, x0, x1)
    assert all((g.astype(np.int64) == w.numpy()).all() for g, w in zip(got, want))
    key = np.array([123, 456789], np.uint32)
    state = pd.init(torch.from_numpy(key.astype(np.int64)), 37, 4)
    assert (common.salts_words(key, 37).view(np.int32) == state.salts.numpy()).all()


def _weighted_case(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    P, B, k = 3, 300, 8
    elems = rng.integers(-(2**31), 2**31 - 1, (P, rows, B), dtype=np.int32)
    w = np.exp(rng.standard_normal((P, rows, B))).astype(np.float32)
    w[0, :, ::7] = 0.0
    w[1, ::3, ::5] = 1e-40  # subnormal weights are zero weights
    w[2, 0, :] = 0.0  # a tile with no positive lane in row 0
    return elems, w, k, rng.integers(0, P, 240)


@pytest.mark.parametrize("rows", [3, 40])  # 3: every acceptance in scalars; 40: in arrays too
def test_the_weighted_reference_replays_the_programs_plain_update(rows, promotion):
    elems, w, k, order = _weighted_case(rows, rows)
    key = np.array([7, 2**31 + 5], np.uint32)
    state = pw.init(torch.from_numpy(key.astype(np.int64)), rows, k)
    streams = wref.Streams(common.split_rows(key, np.arange(rows)), k, elems.transpose(1, 0, 2),
                           w.transpose(1, 0, 2))
    for t, p in enumerate(order):
        state = pw.update(state, torch.from_numpy(elems[p]), torch.from_numpy(w[p]))
        streams.step(int(p))
        if t % 40 == 39 or t == len(order) - 1:
            ref = streams.state
            for name in ("samples", "lkeys", "count", "xw"):
                assert (_bits(getattr(state, name).numpy()) == _bits(ref[name])).all(), (t, name)
            assert (state.key.numpy().astype(np.uint32) == ref["key"]).all()
    samples, size = wref.result(streams.state)
    want = pw.result(state)
    assert (samples == want[0].numpy()).all() and (size == want[1].numpy()).all()


def _keys(rng, shape):
    u = rng.random(shape) * (1 - 1e-6) + 1e-6
    return np.minimum(u ** -10.0, 1e7).astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("precision", ["int32", "int16"])
def test_the_distinct_reference_is_the_programs_plain_update(precision):
    rng = np.random.default_rng(9)
    R, k, P, B = 24, 16, 3, 200
    pool = _keys(rng, (P, R, B))
    key = np.array([31, 2**31 + 7], np.uint32)
    state = pd.init(torch.from_numpy(key.astype(np.int64)), R, k)
    hasher = dref.Hasher(key, R, "cpu", precision)
    rows = np.arange(R)
    narrow = [hasher.narrow(torch.from_numpy(pool[p])) for p in range(P)]
    bottoms = [dref.bottom_k(hasher.keys(narrow[p], rows), narrow[p], k) for p in range(P)]
    seen = set()
    for p in rng.integers(0, P, 9):
        state = pd.update(state, torch.from_numpy(pool[p]))
        seen.add(int(p))
        got = dref.planes(*dref.union([bottoms[q] for q in sorted(seen)], k))
        same = all((got[n] == getattr(state, n).numpy()).all() for n in ("values", "hash_hi", "hash_lo", "size"))
        assert same == (precision == "int32")


def test_the_distinct_union_is_the_programs_merge():
    rng = np.random.default_rng(10)
    R, k = 12, 8
    key = np.array([1, 2], np.uint32)
    states = []
    for _ in range(3):
        st = pd.init(torch.from_numpy(key.astype(np.int64)), R, k)
        states.append(pd.update(st, torch.from_numpy(_keys(rng, (R, 50)))))
    merged = pd.merge(pd.merge(states[0], states[1]), states[2])
    parts = []
    for st in states:  # each state's entries as sort keys; padding past its size
        hi = st.hash_hi.long() & dref.MASK32
        lo = st.hash_lo.long() & dref.MASK32
        keys = torch.where(torch.arange(k)[None, :] < st.size[:, None].long(), (hi - 2**31) * 2**32 + lo, dref.PAD)
        parts.append((keys, st.values.long()))
    got = dref.planes(*dref.union(parts, k))
    for n in ("values", "hash_hi", "hash_lo", "size"):
        assert (got[n] == getattr(merged, n).numpy()).all(), n
