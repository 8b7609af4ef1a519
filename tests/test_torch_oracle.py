"""The port's host oracles (``reservoir_tpu_torch.oracle``) and their C scans
against the JAX package's (``reservoir_tpu.oracle``), under shared seeds.

Every route of each oracle runs in both packages from one seed: the
uniform oracle's fill, per-element path, skip-jump over sequences and
iterators, ranges (materialized into the C scan, or lazy), int64 arrays
through the C scan and through the Python loop, ``result_view`` with its
copy-on-write; the distinct oracle's per-element path, C scan, numpy route
and fallbacks, and its default hash for every type it covers; A-ExpJ's
pairs and arrays.  The results must be equal element for element, with the
same Python types, and the generators must end in the same state.  The
JAX package's Python route is forced with its ``RESERVOIR_TPU_NO_NATIVE``
variable (the port reads none; it takes ``native=False``).  The host
scrambles are held against the port's torch ``scramble64`` too.  The
tolerance is zero."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reservoir_tpu.oracle import algorithm_l as JAL
from reservoir_tpu.oracle import bottom_k as JBK
from reservoir_tpu.oracle import weighted as JW
from reservoir_tpu.ops import hashing as JH
from reservoir_tpu_torch import native as TN
from reservoir_tpu_torch.oracle import algorithm_l as TAL
from reservoir_tpu_torch.oracle import bottom_k as TBK
from reservoir_tpu_torch.oracle import weighted as TW
from reservoir_tpu_torch.ops import hashing as TH


def _typed(values):
    """A result as ``(type name, value)`` pairs: equal lists of equal types."""
    return [(type(v).__name__, v if not isinstance(v, float) else float(v).hex()) for v in values]


def _uniform_state(o):
    return o.count, o._next, o._log_w.hex(), o._rng.bit_generator.state


def _jax_python_route(monkeypatch, python: bool) -> None:
    if python:
        monkeypatch.setenv("RESERVOIR_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("RESERVOIR_TPU_NO_NATIVE", raising=False)


_N = 200_000
_ARR = np.arange(_N, dtype=np.int64) * 3 - _N

#: each uniform route: (k, feeds); a feed is ("all", x) for ``sample_all(x)``,
#: ("iter", x) for ``sample_all(iter(x))`` or ("one", x) for ``sample(x)``
_UNIFORM_ROUTES = {
    "fill_below_k": (50, [("all", range(5)), ("all", [7, 8])]),
    "fill_exactly_k": (8, [("all", np.arange(8, dtype=np.int64))]),
    "per_element": (16, [("one", i) for i in range(3_000)]),
    "list_skip_jump": (16, [("all", list(range(20_000)))]),
    "iterator_drop": (16, [("iter", range(20_000)), ("iter", [i * 2 for i in range(5_000)])]),
    "array_c_scan": (64, [("all", _ARR), ("all", _ARR[:50_000])]),
    "array_int32": (16, [("all", np.arange(40_000, dtype=np.int32))]),
    "array_float": (16, [("all", np.linspace(0.0, 1.0, 5_000))]),
    "strings": (16, [("all", [str(i) for i in range(2_000)])]),
    "range_c_scan": (64, [("all", range(_N))]),
    "range_stepped_negative": (64, [("all", range(-_N, _N, 3))]),
    "range_mostly_fill": (600, [("all", range(1_000))]),
    "range_past_the_cap": (64, [("all", range(10**10))]),
    "float_fill_then_int64": (16, [("all", np.linspace(0.25, 0.75, 16)),
                                   ("all", np.arange(100_000, dtype=np.int64))]),
    "mixed": (32, [("all", range(1_000)), ("one", 5), ("all", np.arange(30_000, dtype=np.int64)),
                   ("all", range(40_000)), ("all", [1, 2, 3])]),
}


@pytest.mark.parametrize("native", [True, False], ids=["c_scan", "python"])
@pytest.mark.parametrize("route", sorted(_UNIFORM_ROUTES))
def test_uniform_oracle_routes_equal_the_jax_package(monkeypatch, route, native):
    k, feeds = _UNIFORM_ROUTES[route]
    _jax_python_route(monkeypatch, not native)
    out = []
    for make in (lambda: JAL.AlgorithmLOracle(k, np.random.default_rng(42)),
                 lambda: TAL.AlgorithmLOracle(k, np.random.default_rng(42), native=native)):
        o = make()
        for kind, x in feeds:
            if kind == "one":
                o.sample(x)
            else:
                o.sample_all(iter(x) if kind == "iter" else x)
        out.append((_typed(o.result()), _uniform_state(o)))
    assert out[0] == out[1]


@pytest.mark.parametrize("k", [5, 512])
def test_c_scan_equals_both_python_routes_over_thousands_of_accepts(monkeypatch, k):
    # k = 512 over 2^20 elements is ~3,900 accepts; k = 5 ~60 over a much
    # deeper chain: the C scan's double-precision chain (libm log, exp,
    # log1p, built without -march=native) must take the same floor at each
    n = 1 << 20
    arr = np.random.default_rng(3).integers(-(2**40), 2**40, n, dtype=np.int64)
    runs = {}
    for name, make, python in (
        ("port_c", lambda: TAL.AlgorithmLOracle(k, np.random.default_rng(9)), False),
        ("port_python", lambda: TAL.AlgorithmLOracle(k, np.random.default_rng(9), native=False), False),
        ("jax_c", lambda: JAL.AlgorithmLOracle(k, np.random.default_rng(9)), False),
        ("jax_python", lambda: JAL.AlgorithmLOracle(k, np.random.default_rng(9)), True),
    ):
        _jax_python_route(monkeypatch, python)
        o = make()
        o.sample_all(arr)
        o.sample_all(arr[: n // 3])
        runs[name] = (_typed(o.result()), _uniform_state(o))
    assert runs["port_c"] == runs["port_python"] == runs["jax_c"] == runs["jax_python"]


def test_the_c_scan_reads_the_generator_the_python_loop_draws_from():
    # the scan draws through rng.bit_generator.ctypes; afterwards the same
    # generator object continues where the Python loop would
    rng = np.random.default_rng(11)
    o = TAL.AlgorithmLOracle(32, rng)
    o.sample_all(np.arange(100_000, dtype=np.int64))
    p = TAL.AlgorithmLOracle(32, np.random.default_rng(11), native=False)
    p.sample_all(np.arange(100_000, dtype=np.int64))
    assert rng.random() == p._rng.random()


def test_the_c_scan_library_builds_and_a_failed_build_raises(monkeypatch):
    lib = TN.load_algl_scan_library()
    assert hasattr(lib, "reservoir_algl_scan")
    assert hasattr(TN.load_bottomk_library(), "rsv_bottomk_scan")
    from reservoir_tpu_torch import _build

    monkeypatch.setattr(TN, "_scan_libs", {})
    monkeypatch.setattr(_build, "CXX", "no-such-compiler-on-the-path")
    with pytest.raises(RuntimeError, match="not found"):
        TAL.AlgorithmLOracle(8, np.random.default_rng(0)).sample_all(np.arange(2_000, dtype=np.int64))
    with pytest.raises(RuntimeError, match="not found"):
        TBK.BottomKOracle(8, np.random.default_rng(0)).sample_all(np.arange(2_000, dtype=np.int64))


@pytest.mark.parametrize("map_fn", [None, lambda x: x * 3], ids=["identity", "times3"])
def test_map_on_accept_equals_the_jax_package(map_fn):
    out = []
    for cls in (JAL.AlgorithmLOracle, TAL.AlgorithmLOracle):
        calls = []
        fn = None if map_fn is None else (lambda x, c=calls: c.append(x) or map_fn(x))
        o = cls(8, np.random.default_rng(2), map_fn=fn)
        o.sample_all(range(5_000))
        o.sample_all(np.arange(5_000, dtype=np.int64))
        out.append((_typed(o.result()), calls, _uniform_state(o)))
    assert out[0] == out[1]


def test_result_view_aliases_until_the_next_write_as_in_the_jax_package():
    out = []
    for cls in (JAL.AlgorithmLOracle, TAL.AlgorithmLOracle):
        o = cls(16, np.random.default_rng(1))
        o.sample_all(range(10))
        partial = o.result_view()  # fewer than k seen: a copy
        o.sample_all(np.arange(1_000, dtype=np.int64))
        view = o.result_view()
        live = view is o._samples
        again = o.result_view() is view
        frozen = list(view)
        o.sample_all(np.arange(1_000, 300_000, dtype=np.int64))
        out.append((partial, live, again, view == frozen, o._samples is not view,
                    _typed(o.result_view()), _uniform_state(o)))
    assert out[0] == out[1]
    assert out[1][1:5] == (True, True, True, True)


# ----------------------------------------------------------------- bottom-k


_SALTS = (0x0123456789ABCDEF, 0xFEDCBA9876543210)
_rng = np.random.default_rng(13)
#: each distinct route: (k, salts or None, feeds)
_DISTINCT_ROUTES = {
    "per_element": (32, None, [("one", int(x)) for x in _rng.integers(0, 500, 3_000)]),
    "c_scan_unique": (128, _SALTS, [("all", _rng.integers(0, 50_000, 20_000, dtype=np.int64))]),
    "c_scan_heavy_dup": (128, _SALTS, [("all", _rng.integers(0, 60, 20_000, dtype=np.int64))]),
    "negatives_int32": (64, None, [("all", _rng.integers(-1000, 1000, 10_000, dtype=np.int32))]),
    "uint64_high": (64, _SALTS, [("all", _rng.integers(0, 2**63, 10_000, dtype=np.uint64) * 2 + 1)]),
    "under_fill": (128, None, [("all", np.arange(40, dtype=np.int64))]),
    "roundtrip": (64, _SALTS, [("all", _rng.integers(0, 10_000, 5_000, dtype=np.int64)),
                               *[("one", int(x)) for x in _rng.integers(0, 10_000, 2_000)],
                               ("all", _rng.integers(0, 10_000, 5_000, dtype=np.int64))]),
    "mixed_types_fall_back": (8, None, [("one", "hello"), ("all", np.arange(100, dtype=np.int64))]),
    "negative_member_then_uint64": (8, None, [("one", -5), ("all", np.arange(100, dtype=np.uint64))]),
    "numpy_scalar_member_wrap": (8, _SALTS, [
        ("one", np.int64(-5)),
        ("all", np.array([2**64 - 5, 1, 2, 3, 4, 5, 6, 7, 8, 9], dtype=np.uint64))]),
    "list_of_hashables": (5, (11, 22), [("all", [(i % 7, float(i), ("s", i % 3)) for i in range(200)])]),
    "zipf_int64": (256, None, [("all", np.minimum(
        np.random.default_rng(4).random(200_000) ** -10.0, 1e7).astype(np.int64))]),
}


def _distinct_out(o):
    return (_typed(o.result()), o.count, o.threshold(), o._salts, sorted(map(repr, o._members)),
            o._rng_state)


@pytest.mark.parametrize("native", [True, False], ids=["c_scan", "numpy"])
@pytest.mark.parametrize("route", sorted(_DISTINCT_ROUTES))
def test_distinct_oracle_routes_equal_the_jax_package(monkeypatch, route, native):
    k, salts, feeds = _DISTINCT_ROUTES[route]
    _jax_python_route(monkeypatch, not native)
    out = []
    for make in (lambda rng: JBK.BottomKOracle(k, rng, salts=salts),
                 lambda rng: TBK.BottomKOracle(k, rng, salts=salts, native=native)):
        rng = np.random.default_rng(7)
        o = make(rng)
        for kind, x in feeds:
            (o.sample_all if kind == "all" else o.sample)(x)
        o._rng_state = rng.bit_generator.state
        out.append(_distinct_out(o))
    assert out[0] == out[1]


@pytest.mark.parametrize("hashed", ["map", "hash"])
def test_distinct_hooks_equal_the_jax_package(hashed):
    kw = ({"map_fn": lambda x: x % 97} if hashed == "map"
          else {"hash_fn": lambda v: (int(v) * 0x9E3779B97F4A7C15) & (2**64 - 1)})
    out = []
    for cls in (JBK.BottomKOracle, TBK.BottomKOracle):
        rng = np.random.default_rng(5)
        o = cls(16, rng, **kw)
        o.sample_all(np.arange(5_000, dtype=np.int64))
        o._rng_state = rng.bit_generator.state
        out.append(_distinct_out(o))
    assert out[0] == out[1]


class _Obj:
    pass


_HASHABLES = {
    "int": 42, "negative_int": -1, "big_int": 2**70 + 3, "bool": True, "np_bool": np.True_,
    "np_int64": np.int64(-7), "np_uint64": np.uint64(2**64 - 1), "integral_float": 3.0,
    "float": 2.5, "negative_zero": -0.0, "nan": float("nan"), "np_float32": np.float32(0.1),
    "none": None, "str": "a", "empty_str": "", "unicode": "naïve ∑", "bytes": b"a",
    "bytearray": bytearray(b"xyz"), "tuple": (1, "a"), "nested_tuple": ((1, 2.5), (None, b"q")),
    "frozenset": frozenset({1, 2, 3}), "frozenset_of_floats": frozenset({2.0, 1}),
}


@pytest.mark.parametrize("name", sorted(_HASHABLES))
def test_default_hash_equals_the_jax_package(name):
    value = _HASHABLES[name]
    assert TBK._default_hash(value) == JBK._default_hash(value)


def test_default_hash_refuses_process_salted_types_as_the_jax_package_does():
    for mod in (JBK, TBK):
        with pytest.raises(TypeError, match="hash_fn"):
            mod._default_hash(_Obj())


# ----------------------------------------------------------------- weighted


def _weighted_feed(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random(n) + 0.5
    w[::7] = 0.0  # a zero weight is counted and never sampled
    return np.arange(n, dtype=np.int64), w


@pytest.mark.parametrize("form", ["pairs", "per_element", "arrays", "naive"])
def test_weighted_oracles_equal_the_jax_package(form):
    elems, wts = _weighted_feed(30_000, 1)
    out = []
    for mod in (JW, TW):
        rng = np.random.default_rng(42)
        o = (mod.NaiveWeightedOracle if form == "naive" else mod.AExpJOracle)(64, rng)
        if form == "arrays":
            o.sample_all_arrays(elems, wts)
        elif form == "per_element":
            for e, w in zip(elems.tolist(), wts.tolist()):
                o.sample(e, w)
        else:
            o.sample_all(zip(elems.tolist(), wts.tolist()))
        out.append((_typed(o.result()), o._count, rng.bit_generator.state,
                    None if form == "naive" else float(o._xw).hex()))
    assert out[0] == out[1]


@pytest.mark.parametrize("bad", ["negative", "nan", "shape"])
def test_weighted_validation_equals_the_jax_package(bad):
    elems, wts = np.arange(4, dtype=np.int64), np.ones(4)
    if bad == "negative":
        wts[1] = -1.0
    elif bad == "nan":
        wts[2] = np.nan
    else:
        wts = np.ones(3)
    msgs = []
    for mod in (JW, TW):
        with pytest.raises(ValueError) as info:
            mod.AExpJOracle(8, np.random.default_rng(0)).sample_all_arrays(elems, wts)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------------ hashing


def test_host_scrambles_equal_the_jax_package_and_the_torch_scramble():
    rng = np.random.default_rng(77)
    salts = TH.draw_salts(rng)
    assert salts == JH.draw_salts(np.random.default_rng(77))
    edges = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**32, 2**63 - 1, -(2**63)], np.int64)
    vals = np.concatenate([edges, rng.integers(-(2**63), 2**63 - 1, 4_000, dtype=np.int64)])
    arr = TH.scramble64_array(vals, salts)
    np.testing.assert_array_equal(arr, JH.scramble64_array(vals, salts))
    assert [TH.scramble64_int(int(v), salts) for v in vals] == [int(h) for h in arr]
    assert [JH.scramble64_int(int(v), salts) for v in vals[:500]] == [int(h) for h in arr[:500]]
    # the torch form on int64-carried words
    u = vals.view(np.uint64)
    hi = torch.from_numpy((u >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((u & np.uint64(0xFFFFFFFF)).astype(np.int64))
    r = [int(w) for s in salts for w in (s >> 32, s & 0xFFFFFFFF)]
    sh, sl = TH.scramble64(hi, lo, *r)
    torch_h = (sh.numpy().astype(np.uint64) << np.uint64(32)) | sl.numpy().astype(np.uint64)
    np.testing.assert_array_equal(torch_h, arr)
    # unsigned input: the same 64-bit patterns
    np.testing.assert_array_equal(TH.scramble64_array(u, salts), arr)
    with pytest.raises(ValueError):
        TH.scramble64_array(np.ones(3), salts)


def test_as_scalar_hash_equals_the_jax_package():
    def tile_hash(v):
        v = np.asarray(v).astype(np.uint32)
        return v >> np.uint32(16), v * np.uint32(31)

    p, j = TH.as_scalar_hash(tile_hash), JH.as_scalar_hash(tile_hash)
    assert [p(x) for x in (0, 1, 2**31 - 1, 123456789)] == [j(x) for x in (0, 1, 2**31 - 1, 123456789)]
