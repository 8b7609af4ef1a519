"""The port's row operations (``reset_rows``, ``export_rows``, ``adopt_rows``)
against the JAX engine's, bit for bit on the CPU, in the three modes.

The reference runs a reset's ``init`` inside ``jax.jit``, where XLA turns
``log_w + log(u1) / k`` into ``fma(log(u1), f32(1/k), log_w)``; its
engine's own ``init`` runs op by op and divides.  A power-of-two k hides
the difference, so the resets are held at k = 5 and 6 as well as 128: at 5
and 6 a reset through the eager ``init`` (``compiled=False``) gives another
``log_w`` than the reference's (pinned below), and the chains fork within a
few acceptances.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.ops import algorithm_l as j_algl
from reservoir_tpu_torch import ReservoirEngine, SamplerConfig, convert
from reservoir_tpu_torch.ops import algorithm_l as t_algl
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.serve import SessionTable

R, B = 32, 16
MODES = ["uniform", "weighted", "distinct"]


def _kw(mode, k, **extra):
    return dict(max_sample_size=k, num_reservoirs=R, tile_size=B,
                weighted=mode == "weighted", distinct=mode == "distinct", **extra)


def _pair(mode, k, seed=3, **extra):
    return (
        JEngine(JConfig(**_kw(mode, k, **extra)), key=seed, reusable=True),
        ReservoirEngine(SamplerConfig(**_kw(mode, k, **extra)), key=seed, reusable=True, device="cpu"),
    )


class _Feed:
    """Seeded tiles (and weights), fed to any number of engines alike."""

    def __init__(self, mode, seed=0, dtype=np.int32):
        self.mode, self.dtype = mode, dtype
        self.rng = np.random.default_rng(seed)

    def __call__(self, *engines, ragged=False, same_rows=False):
        """One tile into every engine; ``same_rows`` gives every row the
        same elements (and weights)."""
        shape = (1 if same_rows else R, B)
        tile = np.broadcast_to(self.rng.integers(0, 1 << 30, shape).astype(self.dtype), (R, B)).copy()
        if self.mode == "distinct":
            tile %= 97
        kw = {}
        if self.mode == "weighted":
            kw["weights"] = np.broadcast_to(self.rng.uniform(0.1, 2.0, shape).astype(np.float32),
                                            (R, B)).copy()
        if ragged:
            kw["valid"] = self.rng.integers(0, B + 1, R).astype(np.int32)
        for eng in engines:
            eng.sample(tile, **kw)


def _jax_host(state):
    """A JAX state's fields as numpy (keys as their uint32 words)."""
    out = {}
    for name, value in zip(type(state)._fields, state):
        if value is not None and jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        out[name] = None if value is None else np.asarray(value)
    return out


def _same_state(jstate, tstate, rows=None):
    want, got = _jax_host(jstate), convert.state_to_numpy(tstate)
    sel = slice(None) if rows is None else rows
    for name, w in want.items():
        g = got[name]
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_array_equal(w[sel].view(np.uint8), g[sel].view(np.uint8), err_msg=name)


def _from_jax(state):
    """A JAX (sub-)state as the port's state class on the CPU, through
    ``convert``."""
    h = _jax_host(state)
    if "hash_hi" in h:
        return convert.distinct_state_from_numpy(h["values"], h["hash_hi"], h["hash_lo"], h["size"],
                                                 h["count"], h["salts"], h["value_hi"], device="cpu")
    if "lkeys" in h:
        return convert.weighted_state_from_numpy(h["samples"], h["lkeys"], h["count"], h["xw"], h["key"],
                                                 device="cpu")
    return convert.state_from_numpy(h["samples"], h["count"], h["nxt"], h["log_w"], h["key"], device="cpu")


def _to_jax(state, like):
    """A port (sub-)state as the JAX state class ``like``'s, keys wrapped."""
    h = convert.state_to_numpy(state)
    vals = []
    for name in type(like)._fields:
        v = h[name]
        if v is None:
            vals.append(None)
        elif name == "key":
            vals.append(jr.wrap_key_data(jnp.asarray(v)))
        else:
            vals.append(jnp.asarray(v))
    return type(like)(*vals)


@pytest.mark.parametrize("k", [5, 6, 128])
@pytest.mark.parametrize("mode", MODES)
def test_reset_rows_equals_the_jax_engine(mode, k):
    jeng, teng = _pair(mode, k)
    feed = _Feed(mode)
    feed(jeng, teng)
    feed(jeng, teng, ragged=True)
    rows = [3, 17, 3, 31, 0, 17, 8]  # repeats: the last occurrence wins
    jeng.reset_rows(rows, 123)
    teng.reset_rows(rows, 123)
    _same_state(jeng.state, teng.state)
    assert (teng.reset_epochs, teng._min_count) == (jeng.reset_epochs, jeng._min_count) == (1, 0)
    # the reset rows take a few acceptances more, the others go on
    for _ in range(3):
        feed(jeng, teng)
    _same_state(jeng.state, teng.state)
    assert teng._min_count == jeng._min_count


@pytest.mark.parametrize("k", [5, 6])
def test_a_reset_through_the_eager_init_would_fork(k):
    """The trap the reset avoids: the eager ``init`` (dividing by k) gives
    other ``log_w`` bits than the reference's compiled reset in some rows;
    the compiled one (``fma`` with ``1/k``) gives the same in all."""
    n = 2048
    jeng = JEngine(JConfig(max_sample_size=k, num_reservoirs=n, tile_size=8), key=0, reusable=True)
    jeng.reset_rows(np.arange(n), 123)
    want = np.asarray(jeng.state.log_w).view(np.int32)
    eager = t_algl.init(key_from_seed(123), n, k).log_w.numpy().view(np.int32)
    compiled = t_algl.init(key_from_seed(123), n, k, compiled=True).log_w.numpy().view(np.int32)
    assert np.array_equal(compiled, want)
    assert (eager != want).sum() > 0
    # the reference's eager init is the engine's construction, which the
    # port's default (compiled=False) follows
    np.testing.assert_array_equal(
        np.asarray(j_algl.init(jr.key(123), n, k).log_w).view(np.int32), eager)


@pytest.mark.parametrize("mode", MODES)
def test_reset_leaves_other_rows_bit_identical(mode):
    _, teng = _pair(mode, 6)
    _, ref = _pair(mode, 6)
    feed = _Feed(mode)
    feed(teng, ref)
    rows = [1, 30, 12]
    teng.reset_rows(rows, 9)
    for _ in range(3):
        feed(teng, ref)
    keep = np.setdiff1d(np.arange(R), rows)
    want, got = convert.state_to_numpy(ref.state), convert.state_to_numpy(teng.state)
    for name, w in want.items():
        if w is not None:
            np.testing.assert_array_equal(w[keep].view(np.uint8), got[name][keep].view(np.uint8),
                                          err_msg=name)
            assert not np.array_equal(w[rows].view(np.uint8), got[name][rows].view(np.uint8)) or (
                name in ("count", "size"))
    assert (teng.peek_arrays()[1][rows] > 0).all()


@pytest.mark.parametrize("key", ["int", "list", "tensor", "jax_words", "sub_key"])
def test_reset_takes_a_seed_or_key_words(key):
    """Key words from any source, a session's sub-key among them (the JAX
    service resets with ``jr.fold_in(jr.fold_in(jr.key(seed), row), gen)``)."""
    jeng, teng = _pair("uniform", 5)
    jkey = jr.fold_in(jr.fold_in(jr.key(4), 8), 2) if key == "sub_key" else jr.key(77)
    words = np.asarray(jr.key_data(jkey))
    arg = {"int": 77, "list": words.tolist(), "tensor": torch.from_numpy(words.astype(np.int64)),
           "jax_words": words, "sub_key": SessionTable(R, seed=4).sub_key(8, 2)}[key]
    jeng.reset_rows([2, 4], jkey)
    teng.reset_rows([2, 4], arg)
    _same_state(jeng.state, teng.state)


@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("mode", MODES)
def test_exported_rows_continue_bit_identically_after_adoption(mode, direction):
    """Rows exported from one engine and adopted by another (of the same
    config, another seed) continue as they would have in the source, across
    the packages too (through ``convert``)."""
    k = 6
    jsrc, tsrc = _pair(mode, k, seed=3)
    jdst, tdst = _pair(mode, k, seed=8)
    feed = _Feed(mode)
    feed(jsrc, tsrc, jdst, tdst)
    feed(jsrc, tsrc, jdst, tdst, ragged=True)
    rows_src = [5, 0, 29]
    rows_dst = [10, 31, 2]
    if direction == "port_to_port":
        part = tsrc.export_rows(rows_src)
        assert type(part) is type(tsrc.state) and part[0].shape[0] == 3
        tdst.adopt_rows(rows_dst, part)
        jdst.adopt_rows(rows_dst, jsrc.export_rows(rows_src))
    elif direction == "jax_to_port":
        part = jsrc.export_rows(rows_src)
        tdst.adopt_rows(rows_dst, _from_jax(part))
        jdst.adopt_rows(rows_dst, part)
    else:
        part = tsrc.export_rows(rows_src)
        jdst.adopt_rows(rows_dst, _to_jax(part, jsrc.state))
        tdst.adopt_rows(rows_dst, part)
    assert (tdst.reset_epochs, tdst._min_count) == (jdst.reset_epochs, jdst._min_count) == (1, 0)
    for _ in range(5):
        feed(jsrc, tsrc, jdst, tdst, same_rows=True)
    _same_state(jdst.state, tdst.state)
    _same_state(jsrc.state, tsrc.state)
    # the adopted rows are the source rows' continuation (every row was
    # fed the same elements since)
    src, dst = convert.state_to_numpy(tsrc.state), convert.state_to_numpy(tdst.state)
    for name, v in src.items():
        if v is not None:
            np.testing.assert_array_equal(v[rows_src].view(np.uint8), dst[name][rows_dst].view(np.uint8),
                                          err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_adopt_with_a_repeated_row_equals_jax(mode):
    jeng, teng = _pair(mode, 5)
    feed = _Feed(mode)
    for _ in range(3):
        feed(jeng, teng)
    rows_src, rows_dst = [1, 2, 3, 4], [7, 9, 7, 20]
    jeng.adopt_rows(rows_dst, jeng.export_rows(rows_src))
    teng.adopt_rows(rows_dst, teng.export_rows(rows_src))
    _same_state(jeng.state, teng.state)
    feed(jeng, teng)
    _same_state(jeng.state, teng.state)


def test_export_is_a_fresh_copy():
    _, teng = _pair("uniform", 5)
    feed = _Feed("uniform")
    feed(teng)
    part = teng.export_rows([0, 1])
    before = [t.clone() for t in part]
    for _ in range(3):
        feed(teng)
    teng.reset_rows([0, 1], 5)
    for t, b in zip(part, before):
        assert torch.equal(t, b)


def test_an_engine_does_not_write_the_state_it_was_built_from():
    _, teng = _pair("uniform", 5)
    start = teng.state
    keep = [t.clone() for t in start]
    eng = ReservoirEngine(SamplerConfig(**_kw("uniform", 5)), reusable=True, device="cpu",
                          _initial_state=start)
    eng.reset_rows([0, 3], 1)
    for t, b in zip(start, keep):
        assert torch.equal(t, b)


def _errors(jeng, teng, call):
    with pytest.raises(ValueError) as jinfo:
        call(jeng)
    with pytest.raises(ValueError) as tinfo:
        call(teng)
    return str(jinfo.value), str(tinfo.value)


@pytest.mark.parametrize(
    "rows",
    [[[1, 2]], [], [R], [-1], [0, 5, R + 3]],
    ids=["two_dims", "empty", "past_the_end", "negative", "one_bad"],
)
@pytest.mark.parametrize("op", ["reset", "export", "adopt"])
def test_row_errors_equal_the_jax_engine(op, rows):
    jeng, teng = _pair("uniform", 5)
    if op == "reset":
        msgs = _errors(jeng, teng, lambda e: e.reset_rows(rows, 1))
    elif op == "export":
        msgs = _errors(jeng, teng, lambda e: e.export_rows(rows))
    else:
        msgs = _errors(jeng, teng, lambda e: e.adopt_rows(rows, e.export_rows([0])))
    assert msgs[0] == msgs[1]
    assert teng.reset_epochs == 0


def test_adopt_checks_the_sub_state():
    jeng, teng = _pair("uniform", 5)
    msgs = _errors(jeng, teng, lambda e: e.adopt_rows([1, 2, 3], e.export_rows([0, 1])))
    assert msgs[0] == msgs[1] and "leading axis [2]" in msgs[1]
    _, weng = _pair("weighted", 5)
    with pytest.raises(ValueError, match="WeightedState"):
        teng.adopt_rows([0], weng.export_rows([0]))
    _, other_k = _pair("uniform", 6)
    with pytest.raises(ValueError, match="'samples' does not match"):
        teng.adopt_rows([0], other_k.export_rows([0]))
    assert teng.reset_epochs == 0


def test_row_operations_on_a_closed_engine_raise():
    from reservoir_tpu_torch import SamplerClosedError

    teng = ReservoirEngine(SamplerConfig(**_kw("uniform", 5)), key=0, device="cpu")
    teng.result_arrays()
    for call in (lambda: teng.reset_rows([0], 1), lambda: teng.export_rows([0]),
                 lambda: teng.adopt_rows([0], None)):
        with pytest.raises(SamplerClosedError):
            call()


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_wide_distinct_rows(dtype):
    """8-byte keys: the reset rows are the JAX package's wide ``init`` rows
    (the last occurrence of a repeated row wins), and adopted rows continue
    their source rows."""
    from reservoir_tpu.ops import distinct as j_dist

    _, teng = _pair("distinct", 6, element_dtype=np.dtype(dtype).name)
    _, src = _pair("distinct", 6, seed=4, element_dtype=np.dtype(dtype).name)
    feed = _Feed("distinct", dtype=dtype)
    feed(teng, src)
    teng.reset_rows([1, 4, 1], 5)
    want = _jax_host(j_dist.init(jr.key(5), 3, 6, sample_dtype=jnp.int64))
    got = convert.state_to_numpy(teng.state)
    for name, w in want.items():
        np.testing.assert_array_equal(w[[2, 1]].view(np.uint8), got[name][[1, 4]].view(np.uint8),
                                      err_msg=name)
    teng.adopt_rows([7, 8], src.export_rows([2, 3]))
    for _ in range(2):
        feed(teng, src, same_rows=True)
    a, b = convert.state_to_numpy(teng.state), convert.state_to_numpy(src.state)
    for name, v in b.items():
        np.testing.assert_array_equal(v[[2, 3]].view(np.uint8), a[name][[7, 8]].view(np.uint8), err_msg=name)
