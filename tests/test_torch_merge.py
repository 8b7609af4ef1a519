"""The port's pairwise merges against the JAX package's, bit for bit:
``reservoir_tpu_torch.ops.algorithm_l.merge_samples`` (with
``_randint_exact`` and ``_masked_perm``), ``ops.weighted.merge_parts`` and
``ops.distinct.merge`` against ``reservoir_tpu.ops``' functions, jitted and
(for the uniform merge) eager as well, since XLA may rewrite float
expressions inside compiled code.  The same numpy inputs, made from a seed,
go through both packages.  The tolerance is zero on every output; floats
are compared as their bits."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import weighted as JW
from reservoir_tpu_torch.convert import (
    distinct_state_from_numpy,
    distinct_state_to_numpy,
    state_from_numpy,
    weighted_state_from_numpy,
)
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import weighted as TW
from reservoir_tpu_torch.ops.rng import key_from_seed, split_keys
from reservoir_tpu_torch.ops.threefry import MASK32, fold_in_words, threefry2x32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_J_MERGE_SAMPLES = jax.jit(JA.merge_samples)
_J_MERGE_PARTS = jax.jit(JW.merge_parts)
_J_DISTINCT_MERGE = jax.jit(JD.merge)
_J_RANDINT = jax.jit(jax.vmap(JA._randint_exact))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ----------------------------------------------------------------- uniform


def _counts(rng, R, k, case):
    """``(count_a, count_b)`` int32: counts of 0, below k, exactly k and
    above k; one side empty; a first denominator that is a power of two, or
    near 2^31 a side (the sum passes 2^31)."""
    if case == "mixed":
        pool = np.array([0, 1, k - 1, k, k + 1, 3 * k, 1000 * k + 7])
        return rng.choice(pool, R).astype(np.int32), rng.choice(pool, R).astype(np.int32)
    if case == "a_empty":
        return np.zeros(R, np.int32), rng.integers(0, 3 * k, R).astype(np.int32)
    if case == "b_empty":
        return rng.integers(1, 3 * k, R).astype(np.int32), np.zeros(R, np.int32)
    if case == "below_k":
        return rng.integers(0, k // 2, R).astype(np.int32), rng.integers(0, k // 2, R).astype(np.int32)
    if case == "pow2":
        return np.full(R, 2**20, np.int32), np.full(R, 2**20, np.int32)
    assert case == "large"
    return (rng.integers(2**30, 2**31 - 1, R).astype(np.int32),
            rng.integers(2**30, 2**31 - 1, R).astype(np.int32))


@pytest.mark.parametrize("case", ["mixed", "a_empty", "b_empty", "below_k", "pow2", "large"])
@pytest.mark.parametrize("k", [5, 8, 64])
@pytest.mark.parametrize("R", [1, 8, 13])
def test_merge_samples_equals_jitted_jax(R, k, case):
    rng = np.random.default_rng(R * 100 + k)
    sa = rng.integers(-(2**31), 2**31, (R, k)).astype(np.int32)
    sb = rng.integers(-(2**31), 2**31, (R, k)).astype(np.int32)
    ca, cb = _counts(rng, R, k, case)
    ws, wc = _J_MERGE_SAMPLES(jnp.asarray(sa), jnp.asarray(ca), jnp.asarray(sb), jnp.asarray(cb),
                              jr.key(k + 1))
    gs, gc = TA.merge_samples(torch.from_numpy(sa), torch.from_numpy(ca), torch.from_numpy(sb),
                              torch.from_numpy(cb), key_from_seed(k + 1))
    _same(gs, ws)
    assert gc.dtype == torch.uint32
    _same(gc, wc)  # numpy uint32 on both sides
    size = np.minimum(np.asarray(wc), k)
    assert (gs.numpy()[np.arange(k)[None, :] >= size[:, None]] == 0).all()


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
@pytest.mark.parametrize("R, k", [(1, 5), (8, 8), (13, 64)])
def test_merge_samples_equals_eager_jax_for_every_word_dtype(R, k, dtype):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, (2, R, k), dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        words[:, :, 0] = 0x80000000  # -0.0
        words[:, :, 1] = 0x7FC00001  # NaN with a payload
    sa, sb = words.view(dtype)
    ca, cb = _counts(rng, R, k, "mixed")
    # merged counts (uint32) go in again, as a tree's second level feeds them
    cb = cb.astype(np.uint32)
    args = (jnp.asarray(sa), jnp.asarray(ca), jnp.asarray(sb), jnp.asarray(cb), jr.key(3))
    es, ec = JA.merge_samples(*args)
    ws, wc = _J_MERGE_SAMPLES(*args)
    gs, gc = TA.merge_samples(torch.from_numpy(sa), torch.from_numpy(ca), torch.from_numpy(sb),
                              torch.from_numpy(cb), key_from_seed(3))
    for want_s, want_c in ((es, ec), (ws, wc)):
        _same(gs, want_s)
        _same(gc, want_c)


def test_merge_of_two_states_gives_size_and_count():
    R, k = 6, 4
    rng = np.random.default_rng(0)
    states = []
    for seed, n in ((1, 9), (2, 3)):
        js = JA.update(JA.init(jr.key(seed), R, k), jnp.asarray(rng.integers(0, 99, (R, n)).astype(np.int32)))
        ts = state_from_numpy(np.asarray(js.samples), np.asarray(js.count), np.asarray(js.nxt),
                              np.asarray(js.log_w), np.asarray(jr.key_data(js.key)), device="cpu")
        states.append((js, ts))
    want = JA.merge(states[0][0], states[1][0], jr.key(5))
    got = TA.merge(states[0][1], states[1][1], key_from_seed(5))
    for g, w in zip(got, want):
        _same(g, w)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.uint32


def test_a_level_of_stacked_pairs_equals_one_call_a_pair():
    R, k, pairs = 5, 8, 3
    rng = np.random.default_rng(4)
    sa, sb = (torch.from_numpy(rng.integers(0, 2**31, (pairs * R, k)).astype(np.int32)) for _ in range(2))
    ca, cb = (torch.from_numpy(rng.integers(0, 3 * k, pairs * R).astype(np.int32)) for _ in range(2))
    keys = [key_from_seed(10 + p) for p in range(pairs)]
    row_keys = torch.cat([split_keys(kw, R) for kw in keys])
    got_s, got_c = TA.merge_samples_keyed(sa, ca, sb, cb, row_keys)
    for p, kw in enumerate(keys):
        rows = slice(p * R, (p + 1) * R)
        want_s, want_c = TA.merge_samples(sa[rows], ca[rows], sb[rows], cb[rows], kw)
        assert torch.equal(got_s[rows], want_s)
        assert torch.equal(got_c[rows].view(torch.int32), want_c.view(torch.int32))
    # and a batch of keys splits as each key does
    assert torch.equal(split_keys(torch.stack(keys), R).reshape(pairs * R, 2), row_keys)


def test_randint_exact_equals_jax_also_where_lanes_reject_more_than_once():
    rng = np.random.default_rng(6)
    # 2^31 + 1 rejects almost every second draw; 2^32 - 1 and 1 and powers of
    # two accept (nearly) everything; 3 and 10^9 + 7 reject rarely
    denoms = np.array([1, 2, 3, 2**16, 2**31, 2**31 + 1, 2**32 - 1, 10**9 + 7, 3 * 2**30], np.uint64)
    n = 64
    denom = np.repeat(denoms, n).astype(np.uint32)
    f1 = rng.integers(0, 2**32, denom.shape, dtype=np.uint64).astype(np.uint32)
    f2 = rng.integers(0, 2**32, denom.shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(_J_RANDINT(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(denom)))
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    got = TA._randint_exact(t(f1), t(f2), t(denom))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (got.numpy() < denom).all()
    # count the attempts each lane needed, from the draws themselves
    space_mod = ((MASK32 % t(denom)) + 1) % t(denom)
    thresh = (-space_mod) & MASK32
    rejected = torch.zeros_like(thresh)
    for a in range(2):
        b0, b1 = threefry2x32(t(f1), t(f2), torch.ones_like(thresh), torch.full_like(thresh, a))
        rejected += ((space_mod != 0) & ((b0 ^ b1) >= thresh) & (rejected == a)).long()
    assert int((rejected == 2).sum()) >= 10  # lanes that rejected twice or more


@pytest.mark.parametrize("k", [1, 5, 64])
def test_masked_perm_equals_jax(k):
    rng = np.random.default_rng(k)
    R = 9
    words = rng.integers(0, 2**32, (R, 2), dtype=np.uint64).astype(np.uint32)
    size = rng.integers(0, k + 1, R).astype(np.int32)
    want = np.stack([
        np.asarray(JA._masked_perm(jr.wrap_key_data(jnp.asarray(words[r])), k, int(size[r])))
        for r in range(R)
    ])
    kw = torch.from_numpy(words.astype(np.int64))
    got = TA._masked_perm(kw[:, 0], kw[:, 1], k, torch.from_numpy(size).long())
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    # the uniforms are those of jr.uniform for a (k,) shape
    f1, f2 = fold_in_words(kw[:, 0], kw[:, 1], torch.full((R,), 7, dtype=torch.int32))
    ju = np.stack([np.asarray(jr.uniform(jr.fold_in(jr.wrap_key_data(jnp.asarray(words[r])), 7), (k,)))
                   for r in range(R)])
    tu = TA._masked_perm(f1, f2, k, torch.full((R,), k)).numpy()
    np.testing.assert_array_equal(tu, np.argsort(ju, axis=1, kind="stable"))


def test_wide_counts_raise_naming_the_roadmap():
    """L3 is ported: two WIDE ``[R, 2]`` counts merge (into WIDE totals);
    what still raises is a WIDE count beside a narrow one, with the
    reference's ``ValueError`` (``tests/test_torch_wide_count.py`` holds
    the WIDE merge against the JAX package)."""
    s = torch.zeros((2, 4), dtype=torch.int32)
    wide = torch.zeros((2, 2), dtype=torch.int32).view(torch.uint32)
    _, count = TA.merge_samples(s, wide, s, wide, key_from_seed(0))
    assert count.shape == (2, 2) and count.dtype == torch.uint32
    with pytest.raises(ValueError, match="mixed-width"):
        TA.merge_samples(s, wide, s, torch.zeros(2, dtype=torch.int32), key_from_seed(0))
    with pytest.raises(ValueError, match="int32 or uint32"):
        TA.merge_samples(s, torch.zeros(2, dtype=torch.int64), s, torch.zeros(2, dtype=torch.int32),
                         key_from_seed(0))
    with pytest.raises(ValueError, match="one dtype"):
        TA.merge_samples(s, torch.zeros(2, dtype=torch.int32), s.float(), torch.zeros(2, dtype=torch.int32),
                         key_from_seed(0))


# ------------------------------- counts past 2^32, the scan, tied keys

# a child process for each case whose totals wrap past 2^32: the port's
# merge once spun forever there, so a regression must fail the test (the
# child's time limit) rather than hang the suite
_WRAP_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch
from jax.sharding import Mesh
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.parallel import merge as JM
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import merge as TM

def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), (got, want)

case = sys.argv[1]
rng = np.random.default_rng(2)
if case in ("pair", "random pairs"):
    R, k = (2, 4) if case == "pair" else (64, 8)
    sa = rng.integers(0, 2**30, (R, k)).astype(np.int32)
    sb = rng.integers(2**30, 2**31, (R, k)).astype(np.int32)
    if case == "pair":
        ca = cb = np.full(R, 2**31 + 1, np.uint32)
    else:
        ca = rng.integers(0, 2**32, R).astype(np.uint32)
        cb = rng.integers(0, 2**32, R).astype(np.uint32).view(np.int32)  # negatives among them
    ws, wc = jax.jit(JA.merge_samples)(jnp.asarray(sa), jnp.asarray(ca), jnp.asarray(sb), jnp.asarray(cb),
                                       jr.key(5))
    gs, gc = TA.merge_samples(*(torch.from_numpy(x) for x in (sa, ca, sb, cb)), key_from_seed(5))
    same(gs, ws)
    same(gc, wc)
    if case == "pair":
        assert int(np.asarray(wc)[0]) == 2 and (np.asarray(ws)[:, 2:] == 0).all()
elif case == "host tree":
    k = 6
    parts = [(rng.integers(0, 2**31, k).astype(np.int32), 1_500_000_000 + p) for p in range(4)]
    want, want_total = JM.merge_samples_host(parts, 7, max_sample_size=k)
    got, got_total = TM.merge_samples_host(parts, 7, max_sample_size=k)
    same(got, want)
    assert got_total == want_total == (6_000_000_006 % 2**32)
else:
    n_shards = int(case.split()[0])
    R, k = 6, 8
    samples = rng.integers(0, 2**31, (n_shards, R, k)).astype(np.int32)
    if n_shards == 4:  # 1.5e9 a shard: the second level's total wraps
        count = np.full((n_shards, R), 1_500_000_000, np.int32) + rng.integers(0, 9, (n_shards, R)).astype(np.int32)
    else:  # any uint32 count, as int32: the negatives mask their side
        count = rng.integers(0, 2**32, (n_shards, R)).astype(np.uint32).view(np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("stream",))
    want_s, want_c = JM.uniform_stream_merger(mesh)(jnp.asarray(samples), jnp.asarray(count), jr.key(99))
    got_s, got_c = TM.uniform_stream_merger(torch.from_numpy(samples), torch.from_numpy(count), 99)
    same(got_s, want_s)
    same(got_c, want_c)
print("ok")
"""


@pytest.mark.parametrize("case", ["pair", "random pairs", "host tree", "4 shards", "5 shards", "7 shards"])
def test_merges_whose_counts_wrap_past_2_32_equal_the_jax_package(case):
    """Fault C.2: totals past 2^32 (uint32 counts that a merge returns and a
    tree's next level takes in) wrap as the reference's uint32 arithmetic
    does, and the port returns the reference's samples and count instead of
    spinning; int32 counts past 2^31 - 1 (negative) mask their side as the
    reference's do.  Pairs, the host tree of four parts of 1.5e9 elements,
    and stream mergers over 4, 5 and 7 shards."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _WRAP_CHILD, case], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def _step_parallel_scan(ca, cb, row_keys, k):
    """A model of the draws kernel's scan, written apart from the port's:
    each step's denominator is ``total - t`` (mod 2^32, or 2^64 for WIDE
    counts), since every active step takes exactly one element, so every
    draw ``x_t`` is made first, for all rows and steps at once; then each
    row walks its chain ``take_t = x_t < rem_a``.  ``ca`` and ``cb`` are
    Python ints; returns ``(j_a, tries)``, ``tries`` each draw's Threefry
    attempts."""
    wide = max(ca + cb, default=0) >= 2**32
    mod = 2**64 if wide else 2**32
    total = [(a + b) % mod for a, b in zip(ca, cb)]
    m = [min(t, k) for t in total]
    rows = [r for r in range(len(ca)) for _ in range(m[r])]
    steps = [t for r in range(len(ca)) for t in range(m[r])]
    if not rows:
        return [0] * len(ca), []
    denom = [(total[r] - t) % mod for r, t in zip(rows, steps)]
    assert min(denom) >= 1
    idx = torch.tensor(rows)
    f1, f2 = fold_in_words(row_keys[idx, 0], row_keys[idx, 1], torch.tensor(steps, dtype=torch.int32))
    if wide:
        d = torch.tensor([[x & MASK32, x >> 32] for x in denom], dtype=torch.int64)
        words, tries = TA._randint_tries_u64e(f1, f2, d)
        x = [int(lo) | int(hi) << 32 for lo, hi in words.tolist()]
    else:
        words, tries = TA._randint_tries(f1, f2, torch.tensor(denom, dtype=torch.int64))
        x = words.tolist()
    j_a, rem_a, i = [], list(ca), 0
    for r in range(len(ca)):
        taken = 0
        for _ in range(m[r]):
            take = x[i] < rem_a[r]
            rem_a[r] -= take
            taken += take
            i += 1
        j_a.append(taken)
    return j_a, tries.tolist()


def _wide_planes(x):
    return np.stack([x & np.uint64(MASK32), x >> np.uint64(32)], -1).astype(np.uint32)


@pytest.mark.parametrize("case", ["mixed", "large", "wrapped", "below_k", "a_empty", "rejecting", "wide wrapped",
                                  "wide below_k"])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_merge_scan_counts_the_samples_the_reference_takes_from_a(k, case):
    """The factored plain scan: its ``j_a`` is the number of A's samples in
    the reference's merged rows (A's and B's words are disjoint), and so is
    the step-parallel model's (:func:`_step_parallel_scan`), over int32
    counts (the sum past 2^31, zeros, m < k), uint32 counts (wrapping past
    2^32, and denominators just past 2^31, where lanes reject more than
    once) and WIDE counts (wrapping past 2^64, and m < k)."""
    R = 40
    rng = np.random.default_rng(k)
    if case == "wrapped":
        ca = rng.integers(0, 2**32, R).astype(np.uint32)
        cb = rng.integers(0, 2**32, R).astype(np.uint32)
    elif case == "rejecting":
        ca = rng.integers(0, 2**31, R)
        cb = (2**31 + k + 1 + rng.integers(0, k + 1, R) - ca).astype(np.uint32)
        ca = ca.astype(np.uint32)
    elif case == "wide wrapped":
        ca = np.uint64(2**63) + rng.integers(0, 2**40, R).astype(np.uint64)
        cb = np.uint64(2**63) + rng.integers(0, 2**40, R).astype(np.uint64)
        ca[:3], cb[:3] = [2**63 + 2, 2**64 - 1, 0], [2**63 + 1, 1, 2**64 - 2]
    elif case == "below_k":  # totals under k, zeros among them
        ca, cb = (rng.integers(0, k // 2 + 1, R).astype(np.int32) for _ in range(2))
    elif case == "wide below_k":
        ca = rng.integers(0, k, R).astype(np.uint64) + np.uint64(2**32)
        cb = (np.uint64(2**64 - 2**32) + rng.integers(0, k, R).astype(np.uint64))
    else:
        ca, cb = _counts(rng, R, k, case)
    wide = ca.dtype == np.uint64
    sa = rng.integers(0, 2**30, (R, k)).astype(np.int32)
    sb = rng.integers(2**30, 2**31, (R, k)).astype(np.int32)
    key = jr.key(k + 11)
    jca, jcb = (_wide_planes(c) if wide else c for c in (ca, cb))
    ws, wc = _J_MERGE_SAMPLES(jnp.asarray(sa), jnp.asarray(jca), jnp.asarray(sb), jnp.asarray(jcb), key)
    wc = np.asarray(wc).astype(np.uint64)
    total = wc[:, 0] | wc[:, 1] << np.uint64(32) if wide else wc
    ws, size = np.asarray(ws), np.minimum(total, k).astype(np.int64)
    from_a = (ws < 2**30) & (np.arange(k)[None, :] < size[:, None])
    row_keys = split_keys(key_from_seed(k + 11), R)
    tca, tcb = (torch.from_numpy(c.view(np.int32)).view(torch.uint32) if wide else torch.from_numpy(c)
                for c in (jca, jcb))
    j_a, draws = TA.merge_scan(tca, tcb, row_keys, k)
    assert j_a.dtype == torch.int32
    np.testing.assert_array_equal(j_a.numpy(), from_a.sum(axis=1))
    assert draws >= int(size.sum())  # one word at least a step
    model, tries = _step_parallel_scan([int(x) for x in ca], [int(x) for x in cb], row_keys, k)
    np.testing.assert_array_equal(np.array(model), from_a.sum(axis=1))
    assert sum(tries) == draws
    if case == "rejecting" and k > 1:
        assert max(tries) >= 3  # lanes that rejected twice or more
    if case in ("below_k", "a_empty", "wide below_k"):
        assert (size < k).any() and (size < k).sum() + (size == k).sum() == R


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_merge_with_tied_permutation_keys_equals_the_reference(dtype):
    """Keys of 23 bits tie in about 0.1% of rows at k = 128: an R = 4,096
    merge holds such rows, and the stable argsort breaks their ties by slot
    as the reference's sort does."""
    R, k = 4096, 128
    rng = np.random.default_rng(12)
    words = rng.integers(0, 2**32, (2, R, k), dtype=np.uint64).astype(np.uint32)
    sa, sb = words.view(dtype)
    ca, cb = (rng.integers(k, 4 * k, R).astype(np.int32) for _ in range(2))
    key = jr.key(31)
    u_a, u_b = TA.merge_keys(torch.from_numpy(ca), torch.from_numpy(cb), split_keys(key_from_seed(31), R), k)
    tied = [int(((u[:, 1:] == u[:, :-1])).any(dim=1).sum()) for u in (u_a.sort(1).values, u_b.sort(1).values)]
    assert min(tied) >= 1, tied
    ws, wc = _J_MERGE_SAMPLES(jnp.asarray(sa), jnp.asarray(ca), jnp.asarray(sb), jnp.asarray(cb), key)
    gs, gc = TA.merge_samples(*(torch.from_numpy(x) for x in (sa, ca, sb, cb)), key_from_seed(31))
    _same(gs, ws)
    _same(gc, wc)


@pytest.mark.parametrize("denom", [0, 2**32, -1])
def test_randint_exact_raises_on_a_denominator_outside_the_word_space(denom):
    one = torch.ones(3, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[1, 2\^32\)"):
        TA._randint_exact(one, one, torch.tensor([5, denom, 7], dtype=torch.int64))


def test_the_kernel_path_and_the_plain_merge_agree_on_the_cpu():
    """On CPU tensors ``merge_samples_keyed`` draws through the wrapper's
    plain version: the same as ``merge_from_draws`` over ``merge_draws``,
    and as the wrapper called on its own."""
    R, k = 33, 7
    rng = np.random.default_rng(1)
    sa, sb = (torch.from_numpy(rng.integers(0, 2**31, (R, k)).astype(np.int32)) for _ in range(2))
    ca = torch.from_numpy(rng.integers(0, 2**32, R).astype(np.uint32))
    cb = torch.from_numpy(rng.integers(0, 3 * k, R).astype(np.int32))
    keys = split_keys(key_from_seed(2), R)
    from reservoir_tpu_torch.ops.algorithm_l_cuda import merge_draws_cuda

    got = TA.merge_samples_keyed(sa, ca, sb, cb, keys)
    want = TA.merge_from_draws(sa, ca, sb, cb, TA.merge_draws(ca, cb, keys, k))
    again = TA.merge_from_draws(sa, ca, sb, cb, merge_draws_cuda(ca, cb, keys, k))
    for g, w, a in zip(got, want, again):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))


@pytest.mark.parametrize("k", [1, 8])
def test_a_per_row_signed_mask_reads_each_rows_counts_in_the_dtype_it_names(k):
    """``signed`` reads row r's counts as int32 (bit set) or uint32: each
    row merges as it does with its counts in those dtypes, counts past
    2^31 - 1 among them (negative as int32: their side gives no sample)."""
    R = 64
    rng = np.random.default_rng(k)
    sa, sb = (torch.from_numpy(rng.integers(0, 2**31, (R, k)).astype(np.int32)) for _ in range(2))
    ca, cb = (torch.from_numpy(rng.integers(0, 2**32, R).astype(np.uint32)) for _ in range(2))
    keys = split_keys(key_from_seed(4), R)
    signed = torch.from_numpy(np.arange(R, dtype=np.uint8) % 4)
    got = TA.merge_samples_keyed(sa, ca, sb, cb, keys, signed)
    for flags in range(4):
        rows = signed == flags
        a = ca.view(torch.int32) if flags & 1 else ca
        b = cb.view(torch.int32) if flags & 2 else cb
        want = TA.merge_samples_keyed(sa[rows], a[rows], sb[rows], b[rows], keys[rows])
        for g, w in zip(got, want):
            assert torch.equal(g[rows].view(torch.int32), w.view(torch.int32))
    with pytest.raises(ValueError, match="signed must be uint8"):
        TA.merge_samples_keyed(sa, ca, sb, cb, keys, signed.bool())


# ---------------------------------------------------------------- weighted


def _lkeys(rng, R, k, kind):
    """float32 log keys as bit patterns: random negatives; ``ties`` (a few
    values, so A and B share keys); ``empty`` (-inf tails); ``zeros`` (-0.0
    and 0.0 mixed in); ``nan`` (NaNs of both signs mixed in)."""
    lk = -rng.exponential(1.0, (R, k)).astype(np.float32)
    if kind == "ties":
        lk = -rng.integers(0, 4, (R, k)).astype(np.float32) / 4
    elif kind == "empty":
        filled = rng.integers(0, k + 1, R)
        lk = -np.sort(-lk, axis=1)
        lk[np.arange(k)[None, :] >= filled[:, None]] = -np.inf
    elif kind == "zeros":
        lk[rng.random((R, k)) < 0.3] = 0.0
        lk[rng.random((R, k)) < 0.3] = -0.0
    elif kind == "nan":
        bits = lk.view(np.uint32)
        bits[rng.random((R, k)) < 0.2] = 0x7FC00001
        bits[rng.random((R, k)) < 0.2] = 0xFFC00002
        lk[rng.random((R, k)) < 0.2] = -np.inf
    return lk


@pytest.mark.parametrize("kind", ["random", "ties", "empty", "zeros", "nan"])
@pytest.mark.parametrize("R, k", [(1, 5), (8, 8), (13, 64)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_weighted_merge_parts_equals_jitted_jax(R, k, kind, dtype):
    rng = np.random.default_rng(R + k)
    sa, sb = rng.integers(0, 2**32, (2, R, k), dtype=np.uint64).astype(np.uint32).view(dtype)
    lka, lkb = _lkeys(rng, R, k, kind), _lkeys(rng, R, k, kind)
    ca, cb = rng.integers(0, 10 * k, (2, R)).astype(np.int32)
    want = _J_MERGE_PARTS(*(jnp.asarray(x) for x in (sa, lka, ca, sb, lkb, cb)))
    got = TW.merge_parts(*(torch.from_numpy(x) for x in (sa, lka, ca, sb, lkb, cb)))
    for g, w in zip(got, want):
        _same(g, w)


def test_weighted_merge_of_two_states_keeps_the_first_states_jump_and_key():
    R, k = 5, 4
    rng = np.random.default_rng(2)
    pairs = []
    for seed in (1, 2):
        elems = rng.integers(0, 99, (R, 12)).astype(np.int32)
        weights = rng.uniform(0.0, 2.0, (R, 12)).astype(np.float32)
        js = JW.update(JW.init(jr.key(seed), R, k), jnp.asarray(elems), jnp.asarray(weights))
        ts = weighted_state_from_numpy(np.asarray(js.samples), np.asarray(js.lkeys), np.asarray(js.count),
                                       np.asarray(js.xw), np.asarray(jr.key_data(js.key)), device="cpu")
        pairs.append((js, ts))
    want = JW.merge(pairs[0][0], pairs[1][0])
    got = TW.merge(pairs[0][1], pairs[1][1])
    for f in ("samples", "lkeys", "count", "xw"):
        _same(getattr(got, f), getattr(want, f))
    assert torch.equal(got.key, pairs[0][1].key)


# ---------------------------------------------------------------- distinct


def _distinct_pair(rng, R, k, dtype, kind):
    """Two JAX states over shards of one logical stream (shared salts), and
    the same as port states."""
    wide = dtype == "int64"
    base = JD.init(jr.key(9), R, k, sample_dtype=np.dtype(dtype)) if not wide else None
    out = []
    for shard in range(2):
        n = {"full": 3 * k, "partial": max(1, k // 3), "overlap": 3 * k}[kind]
        hi = 2 * k if kind == "overlap" else 2**31 - 1  # few values: shards share keys
        vals = rng.integers(-hi, hi, (R, n)).astype(np.int64)
        if wide:
            vals = (vals * np.int64(0x9E3779B97F4A7C15 - 2**64)).astype(np.int64)
            js = JD.init(jr.key(9), R, k, sample_dtype=np.dtype("int64"))
            hi_w, lo_w = JD.split_values_host(vals)
            js = JD.update(js, (jnp.asarray(hi_w), jnp.asarray(lo_w)))
        else:
            js = JD.update(base, jnp.asarray(vals.astype(np.int32).view(dtype)))
        out.append(js)
    return out


def _to_port(js):
    return distinct_state_from_numpy(
        np.asarray(js.values), np.asarray(js.hash_hi), np.asarray(js.hash_lo), np.asarray(js.size),
        np.asarray(js.count), np.asarray(js.salts),
        None if js.value_hi is None else np.asarray(js.value_hi), device="cpu")


def _same_distinct(got, want):
    host = distinct_state_to_numpy(got)
    for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts", "value_hi"):
        w = getattr(want, f)
        if w is None:
            assert host[f] is None
        else:
            _same(host[f], w)


@pytest.mark.parametrize("kind", ["full", "partial", "overlap"])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
@pytest.mark.parametrize("R, k", [(1, 5), (8, 8), (13, 64)])
def test_distinct_merge_equals_jitted_jax(R, k, dtype, kind):
    rng = np.random.default_rng(R * k)
    ja, jb = _distinct_pair(rng, R, k, dtype, kind)
    _same_distinct(TD.merge(_to_port(ja), _to_port(jb)), _J_DISTINCT_MERGE(ja, jb))


def test_distinct_merge_tells_padding_by_size_alone():
    # slots past `size` may hold anything (here: small hashes that would win),
    # and a slot below `size` may hold the hash (MAX, MAX): the merge, unlike
    # the update, keeps that one, as the JAX package's does
    R, k = 4, 6
    rng = np.random.default_rng(8)

    def state(size):
        planes = rng.integers(0, 2**32, (3, R, k), dtype=np.uint64).astype(np.uint32)
        order = np.lexsort((planes[2], planes[1]), axis=1)
        hi, lo = (np.take_along_axis(planes[i], order, 1) for i in (1, 2))
        hi[:, size - 1], lo[:, size - 1] = 0xFFFFFFFF, 0xFFFFFFFF  # the largest, held
        hi[:, size:] = 0  # garbage past size
        return JD.DistinctState(
            jnp.asarray(planes[0].view(np.int32)), jnp.asarray(hi), jnp.asarray(lo),
            jnp.full((R,), size, jnp.int32), jnp.full((R,), 100, jnp.int32),
            jnp.asarray(planes[0][:, :4]))

    ja, jb = state(2), state(3)
    want = _J_DISTINCT_MERGE(ja, jb)
    assert (np.asarray(want.size) == 5).all()
    got = TD.merge(_to_port(ja), _to_port(jb))
    _same_distinct(got, want)
    assert (got.hash_hi[:, 4] == -1).all() and (got.size == 5).all()


def test_distinct_merge_rejects_mixed_key_widths():
    narrow = TD.init(key_from_seed(0), 2, 4, device="cpu")
    wide = TD.init(key_from_seed(0), 2, 4, sample_dtype=torch.int64, device="cpu")
    with pytest.raises(ValueError, match="narrow and wide"):
        TD.merge(narrow, wide)
    with pytest.raises(ValueError, match="one dtype"):
        TD.merge(narrow, TD.init(key_from_seed(0), 2, 4, sample_dtype=torch.uint32, device="cpu"))
