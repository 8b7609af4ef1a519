"""The port's merge path against the JAX package's, bit for bit:
``reservoir_tpu_torch.parallel.merge`` (``merge_samples_host``,
``merge_samples_device`` over CPU ranks, the three stream mergers) against
``reservoir_tpu.parallel.merge`` run as ``tests/test_merge_device.py`` runs
it (the XLA collective path on the virtual host devices), on the same numpy
parts made from a seed; the plain version of the all-gather; and the port's
rules (a level of the tree as one batched call, no fallback without a card,
no import of jax).  The tolerance is zero; floats are compared as bits."""

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
from jax.sharding import Mesh

from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import weighted as JW
from reservoir_tpu.parallel import merge as JM
from reservoir_tpu_torch import ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.convert import state_parts
from reservoir_tpu_torch.ops import algorithm_l as TA
from reservoir_tpu_torch.ops import merge_cuda as TMK
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.ops.threefry import fold_in_words
from reservoir_tpu_torch.parallel import merge as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = [1, 2, 3, 5, 8]


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _uniform_parts(n_parts, k, seed, partial, dtype=np.int32):
    """``(sample, count)`` parts; with ``partial`` every second part holds
    fewer than k samples."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(n_parts):
        n = int(rng.integers(1, k)) if partial and p % 2 else int(rng.integers(k, 4 * k))
        words = rng.integers(0, 2**32, min(n, k), dtype=np.uint64).astype(np.uint32)
        parts.append((words.view(dtype), n))
    return parts


_J_WEIGHTED_UPDATE = jax.jit(JW.update)
_J_DISTINCT_UPDATE = jax.jit(JD.update)


def _weighted_parts(n_parts, k, seed=0):
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(n_parts):
        n = 3 * k
        valid = rng.integers(1, n + 1, 1).astype(np.int32)  # some parts stay short of k: -inf slots
        st = _J_WEIGHTED_UPDATE(
            JW.init(jr.key(100 + p), 1, k),
            jnp.asarray((p * 1000 + np.arange(n, dtype=np.int32))[None]),
            jnp.asarray(rng.integers(0, 4, (1, n)).astype(np.float32)),  # zero weights among them
            jnp.asarray(valid),
        )
        parts.append((np.asarray(st.samples)[0], np.asarray(st.lkeys)[0], int(np.asarray(st.count)[0])))
    return parts


def _distinct_parts(n_parts, k, seed=0):
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(n_parts):
        n = 3 * k
        valid = rng.integers(1, n + 1, 1).astype(np.int32)
        st = _J_DISTINCT_UPDATE(JD.init(jr.key(42), 1, k),
                                jnp.asarray(rng.integers(0, 4 * k, (1, n)).astype(np.int32)),
                                jnp.asarray(valid))
        parts.append((np.asarray(st.values)[0], np.asarray(st.hash_hi)[0], np.asarray(st.hash_lo)[0],
                      int(np.asarray(st.size)[0]), int(np.asarray(st.count)[0]), np.asarray(st.salts)[0]))
    return parts


# ------------------------------------------------- merge_samples_host/_device


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("n_parts", PARTS)
def test_merge_samples_host_equals_jax(n_parts, partial):
    k = 6
    parts = _uniform_parts(n_parts, k, seed=n_parts + 10 * partial, partial=partial)
    want, want_total = JM.merge_samples_host(parts, 7, max_sample_size=k)
    got, got_total = TM.merge_samples_host(parts, 7, max_sample_size=k)
    assert got_total == want_total and isinstance(got_total, int)
    _same(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
def test_merge_samples_host_moves_float_and_unsigned_words_as_bits(dtype):
    k = 5
    parts = _uniform_parts(5, k, seed=3, partial=True, dtype=dtype)
    if dtype == np.float32:
        parts[0][0].view(np.uint32)[:2] = (0x80000000, 0x7FC00001)  # -0.0, a NaN payload
    want, _ = JM.merge_samples_host(parts, jr.key(2), max_sample_size=k)
    got, _ = TM.merge_samples_host(parts, np.asarray(jr.key_data(jr.key(2))), max_sample_size=k)
    _same(got, want)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("n_parts", PARTS)
def test_uniform_merge_over_cpu_ranks_equals_the_jax_collective_merge(n_parts, partial):
    k = 4
    parts = _uniform_parts(n_parts, k, seed=n_parts + 10 * partial, partial=partial)
    want, want_total = JM.merge_samples_device(parts, 7, max_sample_size=k, impl="xla")
    for ranks in (2, 4):
        got, got_total = TM.merge_samples_device(parts, 7, max_sample_size=k, devices=["cpu"] * ranks)
        assert got_total == want_total
        _same(got, want)
    host, host_total = TM.merge_samples_device(parts, 7, max_sample_size=k, impl="host")
    assert host_total == want_total
    _same(host, want)


@pytest.mark.parametrize("mode", ["weighted", "distinct"])
@pytest.mark.parametrize("n_parts", PARTS)
def test_state_keyed_merge_over_cpu_ranks_equals_the_jax_collective_merge(n_parts, mode):
    k = 4
    parts = (_weighted_parts if mode == "weighted" else _distinct_parts)(n_parts, k, seed=n_parts)
    want = JM.merge_samples_device(parts, max_sample_size=k, mode=mode, impl="xla")
    for kwargs in ({"devices": ["cpu"] * 3}, {"impl": "host"}):
        got = TM.merge_samples_device(parts, max_sample_size=k, mode=mode, **kwargs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, int):
                assert g == w and isinstance(g, int)
            else:
                _same(g, w)


def test_parts_cut_from_port_engines_merge_as_the_jax_packages_do():
    from reservoir_tpu.config import SamplerConfig as JConfig
    from reservoir_tpu.engine import ReservoirEngine as JEngine

    R, k, B = 5, 4, 16
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 50, (R, B)).astype(np.int32)
    valid = np.array([0, 2, 4, 9, 16], np.int32)
    weights = rng.uniform(0.0, 2.0, (R, B)).astype(np.float32)
    for mode in ("uniform", "weighted", "distinct"):
        kw = dict(max_sample_size=k, num_reservoirs=R, tile_size=B, weighted=mode == "weighted",
                  distinct=mode == "distinct")
        jeng = JEngine(JConfig(**kw), key=3, reusable=True)
        teng = ReservoirEngine(SamplerConfig(**kw), key=3, reusable=True, device="cpu")
        extra = {"weights": weights} if mode == "weighted" else {}
        jeng.sample(tile, valid, **extra)
        teng.sample(tile, valid, **extra)
        parts = state_parts(teng.state)
        assert len(parts) == R
        js = jeng.state
        if mode == "uniform":
            for r, (sample, count) in enumerate(parts):
                assert count == valid[r] and len(sample) == min(valid[r], k)
        elif mode == "distinct":  # shards of one stream share salts
            parts = [p[:5] + (parts[0][5],) for p in parts]
            for r, part in enumerate(parts):
                _same(part[1], np.asarray(js.hash_hi)[r])
        want = JM.merge_samples_device(parts, 5, max_sample_size=k, mode=mode, impl="xla")
        got = TM.merge_samples_device(parts, 5, max_sample_size=k, mode=mode, devices=["cpu"] * 2)
        for g, w in zip(got, want):
            _same(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="narrow"):
        state_parts(ReservoirEngine(SamplerConfig(k, R, B, distinct=True, element_dtype="int64"),
                                    device="cpu").state)


def test_merge_samples_device_validates_like_the_jax_package():
    k = 3
    parts = _uniform_parts(2, k, 0, False)
    with pytest.raises(ValueError, match="mode"):
        TM.merge_samples_device([], 0, max_sample_size=k, mode="nope")
    with pytest.raises(ValueError, match="at least one part"):
        TM.merge_samples_device([], 0, max_sample_size=k)
    with pytest.raises(ValueError, match="at least one part"):
        TM.merge_samples_host([], 0, max_sample_size=k)
    # the JAX package's demotion ladder is not carried over: its rungs are no impls here
    for impl in ("xla", "pallas", "nope"):
        with pytest.raises(ValueError, match="impl"):
            TM.merge_samples_device(parts, 0, max_sample_size=k, impl=impl)
    with pytest.raises(ValueError, match="merge key"):
        TM.merge_samples_device(parts, max_sample_size=k, devices=["cpu"])
    with pytest.raises(ValueError, match="3-tuples"):
        TM.merge_samples_device([(np.zeros(k, np.int32),)] * 2, max_sample_size=k, mode="weighted",
                                devices=["cpu"])
    with pytest.raises(ValueError, match="state rows"):
        TM.merge_samples_device([(np.zeros(k + 2, np.int32), np.zeros(k + 2, np.float32), 1)] * 2,
                                max_sample_size=k, mode="weighted", devices=["cpu"])
    with pytest.raises(ValueError, match="int32, float32 or uint32"):
        TM.merge_samples_device([(np.zeros(k, np.int64), 3)] * 2, 0, max_sample_size=k, devices=["cpu"])


# ------------------------------------------------------------- the tree


def test_a_batched_level_equals_the_pair_by_pair_tree():
    # the JAX package's tree, written out pair by pair with the port's merge
    n_items, R, k = 7, 6, 5
    rng = np.random.default_rng(5)
    samples = torch.from_numpy(rng.integers(0, 2**31, (n_items, R, k)).astype(np.int32))
    count = torch.from_numpy(rng.integers(0, 3 * k, (n_items, R)).astype(np.int32))
    key = key_from_seed(21)
    items = [(samples[i], count[i]) for i in range(n_items)]
    node = 0
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            node += 1
            f1, f2 = fold_in_words(key[0], key[1], torch.tensor(node, dtype=torch.int32))
            nxt.append(TA.merge_samples(items[i][0], items[i][1], items[i + 1][0], items[i + 1][1],
                                        torch.stack([f1, f2])))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    assert node == n_items - 1
    got_s, got_c = TM.uniform_stream_merger(samples, count, 21)
    assert torch.equal(got_s, items[0][0])
    assert got_c.dtype == torch.uint32
    assert torch.equal(got_c.view(torch.int32), items[0][1].view(torch.int32))


# ----------------------------------------------------------- stream mergers


def _mesh(n_shards):
    return Mesh(np.asarray(jax.devices()[:n_shards]), ("stream",))


@pytest.mark.parametrize("n_shards", [2, 3, 5, 8])
def test_uniform_stream_merger_equals_jax(n_shards):
    R, k = 6, 8
    rng = np.random.default_rng(n_shards)
    samples = rng.integers(0, 2**31, (n_shards, R, k)).astype(np.int32)
    count = rng.integers(0, 3 * k, (n_shards, R)).astype(np.int32)
    want_s, want_c = JM.uniform_stream_merger(_mesh(n_shards))(jnp.asarray(samples), jnp.asarray(count),
                                                                jr.key(99))
    got_s, got_c = TM.uniform_stream_merger(torch.from_numpy(samples), torch.from_numpy(count), 99)
    _same(got_s, want_s)
    _same(got_c, want_c)
    # a sequence of per-shard tensors is the same as one stacked tensor
    seq_s, seq_c = TM.uniform_stream_merger([torch.from_numpy(s) for s in samples],
                                            [torch.from_numpy(c) for c in count], 99)
    assert torch.equal(seq_s, got_s) and torch.equal(seq_c.view(torch.int32), got_c.view(torch.int32))


@pytest.mark.parametrize("n_shards", [2, 5])
def test_weighted_stream_merger_equals_jax(n_shards):
    R, k, n = 6, 4, 10
    rng = np.random.default_rng(n_shards)
    step = jax.jit(JW.update)
    states = []
    for s in range(n_shards):
        valid = rng.integers(0, n + 1, R).astype(np.int32)  # some rows stay short of k
        states.append(step(JW.init(jr.key(s), R, k), jnp.asarray(rng.integers(0, 99, (R, n)).astype(np.int32)),
                           jnp.asarray(rng.integers(0, 3, (R, n)).astype(np.float32)), jnp.asarray(valid)))
    leaves = [np.stack([np.asarray(getattr(st, f)) for st in states]) for f in ("samples", "lkeys", "count")]
    want = JM.weighted_stream_merger(_mesh(n_shards))(*(jnp.asarray(x) for x in leaves))
    got = TM.weighted_stream_merger(*(torch.from_numpy(x) for x in leaves))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("n_shards", [2, 5])
def test_distinct_stream_merger_equals_jax_and_one_engine_over_the_whole_stream(n_shards):
    R, k, n = 4, 6, 20
    rng = np.random.default_rng(n_shards)
    base = JD.init(jr.key(2), R, k)  # shared salts across shards
    streams = [rng.integers(0, 60, (R, n)).astype(np.int32) for _ in range(n_shards)]
    states = [JD.update(base, jnp.asarray(s)) for s in streams]
    fields = ("values", "hash_hi", "hash_lo", "size", "count", "salts")
    leaves = [np.stack([np.asarray(getattr(st, f)) for st in states]) for f in fields]
    want = JM.distinct_stream_merger(_mesh(n_shards))(*(jnp.asarray(x) for x in leaves))
    as_port = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x) for x in leaves]
    got = TM.distinct_stream_merger(*as_port)
    for g, w in zip(got, want):
        _same(g.numpy().view(np.asarray(w).dtype), w)
    joint = JD.update(base, jnp.asarray(np.concatenate(streams, axis=1)))
    for g, f in zip(got, fields[:5]):
        _same(g.numpy().view(np.asarray(getattr(joint, f)).dtype), getattr(joint, f))


def test_stream_mergers_reject_ragged_stacks():
    with pytest.raises(ValueError, match="same number of shards"):
        TM.uniform_stream_merger(torch.zeros((3, 2, 4), dtype=torch.int32),
                                 torch.zeros((2, 2), dtype=torch.int32), 0)


# ------------------------------------------------ the all-gather, plain version


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("b, w", [(1, 1), (5, 129), (64, 8)])
def test_ring_all_gather_on_cpu_tensors_is_the_stack_of_the_blocks(d, b, w):
    rng = np.random.default_rng(d)
    blocks = [torch.from_numpy(rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32))
              for _ in range(d)]
    before = TMK.launches
    out = TMK.ring_all_gather(blocks)
    assert TMK.launches == before  # the plain version: no kernel on the CPU
    assert len(out) == d
    for g in out:
        assert g.shape == (d, b, w) and g.dtype == torch.uint32
        for q in range(d):
            assert torch.equal(g[q].view(torch.int32), blocks[q].view(torch.int32))


def test_gather_parts_round_trips_every_leaf_in_rank_major_order():
    d, b, k = 3, 4, 5
    rng = np.random.default_rng(0)
    rank_leaves = []
    for _ in range(d):
        f = rng.integers(0, 2**32, (b, k), dtype=np.uint64).astype(np.uint32)
        f[0, :2] = (0x80000000, 0x7FC00001)  # -0.0 and a NaN payload travel as bits
        rank_leaves.append((torch.from_numpy(f.view(np.float32)),
                            torch.from_numpy(rng.integers(0, 9, b).astype(np.int32)),
                            torch.from_numpy(rng.integers(0, 2**32, (b, 2, 2), dtype=np.uint64).astype(np.uint32))))
    comm = TMK.RingCommunicator(["cpu"] * d)
    out = TMK.gather_parts(rank_leaves, comm)
    assert len(out) == d and comm.epoch == 0
    for leaves in out:
        for i, g in enumerate(leaves):
            assert g.shape == (d * b,) + tuple(rank_leaves[0][i].shape[1:])
            assert g.dtype == rank_leaves[0][i].dtype
            for q in range(d):
                assert g[q * b:(q + 1) * b].numpy().tobytes() == rank_leaves[q][i].numpy().tobytes()


def test_gather_wrapper_rejects_what_the_kernel_does_not_take():
    ok = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="4-byte"):
        TMK.gather_parts([(ok.long(),), (ok.long(),)])
    with pytest.raises(ValueError, match="contiguous"):
        TMK.gather_parts([(ok.t(),), (ok.t(),)])
    with pytest.raises(ValueError, match="rank 0's is"):
        TMK.gather_parts([(ok,), (ok[:2],)])
    with pytest.raises(ValueError, match="rank 0's is"):
        TMK.gather_parts([(ok,), (ok.float(),)])
    with pytest.raises(ValueError, match="leaves for 3 ranks"):
        TMK.gather_parts([(ok,), (ok,)], TMK.RingCommunicator(["cpu"] * 3))
    with pytest.raises(ValueError, match=r"\[b, W\] blocks"):
        TMK.ring_all_gather([ok[0], ok[0]])
    with pytest.raises(ValueError, match="1 to 16 ranks"):
        TMK.RingCommunicator(["cpu"] * 17)
    with pytest.raises(ValueError, match="1 to 8 leaves"):
        TMK.gather_parts([(ok,) * 9])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        TMK.RingCommunicator(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        TMK.RingCommunicator(["meta"])


# ------------------------------------------------------------- port rules


def test_cuda_ranks_without_a_card_raise_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = _uniform_parts(3, 4, 0, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.merge_samples_device(parts, 1, max_sample_size=4)  # default ranks: the visible cards
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.merge_samples_device(parts, 1, max_sample_size=4, devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # a single part has no shortcut past it
        TM.merge_samples_device(parts[:1], 1, max_sample_size=4)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA ranks"):
        TM.merge_samples_device(parts[:1], 1, max_sample_size=4, impl="cuda", devices=["cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMK.RingCommunicator(["cuda:0"])
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA ranks"):
        TM.merge_samples_device(parts, 1, max_sample_size=4, impl="cuda", devices=["cpu"] * 2)
    # a tensor that lies neither on the CPU nor on a card is refused, not moved
    with pytest.raises(ValueError, match="is on meta"):
        TMK.gather_parts([(torch.zeros((2, 2), dtype=torch.int32, device="meta"),)],
                         TMK.RingCommunicator(["cpu"]))


def test_merge_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import reservoir_tpu_torch.parallel.merge, reservoir_tpu_torch.ops.merge_cuda\n"
        "bad = [n for n in sys.modules if n in ('jax', 'reservoir_tpu')\n"
        "       or n.startswith(('jax.', 'reservoir_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
