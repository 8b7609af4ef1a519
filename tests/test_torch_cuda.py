"""The port's CUDA kernels on the card, held against the plain torch versions.

Every test here needs a CUDA card and skips without one.  This file imports
no jax, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reservoir_tpu_torch import ReservoirEngine, SamplerConfig
from reservoir_tpu_torch.ops import algorithm_l as T
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import distinct_cuda as TDK
from reservoir_tpu_torch.ops import fmath
from reservoir_tpu_torch.ops import merge_cuda as TM
from reservoir_tpu_torch.ops import weighted as TW
from reservoir_tpu_torch.ops import weighted_cuda as TWK
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import merge as PM

_FIELDS = ("samples", "count", "nxt", "log_w")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU host: "
                    "python -m pytest --noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda", torch.cuda.current_device())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _clone(state):
    return T.ReservoirState(*(t.clone() for t in state))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 13])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_kernel_equals_plain_version_on_the_card(cuda_device, k, dtype):
    R, B = 1024, 512
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = T.init(key_from_seed(5), R, k, sample_dtype=dtype, device=cuda_device)
    before = TK.launches
    plan = [(7, False, True), (B, False, True), (B, False, False), (B, True, False)]
    for width, ragged, fill in plan:
        tile = torch.randint(-(2**31), 2**31 - 1, (R, width), dtype=torch.int32,
                             device=cuda_device, generator=gen)
        if dtype == torch.float32:
            tile[::5, 0] = -(2**31)  # -0.0
            tile[1::5, -1] = 0x7FC00001  # NaN with a payload
        tile = tile.view(dtype)
        valid = (torch.randint(0, width + 1, (R,), dtype=torch.int32, device=cuda_device,
                               generator=gen) if ragged else None)
        ref = (T.update if fill else T.update_steady)(_clone(s), tile, valid)
        s = (TK.update_cuda if fill else TK.update_steady_cuda)(s, tile, valid)
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), f
    assert TK.launches - before == len(plan)


@pytest.mark.cuda
@pytest.mark.parametrize("name, lo, hi", [("log", 2.0**-24, 1.0), ("exp", -90.0, 0.0),
                                          ("log1p", -1.0, 0.0)])
def test_kernel_fmath_equals_the_recipe(cuda_device, name, lo, hi):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = lo + (hi - lo) * torch.rand(1 << 20, generator=gen, device=cuda_device)
    special = torch.tensor([0.0, -0.0, 1e-40, -1.0, 1.0, float("inf"), float("nan")],
                           device=cuda_device)
    x = torch.cat([x, special])
    assert torch.equal(_bits(TK.fmath_cuda(x, name)), _bits(getattr(fmath, name)(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_card_engine_equals_cpu_engine(cuda_device, dtype):
    R, k, B = 512, 13, 128
    rng = np.random.default_rng(11)
    cfg = SamplerConfig(k, R, B, element_dtype=dtype)
    card = ReservoirEngine(cfg, key=1, device=cuda_device)
    host = ReservoirEngine(cfg, key=1, device="cpu")
    before = TK.launches
    for i in range(4):
        tile = rng.integers(0, 2**32, (R, B), dtype=np.uint64).astype(np.uint32).view(dtype)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        card.sample(torch.from_numpy(tile).to(cuda_device) if i % 2 else tile, valid)
        host.sample(tile, valid)
    assert TK.launches - before == 4
    for a, b in zip(card.result_arrays(), host.result_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_a_tile_on_the_host(cuda_device):
    s = T.init(key_from_seed(0), 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="batch is on cpu"):
        TK.update_cuda(s, torch.zeros((8, 16), dtype=torch.int32))


# ------------------------------------------------------------ weighted kernel

_WFIELDS = ("samples", "lkeys", "count", "xw")


def _wclone(state):
    return TW.WeightedState(*(t.clone() for t in state))


def _card_weights(gen, R, B, device, kind):
    w = torch.exp(torch.randn((R, B), generator=gen, device=device))
    if kind == "zeros":
        w = torch.where(torch.rand((R, B), generator=gen, device=device) < 0.3, 0.0, w)
    elif kind == "subnormal":
        w = torch.where(torch.rand((R, B), generator=gen, device=device) < 0.25, 1e-40, w)
    return w.float().contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 13])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_weighted_kernel_equals_plain_version_on_the_card(cuda_device, k, dtype):
    R, B = 1024, 384
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = TW.init(key_from_seed(5), R, k, sample_dtype=dtype, device=cuda_device)
    before = TWK.launches
    plan = [(7, False, "zeros"), (B, False, "zeros"), (B, False, "lognormal"),
            (B, True, "subnormal"), (200, False, "zeros")]
    for width, ragged, kind in plan:
        elems = torch.randint(-(2**31), 2**31 - 1, (R, width), dtype=torch.int32,
                              device=cuda_device, generator=gen)
        if dtype == torch.float32:
            elems[::5, 0] = -(2**31)  # -0.0
            elems[1::5, -1] = 0x7FC00001  # NaN with a payload
        elems = elems.view(dtype)
        weights = _card_weights(gen, R, width, cuda_device, kind)
        valid = (torch.randint(0, width + 1, (R,), dtype=torch.int32, device=cuda_device,
                               generator=gen) if ragged else None)
        ref = TW.update(_wclone(s), elems, weights, valid)
        s = TWK.update_cuda(s, elems, weights, valid)
        for f in _WFIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), (f, width, kind)
    assert TWK.launches - before == len(plan)


@pytest.mark.cuda
def test_card_weighted_engine_equals_cpu_engine(cuda_device):
    R, k, B = 512, 13, 256
    rng = np.random.default_rng(12)
    cfg = SamplerConfig(k, R, B, weighted=True)
    card = ReservoirEngine(cfg, key=1, device=cuda_device)
    host = ReservoirEngine(cfg, key=1, device="cpu")
    before = TWK.launches
    for i in range(4):
        tile = rng.integers(0, 2**31, (R, B)).astype(np.int32)
        weights = rng.lognormal(0.0, 1.0, (R, B)).astype(np.float32)
        weights[rng.random((R, B)) < 0.3] = 0.0
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        if i % 2:
            card.sample(torch.from_numpy(tile).to(cuda_device), valid,
                        weights=torch.from_numpy(weights).to(cuda_device))
        else:
            card.sample(tile, valid, weights=weights)
        host.sample(tile, valid, weights=weights)
    assert TWK.launches - before == 4
    for a, b in zip(card.result_arrays(), host.result_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_weighted_wrapper_rejects_weights_on_the_host(cuda_device):
    s = TW.init(key_from_seed(0), 8, 4, device=cuda_device)
    elems = torch.zeros((8, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="weights is on cpu"):
        TWK.update_cuda(s, elems, torch.ones((8, 16)))


# ------------------------------------------------------------ distinct kernel

_DFIELDS = ("values", "hash_hi", "hash_lo", "size", "count", "value_hi")


def _dclone(state):
    return TD.DistinctState(*(None if t is None else t.clone() for t in state))


def _card_keys(gen, R, B, device, dtype, kind):
    if kind == "zipf":  # the benchmark's keys: heavy duplication
        u = torch.rand((R, B), generator=gen, device=device) * (1 - 1e-6) + 1e-6
        t = torch.clamp(u ** -10.0, max=1e7).to(torch.int64)
    else:
        t = torch.randint(-(2**62), 2**62, (R, B), generator=gen, device=device)
    if dtype == torch.int64:
        return t * (0x9E3779B97F4A7C15 - 2**64)
    return t.to(torch.int32).view(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 13])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.int64])
def test_distinct_kernel_equals_plain_version_on_the_card(cuda_device, k, dtype):
    R, B = 1024, 256
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = TD.init(key_from_seed(5), R, k, sample_dtype=dtype, device=cuda_device)
    before = TDK.launches
    plan = [(7, False, "random"), (B, False, "zipf"), (B, True, "zipf"), (B, False, "random")]
    for i, (width, ragged, kind) in enumerate(plan):
        tile = _card_keys(gen, R, width, cuda_device, dtype, kind)
        if i == 3:  # repeats of a held value in every third lane
            held = ref.values[:, :1].view(torch.int32)
            if ref.wide:
                held = (ref.value_hi[:, :1].to(torch.int64) << 32) | (held.to(torch.int64) & 0xFFFFFFFF)
            tile.view(held.dtype)[:, ::3] = held
        valid = (torch.randint(0, width + 1, (R,), dtype=torch.int32, device=cuda_device,
                               generator=gen) if ragged else None)
        batch = tile
        if dtype == torch.int64 and i == 1:  # the wide tile as (hi, lo) planes
            v = tile.view(torch.int32).view(R, width, 2)
            batch = (v[..., 1].contiguous(), v[..., 0].contiguous())
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, batch, valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert TDK.launches - before == len(plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("R, k", [(13, 1500), (256, 4000)])
def test_distinct_kernel_with_a_large_block_equals_plain_version(cuda_device, R, k, dtype):
    # k entries a row beyond 48 KiB a block of four warps: the kernel asks
    # for more shared memory, or runs fewer warps a block
    B = 2048
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    s = TD.init(key_from_seed(2), R, k, sample_dtype=dtype, device=cuda_device)
    for kind in ("random", "zipf", "random"):
        tile = _card_keys(gen, R, B, cuda_device, dtype, kind)
        ref = TD.update(_dclone(s), tile)
        s = TDK.update_cuda(s, tile)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), f


@pytest.mark.cuda
def test_distinct_kernel_refuses_a_block_beyond_shared_memory(cuda_device):
    s = TD.init(key_from_seed(0), 4, 14529, sample_dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="too large"):
        TDK.update_cuda(s, torch.zeros((4, 8), dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
def test_card_distinct_engine_equals_cpu_engine(cuda_device, dtype):
    R, k, B = 512, 13, 128
    rng = np.random.default_rng(13)
    cfg = SamplerConfig(k, R, B, element_dtype=dtype, distinct=True)
    card = ReservoirEngine(cfg, key=1, device=cuda_device)
    host = ReservoirEngine(cfg, key=1, device="cpu")
    before = TDK.launches
    for i in range(4):
        tile = np.minimum(rng.uniform(1e-6, 1.0, (R, B)) ** -6.0, 1e7).astype(np.int64).astype(dtype)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        card.sample(torch.from_numpy(tile).to(cuda_device) if i % 2 else tile, valid)
        host.sample(tile, valid)
    host.sample_stream(tile[:, :77])
    card.sample_stream(tile[:, :77])
    assert TDK.launches - before == 5
    for a, b in zip(card.result_arrays(), host.result_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_distinct_wrapper_rejects_a_tile_on_the_host(cuda_device):
    s = TD.init(key_from_seed(0), 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="batch is on cpu"):
        TDK.update_cuda(s, torch.zeros((8, 16), dtype=torch.int32))


# ------------------------------------------------------- the merge all-gather


def _word_blocks(gen, d, b, w, dtype, device):
    """d blocks of random 32-bit words, every bit pattern allowed (NaN
    payloads and -0.0 among the floats)."""
    blocks = []
    for _ in range(d):
        t = torch.randint(-(2**31), 2**31 - 1, (b, w), dtype=torch.int32, device=device, generator=gen)
        t[0, 0] = -(2**31)  # -0.0
        t[-1, -1] = 0x7FC00001  # NaN with a payload
        blocks.append(t.view(dtype))
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("b, w", [(1, 1), (5, 129), (64, 8), (513, 31)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
def test_ring_all_gather_equals_plain_version_on_the_card(cuda_device, d, b, w, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(d * 1000 + b)
    comm = TM.RingCommunicator([cuda_device] * d)
    before = TM.launches
    for call in range(2):  # twice on one communicator: the flags count epochs
        blocks = _word_blocks(gen, d, b, w, dtype, cuda_device)
        got = TM.ring_all_gather(blocks, comm)
        want = TM.ring_all_gather_plain(blocks, comm)
        comm.check()
        assert len(got) == d
        for g, x in zip(got, want):
            assert g.shape == (d, b, w) and g.dtype == dtype
            assert torch.equal(_bits(g), _bits(x)), call
    assert TM.launches - before == 2


@pytest.mark.cuda
def test_gather_parts_equals_plain_version_on_the_card(cuda_device):
    d, b, k = 3, 7, 5
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    comm = TM.RingCommunicator([cuda_device] * d)
    rank_leaves = [
        (_word_blocks(gen, 1, b, k, torch.float32, cuda_device)[0],
         torch.randint(0, 99, (b,), dtype=torch.int32, device=cuda_device, generator=gen),
         _word_blocks(gen, 1, b, 4, torch.uint32, cuda_device)[0])
        for _ in range(d)
    ]
    got = TM.gather_parts(rank_leaves, comm)
    want = TM.gather_parts_plain(rank_leaves, comm)
    comm.check()
    for g_rank, w_rank in zip(got, want):
        for g, x in zip(g_rank, w_rank):
            assert g.shape == x.shape and g.dtype == x.dtype
            assert torch.equal(_bits(g), _bits(x))


@pytest.mark.cuda
def test_gather_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    comm = TM.RingCommunicator([cuda_device] * 2)
    ok = torch.zeros((4, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        TM.ring_all_gather([ok, torch.zeros((4, 3), dtype=torch.int32)], comm)
    with pytest.raises(ValueError, match="4-byte"):
        TM.gather_parts([(ok.long(),), (ok.long(),)], comm)
    with pytest.raises(ValueError, match="contiguous"):
        TM.gather_parts([(ok.t(),), (ok.t(),)], comm)
    with pytest.raises(ValueError, match="rank 0's is"):
        TM.gather_parts([(ok,), (ok[:2].contiguous(),)], comm)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
@pytest.mark.parametrize("n_parts", [2, 3, 5, 8])
def test_card_merge_tree_equals_the_host_tree(cuda_device, mode, n_parts):
    k = 6
    rng = np.random.default_rng(n_parts)
    if mode == "uniform":
        parts = []
        for p in range(n_parts):
            n = int(rng.integers(1, k)) if p % 2 else int(rng.integers(k, 4 * k))
            parts.append((rng.integers(0, 1 << 30, min(n, k)).astype(np.int32), n))
    else:
        cfg = SamplerConfig(k, n_parts, 16, weighted=mode == "weighted", distinct=mode == "distinct")
        eng = ReservoirEngine(cfg, key=2, device="cpu")
        tile = rng.integers(0, 40, (n_parts, 16)).astype(np.int32)
        valid = rng.integers(1, 17, n_parts).astype(np.int32)
        if mode == "weighted":
            eng.sample(tile, valid, weights=rng.uniform(0.5, 2.0, (n_parts, 16)).astype(np.float32))
        else:
            eng.sample(tile, valid)
        from reservoir_tpu_torch.convert import state_parts

        parts = state_parts(eng.state)
        if mode == "distinct":  # shards of one stream share salts
            parts = [p[:5] + (parts[0][5],) for p in parts]
    before = TM.launches
    want = PM.merge_samples_device(parts, 5, max_sample_size=k, mode=mode, impl="host")
    got = PM.merge_samples_device(parts, 5, max_sample_size=k, mode=mode, impl="cuda",
                                  devices=[cuda_device] * 4)
    assert TM.launches - before == 1
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@pytest.mark.cuda
def test_a_rank_that_never_enters_times_out_and_check_raises(cuda_device):
    # two ranks, but only rank 0's launch is made (as if the other card's were
    # refused): rank 0 waits its bounded time, marks its status, and leaves
    import ctypes

    comm = TM.RingCommunicator([cuda_device] * 2)
    blocks = [torch.ones((4, 4), dtype=torch.int32, device=cuda_device) for _ in range(2)]
    outs = [torch.zeros((2, 4, 4), dtype=torch.int32, device=cuda_device) for _ in range(2)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))  # noqa: E731
    code = TM._library().merge_ring_gather(
        ptrs(blocks), ptrs(outs), (ctypes.c_longlong * 1)(16), ptrs(comm.flags()),
        (ctypes.c_int * 1)(0), 1, 2, 1, 1, cuda_device.index, 1,
        torch.cuda.current_stream(cuda_device).cuda_stream,
    )
    assert code == 0
    with pytest.raises(RuntimeError, match="rank 0 .* timed out: a peer rank never entered"):
        comm.check()
    assert int(outs[0][1].abs().sum()) == 0  # nothing was read from the absent rank


# ------------------------------------------- the all-gather over several cards


@pytest.fixture
def cuda_cards():
    """One device a card, on a host with two cards or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: the ranks lie on distinct cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("b, w", [(1, 1), (5, 129), (64, 8), (4096, 129)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
def test_ring_all_gather_over_distinct_cards_equals_plain_version(cuda_cards, d, b, w, dtype):
    # ranks dealt round the cards: with d above the number of cards a card
    # holds several ranks, and reads both local and remote blocks
    ranks = [cuda_cards[r % len(cuda_cards)] for r in range(d)]
    gen = torch.Generator(device=cuda_cards[0]).manual_seed(d * 1000 + b)
    comm = TM.RingCommunicator(ranks)
    before = TM.launches
    for call in range(2):  # twice on one communicator: the flags count epochs
        blocks = [blk.to(rank) for blk, rank in zip(_word_blocks(gen, d, b, w, dtype, cuda_cards[0]), ranks)]
        got = TM.ring_all_gather(blocks, comm)
        want = TM.ring_all_gather_plain(blocks, comm)
        comm.check()
        for rank, g, x in zip(ranks, got, want):
            assert g.device == rank and g.shape == (d, b, w) and g.dtype == dtype
            assert torch.equal(_bits(g), _bits(x)), call
    assert TM.launches - before == 2 * len(set(ranks))  # one launch a card and call


@pytest.mark.cuda
def test_gather_parts_over_distinct_cards_equals_plain_version(cuda_cards):
    d, b, k = 4, 7, 5
    ranks = [cuda_cards[r % len(cuda_cards)] for r in range(d)]
    gen = torch.Generator(device=cuda_cards[0]).manual_seed(3)
    comm = TM.RingCommunicator(ranks)
    rank_leaves = [
        (_word_blocks(gen, 1, b, k, torch.float32, cuda_cards[0])[0].to(rank),
         torch.randint(0, 99, (b,), dtype=torch.int32, device=cuda_cards[0], generator=gen).to(rank),
         _word_blocks(gen, 1, b, 4, torch.uint32, cuda_cards[0])[0].to(rank))
        for rank in ranks
    ]
    got = TM.gather_parts(rank_leaves, comm)
    want = TM.gather_parts_plain(rank_leaves, comm)
    comm.check()
    for g_rank, w_rank in zip(got, want):
        for g, x in zip(g_rank, w_rank):
            assert g.device == x.device and g.shape == x.shape and g.dtype == x.dtype
            assert torch.equal(_bits(g), _bits(x))


@pytest.mark.cuda
def test_a_card_that_never_launches_times_out_the_other_and_check_raises(cuda_cards):
    # two ranks on two cards, but only the first card's launch is made: its
    # rank waits its bounded time on the remote flag, marks its status, leaves
    import ctypes

    ranks = cuda_cards[:2]
    comm = TM.RingCommunicator(ranks)
    blocks = [torch.ones((4, 4), dtype=torch.int32, device=rank) for rank in ranks]
    outs = [torch.zeros((2, 4, 4), dtype=torch.int32, device=rank) for rank in ranks]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))  # noqa: E731
    code = TM._library().merge_ring_gather(
        ptrs(blocks), ptrs(outs), (ctypes.c_longlong * 1)(16), ptrs(comm.flags()),
        (ctypes.c_int * 1)(0), 1, 2, 1, 1, ranks[0].index, 1,
        torch.cuda.current_stream(ranks[0]).cuda_stream,
    )
    assert code == 0
    with pytest.raises(RuntimeError, match="rank 0 .* timed out: a peer rank never entered"):
        comm.check()
    assert int(outs[0][1].abs().sum()) == 0  # nothing was read from the absent card's rank
