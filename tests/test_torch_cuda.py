"""The port's CUDA kernels on the card, held against the plain torch versions.

Every test here needs a CUDA card and skips without one.  This file imports
no jax, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from reservoir_tpu_torch import DeviceSampler, DeviceStreamBridge, ReservoirEngine, SamplerConfig, convert
from reservoir_tpu_torch.ops import algorithm_l as T
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import distinct as TD
from reservoir_tpu_torch.ops import distinct_cuda as TDK
from reservoir_tpu_torch.ops import fmath
from reservoir_tpu_torch.ops import merge_cuda as TM
from reservoir_tpu_torch.ops import u64e as TU
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


def _edge_state(R, k, log_w, count, nxt, key, device):
    """R reservoirs in one numeric corner: the given log W, count, nxt and
    key words in every row, random samples."""
    g = torch.Generator().manual_seed(5)
    return T.ReservoirState(
        samples=torch.randint(0, 100, (R, k), dtype=torch.int32, generator=g).to(device),
        count=torch.full((R,), count, dtype=torch.int32, device=device),
        nxt=torch.full((R,), nxt, dtype=torch.int32, device=device),
        log_w=torch.full((R,), log_w, dtype=torch.float32, device=device),
        key=torch.tensor(key, dtype=torch.int64, device=device).expand(R, 2).contiguous(),
    )


# the numeric corners of tests/test_torch_algorithm_l.py::test_numeric_edges:
# (log_w, count, nxt, key)
_EDGES = {
    "w_is_one": (-1e-9, 100, 101, (1, 2)),
    "w_is_zero": (-110.0, 100, 101, (3, 4)),
    "nan_skip": (-110.0, 22300, 22370, (0x12345678, 0x9ABCDEF0)),
    "w_above_one": (1.0, 100, 101, (5, 6)),
    "saturation": (-40.0, 2**31 - 200, 2**31 - 150, (7, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*_EDGES, "k 1 w_is_one", "k 2 w_is_one", "k 3000 B 512", "B 1",
                                  "B 0", "odd B", "ragged zeros", "count wraps", "float32", "R 1000"])
def test_algl_kernel_paths_equal_plain_version(cuda_device, case):
    """The redesigned kernel's paths, each against the plain version bit for
    bit (samples, count, nxt, log_w) over several tiles: the five numeric
    corners of the CPU edge test; k = 1 and 2 where W starts at 1 (long
    accept lists, many writes to one slot); a fill that spans tiles (k =
    3,000, B = 512); widths 1 and 37 (unaligned rows, the 4-byte fill copy)
    and 0 (an empty tile changes nothing);
    ragged valid counts with zeros; accepts just below 2^31, then a tile
    whose count + valid wraps; float32 tiles with -0.0 and NaN payloads; and an R that is
    not a multiple of the kernel's 128-row blocks."""
    R, k, B, dtype = 256, 16, 256, torch.int32
    plan = [True, True, False, False]  # fill-capable tiles, then steady ones
    gen = torch.Generator(device=cuda_device).manual_seed(len(case))
    if case in _EDGES or case.endswith("w_is_one"):
        name = case.split()[-1]
        R, B, plan = 8, 128, [False, False]
        if case.startswith("k "):
            R, k, plan = 64, int(case.split()[1]), [False, False, False]
        else:
            k = 4
        s = _edge_state(R, k, *_EDGES[name], cuda_device)
    elif case == "count wraps":
        R, k = 64, 8
        s = _edge_state(R, k, -3.0, 2**31 - 100, 2**31 - 50, (9, 10), cuda_device)
        plan = [False, False]
    else:
        if case == "k 3000 B 512":
            k, B, plan = 3000, 512, [True] * 8 + [False]
        elif case == "B 1":
            R, k, B, plan = 300, 5, 1, [True] * 12
        elif case == "B 0":
            R, k, B, plan = 300, 5, 0, [True, False]
        elif case == "odd B":
            R, k, B, plan = 300, 7, 37, [True] * 4 + [False]
        elif case == "float32":
            R, dtype = 1000, torch.float32
        elif case == "R 1000":
            R = 1000
        s = T.init(key_from_seed(len(case)), R, k, sample_dtype=dtype, device=cuda_device)
    before = TK.launches
    for i, fill in enumerate(plan):
        tile = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                             generator=gen)
        if dtype == torch.float32:
            tile[::5, 0] = -(2**31)  # -0.0
            tile[1::5, -1] = 0x7FC00001  # NaN with a payload
            tile[2::7, B // 2] = -1  # 0xFFFFFFFF, a negative NaN
        tile = tile.view(dtype)
        valid = None
        if case == "ragged zeros" or (case == "odd B" and i == 2):
            valid = torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
            valid[::3] = 0
        elif case == "count wraps" and i == 0:  # accepts just below 2^31, no wrap yet
            valid = torch.full((R,), 60, dtype=torch.int32, device=cuda_device)
        ref = (T.update if fill else T.update_steady)(_clone(s), tile, valid)
        s = (TK.update_cuda if fill else TK.update_steady_cuda)(s, tile, valid)
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), (f, i)
    assert TK.launches - before == len(plan)
    if case == "count wraps":
        assert int(s.count[0]) < 0  # count + valid wrapped


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


def _dlaunches():
    """The distinct wrapper's launches: (default, keep-max, pre-hashed)."""
    return TDK.launches, TDK.keepmax_launches, TDK.prehashed_launches


def _dlaunched(before):
    return tuple(a - b for a, b in zip(_dlaunches(), before))


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
    before = _dlaunches()
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
    assert _dlaunched(before) == (3, 1, 0)  # the ragged tile takes keep-max


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


def _as_batch(tile, layout):
    """A wide tile as int64 or as its (hi, lo) planes; a narrow one as is."""
    if layout != "planes":
        return tile
    w = tile.view(torch.int32).view(*tile.shape, 2)
    return w[..., 1].contiguous(), w[..., 0].contiguous()


def _planted_state(R, k, dtype, device, key):
    """An empty state whose salts send ``key`` to the hash (MAX, MAX) in
    every row."""
    from reservoir_tpu_torch.convert import distinct_state_from_numpy, distinct_state_to_numpy
    from reservoir_tpu_torch.ops.hashing import salt_for_target

    host = distinct_state_to_numpy(TD.init(key_from_seed(8), R, k, sample_dtype=dtype))
    salts = host["salts"].copy()
    plant = ((key >> 32) & 0xFFFFFFFF, key & 0xFFFFFFFF)
    for r in range(R):
        salts[r, 2:] = salt_for_target(plant, (0xFFFFFFFF, 0xFFFFFFFF), tuple(int(x) for x in salts[r, :2]))
    host["salts"] = salts
    return distinct_state_from_numpy(**host, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fresh chunk", "one key", "held block", "max max", "k 1", "k 33",
                                  "smem limit", "width 130"])
@pytest.mark.parametrize("layout", ["int32", "int64", "planes"])
def test_distinct_kernel_paths_equal_plain_version(cuda_device, layout, case):
    """The redesigned kernel's paths, each against the plain version bit for
    bit: a chunk of 128 fresh keys from empty (four full rounds of 32
    candidates), chunks of one key repeated, a tile of the keys a full
    block already holds, a key whose salted hash is (MAX, MAX), k = 1 and
    33, k at the shared-memory limit, and a width that is not a multiple of
    4 (4-byte loads), with narrow keys and both wide tile layouts."""
    dtype = torch.int32 if layout == "int32" else torch.int64
    wide = dtype == torch.int64
    R, k, B = 64, 256, 512
    if case in ("k 1", "k 33"):
        k = int(case.split()[1])
    elif case == "smem limit":
        R, k, B = 3, 14528 if wide else 19370, 4096
    elif case == "width 130":
        B = 130
    gen = torch.Generator(device=cuda_device).manual_seed(len(case) * 7 + len(layout))
    planted = 0x0123456789ABCDEF if wide else 123456789
    s = (_planted_state(R, k, dtype, cuda_device, planted) if case == "max max"
         else TD.init(key_from_seed(6), R, k, sample_dtype=dtype, device=cuda_device))

    def held_keys(state):
        lo = state.values.view(torch.int32)
        return lo if not state.wide else (state.value_hi.long() << 32) | (lo.long() & 0xFFFFFFFF)

    def tile_of(i):
        if case == "fresh chunk":
            return _card_keys(gen, R, 128, cuda_device, dtype, "random")
        if case == "one key":  # every chunk of 128 lanes one key, a new one each chunk
            t = _card_keys(gen, R, B // 128, cuda_device, dtype, "random")
            return t.repeat_interleave(128, dim=1).contiguous()
        if case == "held block" and i > 0:
            return held_keys(s).repeat(1, 2).contiguous()
        t = _card_keys(gen, R, B, cuda_device, dtype, "zipf" if i % 2 else "random")
        if case == "max max":
            t.view(torch.int64 if wide else torch.int32)[:, 3::50] = planted
        return t

    before = _dlaunches()
    for i in range(4):
        tile = tile_of(i)
        valid = (torch.randint(0, tile.shape[1] + 1, (R,), dtype=torch.int32, device=cuda_device,
                               generator=gen) if i == 2 else None)
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, _as_batch(tile, layout), valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert _dlaunched(before) == (3, 1, 0)  # the ragged tile takes keep-max
    if case == "max max":
        assert not (held_keys(s) == planted).any()
    if case == "held block":
        assert int(s.size.min()) == k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k 1", "k 5", "k 64", "k 7136", "k 7137", "k 7264", "large k",
                                  "width 300", "dense", "ragged"])
def test_weighted_kernel_paths_equal_plain_version(cuda_device, case):
    """The redesigned kernel's paths, each against the plain version bit for
    bit over a fill tile and steady tiles: k = 1, 5 and 64, the largest k
    whose keys stay on chip (7,136: 4 rows' keys and positions beside the
    4 KiB of draws fill a block's shared memory) and the next ones up, the
    instantiation that keeps the keys in global memory (k = 8,000), a width
    that is not a multiple of 128, a fill tile whose blocks hold dozens of
    acceptances each (lane-parallel draws), and ragged valid counts."""
    R, k, B = 256, 16, 1024
    zeros = True  # every other tile has zero weights
    if case.startswith("k "):
        k = int(case.split()[1])
        if k > 64:  # the fill ends in the third tile (7136, 7137) or the last (7264)
            R, B, zeros = 8, 2400, False
    elif case == "large k":
        R, k, B = 8, 8000, 4096
    elif case == "width 300":
        B = 300
    elif case == "dense":
        R, k = 512, 64
    gen = torch.Generator(device=cuda_device).manual_seed(len(case))
    s = TW.init(key_from_seed(9), R, k, device=cuda_device)
    assert (TWK.kernel_info(k)["dynamic_smem"] > 0) == (k <= 7136)  # keys on chip
    before = TWK.launches
    for i in range(4):
        if case == "dense":  # the benchmark's smooth weights: acceptances come densely
            elems = (i * B + torch.arange(B, dtype=torch.int32, device=cuda_device)).expand(R, B).contiguous()
            weights = (1.0 + 0.5 * torch.cos(elems.float() * 1e-3) ** 2).contiguous()
        else:
            elems = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                                  generator=gen)
            weights = _card_weights(gen, R, B, cuda_device, "zeros" if zeros and i % 2 else "lognormal")
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if case == "ragged" or i == 3 else None)
        ref, accepts = TW.update_accepts(_wclone(s), elems, weights, valid)
        s = TWK.update_cuda(s, elems, weights, valid)
        for f in _WFIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), (f, i)
        if case == "dense" and i == 0:
            assert accepts > 12 * R  # dozens a row, several in every block
    assert TWK.launches - before == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, k", [(torch.int32, 19370), (torch.int32, 19371),
                                      (torch.int64, 14528), (torch.int64, 14529)])
def test_distinct_kernel_beyond_shared_memory_equals_plain_version(cuda_device, dtype, k):
    """The largest k whose row block fits a block's shared memory (one warp
    a block) and the next k up, which runs the instantiation that searches
    and merges the block in place in the state's global arrays: fresh keys
    that fill the rows and evict, a Zipf tile and a ragged tile, bit for bit
    against the plain version."""
    R, B = 5, 12288
    wide = dtype == torch.int64
    on_chip = k in (19370, 14528)
    info = TDK.kernel_info(k, wide)
    assert (info["dynamic_smem"] > 0) == on_chip
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = TD.init(key_from_seed(7), R, k, sample_dtype=dtype, device=cuda_device)
    before = _dlaunches()
    for i, kind in enumerate(("random", "random", "zipf", "random")):
        tile = _card_keys(gen, R, B, cuda_device, dtype, kind)
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if i == 3 else None)
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, tile, valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert _dlaunched(before) == (3, 1, 0)
    assert int(s.size.min()) == k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
def test_card_distinct_engine_equals_cpu_engine(cuda_device, dtype):
    R, k, B = 512, 13, 128
    rng = np.random.default_rng(13)
    cfg = SamplerConfig(k, R, B, element_dtype=dtype, distinct=True)
    card = ReservoirEngine(cfg, key=1, device=cuda_device)
    host = ReservoirEngine(cfg, key=1, device="cpu")
    before = _dlaunches()
    for i in range(4):
        tile = np.minimum(rng.uniform(1e-6, 1.0, (R, B)) ** -6.0, 1e7).astype(np.int64).astype(dtype)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        card.sample(torch.from_numpy(tile).to(cuda_device) if i % 2 else tile, valid)
        host.sample(tile, valid)
    host.sample_stream(tile[:, :77])
    card.sample_stream(tile[:, :77])
    assert _dlaunched(before) == (3, 2, 0)  # the ragged tile and the stream's padded tile: keep-max
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
@pytest.mark.parametrize("d", [1, 2, 8, 16])
def test_gather_at_ranks_of_one_card_takes_every_leaf_layout(cuda_device, d):
    """One launch a call (the bulk copy's tiles, and the threads where a
    block is not 16-byte aligned) equals ``gather_parts_plain`` bit for bit
    over leaves of different lengths: one of many 8 KB tiles and a part
    tile, one whose blocks are 140 bytes (its slots past the first not
    16-byte aligned, its first with a tail of 12 bytes), a ``[b]`` leaf,
    and one whose source starts 4 bytes past a 16-byte boundary."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    comm = TM.RingCommunicator([cuda_device] * d)

    def off_by_four(b, w, dtype):
        flat = torch.randint(-(2**31), 2**31 - 1, (b * w + 1,), dtype=torch.int32, device=cuda_device,
                             generator=gen)
        return flat[1:].view(b, w).view(dtype)

    for call in range(2):
        rank_leaves = [
            (_word_blocks(gen, 1, 1000, 131, torch.float32, cuda_device)[0],
             _word_blocks(gen, 1, 7, 5, torch.int32, cuda_device)[0],
             torch.randint(0, 99, (1000,), dtype=torch.int32, device=cuda_device, generator=gen),
             off_by_four(33, 3, torch.uint32))
            for _ in range(d)
        ]
        assert all(leaves[3].data_ptr() % 16 == 4 for leaves in rank_leaves)
        before = TM.launches
        got = TM.gather_parts(rank_leaves, comm)
        assert TM.launches - before == 1
        want = TM.gather_parts_plain(rank_leaves, comm)
        comm.check()
        for g_rank, w_rank in zip(got, want):
            for g, x in zip(g_rank, w_rank):
                assert g.shape == x.shape and g.dtype == x.dtype
                assert torch.equal(_bits(g), _bits(x)), call


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


# ------------------------------------------------------------- stream bridge


def _card_and_cpu_state_equal(card, host):
    for a, b in zip(card.engine.state, host.engine.state):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu().contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
def test_bridge_on_the_card_holds_pinned_tiles(cuda_device):
    for cfg in (SamplerConfig(8, 64, 32), SamplerConfig(8, 64, 32, weighted=True),
                SamplerConfig(8, 64, 32, distinct=True, element_dtype="uint64")):
        bridge = DeviceStreamBridge(cfg, key=1, device=cuda_device)
        assert bridge.device == cuda_device and len(bridge._pinned) == 2
        for pinned, tile in zip(bridge._pinned, bridge._tiles):
            assert pinned.is_pinned() and tile.ctypes.data == pinned.data_ptr()
            assert tile.dtype == np.dtype(cfg.element_dtype) and tile.shape == (64, 32)
        if cfg.weighted:
            assert all(w.is_pinned() for w in bridge._wpinned)
    serial = DeviceStreamBridge(SamplerConfig(8, 64, 32), key=1, device=cuda_device, pipelined=False)
    assert len(serial._pinned) == 1


@pytest.mark.cuda
def test_pinned_tile_reuse_waits_for_the_copy(cuda_device):
    # many flushes of a few elements each from a large tile: the demux of
    # the next tile takes microseconds, the copy of the last one (the whole
    # [S, B] tile) milliseconds, so a tile handed back to the demux before
    # its copy completed would send the card the next flush's elements
    S, B = 65536, 512
    cfg = SamplerConfig(4, S, B)
    rng = np.random.default_rng(2)
    rounds = [(rng.integers(0, S, 3000).astype(np.int32), rng.integers(0, 1 << 30, 3000).astype(np.int32))
              for _ in range(24)]
    out = []
    for pipelined in (True, False):
        bridge = DeviceStreamBridge(cfg, key=3, device=cuda_device, pipelined=pipelined)
        for streams, elems in rounds:
            bridge.push_interleaved(streams, elems)
            bridge.flush()
        bridge.drain_barrier()
        assert bridge.metrics.flushes == len(rounds)
        out.append(bridge.engine.peek_arrays())
        assert bridge.metrics.copy_s > 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_bridge_runs_on_the_stream_current_at_construction(cuda_device):
    # built under a side stream, fed and completed from the default one:
    # the worker's kernels, push_tile's and the result's reads all run on
    # the side stream, in order
    S, B = 1024, 128
    cfg = SamplerConfig(8, S, B)
    rng = np.random.default_rng(3)
    streams = rng.integers(0, S, S * B * 3).astype(np.int32)
    elems = rng.integers(0, 1 << 30, streams.size).astype(np.int32)
    tile = rng.integers(0, 1 << 30, (S, B)).astype(np.int32)
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        card = DeviceStreamBridge(cfg, key=1, device=cuda_device)
    assert card._stream == side
    host = DeviceStreamBridge(cfg, key=1, device="cpu")
    for b in (card, host):
        b.push_interleaved(streams, elems)
        b.push_tile(tile)
        b.push_interleaved(streams[::-1].copy(), elems)
    for a, b in zip(card.complete(), host.complete()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "weighted"])
def test_ragged_bridge_flushes_equal_the_plain_version(cuda_device, mode):
    S, B, k = 4096, 256, 16
    cfg = SamplerConfig(k, S, B, weighted=mode == "weighted")
    rng = np.random.default_rng(4)
    n = S * B * 2
    # random streams: every flush is ragged; every 97th row gets only a
    # few elements and stays below k
    streams = rng.integers(0, S, n).astype(np.int32)
    keep = streams % 97 != 0
    streams = streams[keep]
    elems = rng.integers(-(2**31), 2**31 - 1, streams.size).astype(np.int32)
    weights = rng.uniform(0.0, 2.0, streams.size).astype(np.float32) if cfg.weighted else None
    before = (TWK if cfg.weighted else TK).launches
    card = DeviceStreamBridge(cfg, key=6, device=cuda_device)
    host = DeviceStreamBridge(cfg, key=6, device="cpu")
    for b in (card, host):
        b.push_interleaved(streams, elems, weights=weights)
        for r in range(0, S, 97):
            few = r % k
            b.push(r, elems[:few], weights=None if weights is None else weights[:few])
        b.flush()
        b.drain_barrier()
    assert (TWK if cfg.weighted else TK).launches - before == card.metrics.flushes > 2
    _card_and_cpu_state_equal(card, host)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_distinct_bridge_equals_the_card_engine(cuda_device, dtype):
    S, B, k = 1024, 256, 32
    cfg = SamplerConfig(k, S, B, distinct=True, element_dtype=dtype)
    rng = np.random.default_rng(8)
    steps = 4
    tiles = [(rng.integers(0, 5000, (S, B)) * np.int64(0x9E3779B97F4A7C15 - 2**64)).astype(dtype)
             for _ in range(steps)]
    lockstep = np.tile(np.arange(S, dtype=np.int32), B)
    bridge = DeviceStreamBridge(cfg, key=2, device=cuda_device)
    engine = ReservoirEngine(cfg, key=2, device=cuda_device)
    for tile in tiles:
        # one full tile a step: the bridge flushes exactly these tiles
        bridge.push_interleaved(lockstep, np.ascontiguousarray(tile.T).ravel())
        engine.sample(tile)
    bridge.push(3, tiles[0][0, :5])
    last = np.zeros((S, B), dtype)
    last[3, :5] = tiles[0][0, :5]
    engine.sample(last, valid=np.eye(1, S, 3, dtype=np.int32)[0] * 5)
    bridge.flush()
    bridge.drain_barrier()
    assert bridge.metrics.flushes == steps + 1
    for a, b in zip(bridge.engine.peek_arrays(), engine.peek_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_device_sampler_on_the_card_equals_the_cpu(cuda_device):
    cfg = SamplerConfig(128, 1, 2048)
    data = np.random.default_rng(5).integers(0, 1 << 30, 2048 * 5 + 77).astype(np.int32)
    card = DeviceSampler(cfg, key=4, device=cuda_device)
    host = DeviceSampler(cfg, key=4, device="cpu")
    for s in (card, host):
        s.sample_all(data)
    np.testing.assert_array_equal(card.result(), host.result())


# -------------------------------------------------------------- skip gate


class _Engine:
    """What the gate's resync reads of an engine."""

    def __init__(self, state):
        self._state = state
        self.reset_epochs = 0


def _gated_tiles(state, tile, m, cap):
    """The skip gate's candidate tile for ``tile[r, :m[r]]`` from ``state``
    (card tensors), built by the port's replica: rows whose candidates
    overflow ``cap`` take nothing.  Returns ``(gtile, nvalid, advance)``
    on the card."""
    from reservoir_tpu_torch.stream.gate import SkipGate

    R, B = tile.shape
    gate = SkipGate(R, state.k, B, np.dtype(str(tile.dtype).replace("torch.", "")), cap=cap)
    gate.resync(_Engine(state))
    m = np.asarray(m, np.int32).copy()
    ev = gate.evaluate(m)
    m[ev.n_cand > cap] = 0
    ev = gate.evaluate(m)
    gate.append(tile.cpu().numpy(), m, ev)
    gtile, nvalid, advance, _ = gate.take()
    dev = tile.device
    return (torch.from_numpy(gtile).to(dev), torch.from_numpy(nvalid).to(dev),
            torch.from_numpy(advance).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 6])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_gated_kernel_equals_plain_version_on_the_card(cuda_device, k, dtype):
    """``algl_update_gated`` against the plain ``update_gated`` on the card,
    bit for bit, from states across the fill's end, steady (count 4 B) and
    deep (count 24 B), with rows of nvalid 0 and advance 0, advances past
    the fill with few candidates and float payloads with -0.0 and NaN; the
    gated state also equals the full tile's update."""
    R, B, cap = 4096, 256, 64
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    rng = np.random.default_rng(k)
    s0 = T.init(key_from_seed(5), R, k, sample_dtype=dtype, device=cuda_device)

    def tiles(n):
        out = []
        for _ in range(n):
            t = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                              generator=gen)
            t[::5, 0] = -(2**31)
            t[1::5, 3] = 0x7FC00001
            out.append(t.view(dtype))
        return out

    # k - 3 elements a row, then the deeper states
    near = T.update(_clone(s0), tiles(1)[0], torch.full((R,), k - 3, dtype=torch.int32,
                                                          device=cuda_device))
    steady = _clone(s0)
    for t in tiles(4):
        steady = TK.update_cuda(steady, t)
    deep = _clone(steady)
    for t in tiles(20):
        deep = TK.update_steady_cuda(deep, t)
    before = TK.gated_launches
    launches = 0
    for state, hi in ((s0, 60), (near, 12), (steady, B + 1), (deep, B + 1)):
        tile = tiles(1)[0]
        m = rng.integers(0, hi, R).astype(np.int32)
        m[::7] = 0  # nvalid 0, advance 0
        gtile, nvalid, advance = _gated_tiles(state, tile, m, cap)
        ref = T.update_gated(_clone(state), gtile, nvalid, advance)
        got = TK.update_gated_cuda(_clone(state), gtile, nvalid, advance)
        full = TK.update_cuda(_clone(state), tile, advance)
        launches += 1
        torch.cuda.synchronize()
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(ref, f))), f
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(full, f))), f
    assert TK.gated_launches - before == launches


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 6, 128])
def test_update_kernel_over_the_shared_chain_equals_plain_version(cuda_device, k):
    """``algl_update`` walks the chain of ``csrc/algl_chain.cuh``, shared with
    the gated kernel and the host replica: fill, steady and ragged tiles
    stay bit-identical to the plain version."""
    R, B = 2048, 512
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = T.init(key_from_seed(9), R, k, device=cuda_device)
    for fill, ragged in ((True, False), (True, True), (False, False), (False, True)):
        tile = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                             generator=gen)
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if ragged else None)
        ref = (T.update if fill else T.update_steady)(_clone(s), tile, valid)
        s = (TK.update_cuda if fill else TK.update_steady_cuda)(s, tile, valid)
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), f


@pytest.mark.cuda
def test_gated_kernel_on_an_empty_candidate_tile_advances_the_counts(cuda_device):
    R, k = 256, 8
    s = T.init(key_from_seed(2), R, k, device=cuda_device)
    advance = torch.arange(R, dtype=torch.int32, device=cuda_device) % 3
    empty = torch.zeros((R, 0), dtype=torch.int32, device=cuda_device)
    ref = T.update_gated(_clone(s), empty, torch.zeros_like(advance), advance)
    got = TK.update_gated_cuda(_clone(s), empty, torch.zeros_like(advance), advance)
    for f in _FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(ref, f))), f


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["push", "interleaved"])
def test_gated_bridge_on_the_card_equals_the_ungated_card_bridge(cuda_device, feed):
    """A gated bridge on the card: one ``algl_update_gated`` a gated
    dispatch, one ``algl_update`` a fallback flush, and the ungated card
    bridge's state; then journaled, dropped and recovered on the card."""
    S, B, k = 1024, 256, 16
    cfg = SamplerConfig(k, S, B)
    rng = np.random.default_rng(12)
    rounds = 12
    data = rng.integers(-(2**31), 2**31 - 1, (S, rounds * B)).astype(np.int32)
    lockstep = np.tile(np.arange(S, dtype=np.int32), B)
    gated = DeviceStreamBridge(cfg, key=3, device=cuda_device, gated=True, gate_tile=32)
    ungated = DeviceStreamBridge(cfg, key=3, device=cuda_device)
    for b in (gated, ungated):
        before = (TK.launches, TK.gated_launches)
        for t in range(rounds):
            cols = slice(t * B, (t + 1) * B)
            if feed == "push":
                for s in range(S):
                    b.push(s, data[s, cols])
            else:
                b.push_interleaved(lockstep, np.ascontiguousarray(data[:, cols].T).ravel())
        b.flush()
        b.drain_barrier()
        m = b.metrics
        assert TK.gated_launches - before[1] == m.gated_dispatches
        assert TK.launches - before[0] == m.flushes - m.gated_dispatches
    assert gated.metrics.gated_dispatches >= 1 and gated.metrics.gate_bytes_elided > 0
    assert gated.gate_active and gated._gate.native
    for a, b in zip(gated.engine.state, ungated.engine.state):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_gated_recovery_on_the_card(cuda_device, tmp_path):
    S, B, k = 512, 128, 8
    cfg = SamplerConfig(k, S, B)
    data = np.random.default_rng(13).integers(0, 1 << 30, (S, 16 * B)).astype(np.int32)

    def run(bridge, rounds):
        for t in range(rounds):
            for s in range(S):
                bridge.push(s, data[s, t * B:(t + 1) * B])

    whole = DeviceStreamBridge(cfg, key=4, device=cuda_device, gated=True, gate_tile=16)
    run(whole, 16)
    want = whole.complete()
    ckdir = str(tmp_path / "ck")
    dropped = DeviceStreamBridge(cfg, key=4, device=cuda_device, gated=True, gate_tile=16,
                                 checkpoint_dir=ckdir, checkpoint_every=2)
    run(dropped, 8)
    dropped.drain_barrier()
    assert dropped.metrics.gated_dispatches >= 1
    del dropped
    from reservoir_tpu_torch.stream.bridge import _FlushJournal

    # the journal holds the frames since the last checkpoint: each gated
    # one replays through one algl_update_gated launch
    gated_frames = sum(rec[5] is not None for rec in _FlushJournal.read_records(
        os.path.join(ckdir, "journal.bin"), S, B, np.int32, False))
    before = TK.gated_launches
    recovered = DeviceStreamBridge.recover(ckdir, device=cuda_device)
    assert TK.gated_launches - before == gated_frames
    counts = recovered.engine.state.count.cpu().numpy()
    for s in range(S):
        recovered.push(s, data[s, counts[s]:])
    for a, b in zip(recovered.complete(), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero beside full rows", "Bg 61 k 13", "across the fill's end",
                                  "replica Bg 37 k 13"])
def test_gated_kernel_stress_cases_equal_plain_version(cuda_device, case):
    """``algl_update_gated`` against the plain ``update_gated`` where a
    redesign could go wrong: rows with no candidate beside rows with all Bg,
    a gate tile and a k that are not multiples of 4, a state across the
    fill's end (the fill prefix and the acceptances in one row), and a
    replica-built tile at such widths, which must also equal ``algl_update``
    over the whole tile."""
    R = 3001
    k, Bg = {"zero beside full rows": (128, 64), "Bg 61 k 13": (13, 61),
             "across the fill's end": (16, 48), "replica Bg 37 k 13": (13, 37)}[case]
    gen = torch.Generator(device=cuda_device).manual_seed(Bg)
    rng = np.random.default_rng(k)
    s = T.init(key_from_seed(7), R, k, device=cuda_device)
    start = {"zero beside full rows": 4 * k, "Bg 61 k 13": 9 * k, "across the fill's end": k - 5,
             "replica Bg 37 k 13": 3 * k}[case]
    s = TK.update_cuda(s, torch.randint(-(2**31), 2**31 - 1, (R, start), dtype=torch.int32,
                                        device=cuda_device, generator=gen))
    if case == "replica Bg 37 k 13":
        B = 160
        tile = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                             generator=gen)
        gtile, nvalid, advance = _gated_tiles(s, tile, rng.integers(0, B + 1, R).astype(np.int32), Bg)
        full = TK.update_cuda(_clone(s), tile, advance)
    else:
        gtile = torch.randint(-(2**31), 2**31 - 1, (R, Bg), dtype=torch.int32, device=cuda_device,
                              generator=gen)
        nv = rng.choice([0, Bg], R) if case == "zero beside full rows" else rng.integers(0, Bg + 1, R)
        nvalid = torch.from_numpy(nv.astype(np.int32)).to(cuda_device)
        # the kernel and the plain version walk the chain over the candidates
        # whatever the advance; past the fill, the advance only moves count
        advance = nvalid + torch.from_numpy(rng.integers(0, 50, R).astype(np.int32)).to(cuda_device)
        full = None
    before = TK.gated_launches
    ref = T.update_gated(_clone(s), gtile, nvalid, advance)
    got = TK.update_gated_cuda(_clone(s), gtile, nvalid, advance)
    torch.cuda.synchronize()
    assert TK.gated_launches - before == 1
    for f in _FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(ref, f))), f
        if full is not None:
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(full, f))), f


# ------------------------------------------------------------ merge kernel


def _merge_counts(rng, R, k, case):
    """uint32 counts ``[2, R]`` for one of the merge kernel's cases."""
    if case == "partial":
        return rng.integers(0, 2 * k, (2, R))
    if case == "one side empty":
        c = rng.integers(0, 4 * k, (2, R))
        c[rng.integers(0, 2, R), np.arange(R)] = 0
        return c
    if case == "past 2^31":
        return rng.integers(2**30, 2**31, (2, R))
    if case == "wrapping past 2^32":
        return rng.integers(2**31, 2**32, (2, R))
    assert case == "rejecting"  # denominators just past 2^31
    a = rng.integers(0, 2**31, R)
    return np.stack([a, 2**31 + k + 1 + rng.integers(0, k + 1, R) - a])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["partial", "one side empty", "past 2^31", "wrapping past 2^32",
                                  "rejecting"])
@pytest.mark.parametrize("k", [1, 5, 128, 1000])
def test_merge_kernel_equals_plain_version_on_the_card(cuda_device, k, case):
    """``algl_merge_draws`` against the plain ``merge_draws`` on the card,
    bit for bit (j_a and both sides' keys), for int32 and uint32 counts
    (an int32 view of a count past 2^31 - 1 is negative, and masks its
    side); the merge through it equals the plain merge for int32, uint32 and
    float32 words with NaN payloads; one launch a merge and no host sync."""
    R = 1000
    rng = np.random.default_rng(k)
    counts = torch.from_numpy(_merge_counts(rng, R, k, case).astype(np.uint32).view(np.int32)).to(cuda_device)
    keys = torch.from_numpy(rng.integers(0, 2**32, (R, 2)).astype(np.int64)).to(cuda_device)
    words = rng.integers(0, 2**32, (2, R, k), dtype=np.uint64).astype(np.uint32)
    words[:, :, 0] = 0x7FC00001  # a NaN payload
    words[:, ::3, -1] = 0x80000000  # -0.0
    for dtypes in ((torch.int32, torch.uint32), (torch.uint32, torch.int32)):
        ca, cb = (counts[i].contiguous().view(dt) for i, dt in enumerate(dtypes))
        want = T.merge_draws(ca, cb, keys, k)
        before = TK.merge_launches
        got = TK.merge_draws_cuda(ca, cb, keys, k)
        torch.cuda.synchronize()
        assert TK.merge_launches - before == 1
        for f in ("j_a", "u_a", "u_b"):
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
        for dtype in (np.int32, np.uint32, np.float32):
            sa, sb = (torch.from_numpy(w.view(dtype)).to(cuda_device) for w in words)
            want_s, want_c = T.merge_from_draws(sa, ca, sb, cb, want)
            torch.cuda.synchronize()
            before = TK.merge_launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                got_s, got_c = T.merge_samples_keyed(sa, ca, sb, cb, keys)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert TK.merge_launches - before == 1
            assert torch.equal(_bits(got_s), _bits(want_s))
            assert torch.equal(_bits(got_c), _bits(want_c))


@pytest.mark.cuda
def test_merge_kernel_rows_with_tied_keys_keep_the_stable_order(cuda_device):
    """Keys of 23 bits tie in ~0.1% of rows at k = 128: the merge through
    the kernel equals the plain merge on the card and on the CPU, on a set
    of rows that holds ties."""
    R, k = 8192, 128
    rng = np.random.default_rng(3)
    ca, cb = (torch.from_numpy(rng.integers(k, 4 * k, R).astype(np.int32)).to(cuda_device) for _ in range(2))
    keys = torch.from_numpy(rng.integers(0, 2**32, (R, 2)).astype(np.int64)).to(cuda_device)
    sa, sb = (torch.from_numpy(rng.integers(-(2**31), 2**31, (R, k)).astype(np.int32)).to(cuda_device)
              for _ in range(2))
    draws = TK.merge_draws_cuda(ca, cb, keys, k)
    u = torch.sort(draws.u_a, dim=1).values
    assert bool((u[:, 1:] == u[:, :-1]).any())
    got = T.merge_samples_keyed(sa, ca, sb, cb, keys)
    plain = T.merge_from_draws(sa, ca, sb, cb, T.merge_draws(ca, cb, keys, k))
    host = T.merge_samples_keyed(*(t.cpu() for t in (sa, ca, sb, cb, keys)))
    for g, p, h in zip(got, plain, host):
        assert torch.equal(_bits(g), _bits(p))
        assert torch.equal(_bits(g).cpu(), _bits(h))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4, 5, 7])
def test_uniform_stream_merger_launches_the_merge_kernel_once_a_level(cuda_device, shards):
    """The stream merger on the card reaches the merge kernel: one launch a
    tree level, the level's pairs batched (an input's count beside merged
    ones too, each read in its own dtype by the row's signed flags), and its
    result equals the merger on the CPU, counts past 2^31 - 1 (negative
    int32) among the inputs."""
    R, k = 300, 16
    rng = np.random.default_rng(shards)
    samples = [torch.from_numpy(rng.integers(0, 2**31, (R, k)).astype(np.int32)).to(cuda_device)
               for _ in range(shards)]
    counts = [torch.from_numpy(rng.integers(0, 2**32, R).astype(np.uint32).view(np.int32)).to(cuda_device)
              for _ in range(shards)]
    levels, n = 0, shards
    while n > 1:
        levels += 1
        n = n // 2 + n % 2
    before = TK.merge_launches
    got = PM.uniform_stream_merger(samples, counts, 3)
    assert TK.merge_launches - before == levels
    want = PM.uniform_stream_merger([s.cpu() for s in samples], [c.cpu() for c in counts], 3)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g).cpu(), _bits(w))


# ---------------------------------------------- the operator and the server


_OPERATOR_FLOWS = {
    "uniform": dict(max_sample_size=128, key=0, tile_size=1024),
    "distinct32": dict(max_sample_size=256, key=1, tile_size=1024, distinct=True),
    "distinct64": dict(max_sample_size=256, key=2, tile_size=1024, distinct=True,
                       element_dtype="int64"),
}


def _operator_stream(flow, n):
    rng = np.random.default_rng(7)
    if flow == "uniform":
        return rng.integers(-(2**31), 2**31, n).astype(np.int32)
    keys = np.minimum(rng.random(n) ** -10.0, 1e7).astype(np.int64)
    return keys if flow == "distinct64" else keys.astype(np.int32)


def _flow_launches():
    return np.array([TK.launches, TDK.launches, TDK.keepmax_launches])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async", "cancel"])
@pytest.mark.parametrize("flow", sorted(_OPERATOR_FLOWS))
def test_sample_device_on_the_card_equals_the_cpu(cuda_device, flow, mode):
    """``Sample.device`` on the card against the same flow with
    ``device="cpu"``, bit for bit: one kernel launch a full tile and one for
    the ragged remainder (at completion, or at a graceful cancel)."""
    import asyncio

    from reservoir_tpu_torch import Sample

    n = 1024 * 5 + 37
    stream = _operator_stream(flow, n)
    stop = 1024 * 3 + 500 if mode == "cancel" else n
    out, launched = [], []
    for device in (cuda_device, "cpu"):
        f = Sample.device(**_OPERATOR_FLOWS[flow], device=device)
        before = _flow_launches()
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
            for _ in range(stop):
                next(run)
            run.cancel()
            res = run.sample.result(timeout=60)
        launched.append((_flow_launches() - before).tolist())
        out.append(np.asarray(res))
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0].dtype == out[1].dtype
    tiles = -(-stop // 1024)
    # a sampler's flushes pass valid: keep-max for distinct
    assert launched == [[0, 0, tiles] if flow.startswith("distinct") else [tiles, 0, 0], [0, 0, 0]]


@pytest.mark.cuda
def test_two_connection_sample_server_on_the_card_equals_the_cpu(cuda_device):
    """A ``SampleServer`` whose factory makes card ``DeviceSampler``s: two
    connections at once, each reply equal to a CPU ``DeviceSampler`` fed
    that connection's stream, with 16 launches a connection's 16 full tiles
    and one for its ragged remainder (the counts are taken under a lock)."""
    import socket
    import struct
    import threading

    from reservoir_tpu_torch.stream.interop import SampleServer

    def factory(mode, k):
        return DeviceSampler(SamplerConfig(k, 1, tile_size=1024), key=0, device=cuda_device)

    streams = [np.random.default_rng(i).integers(0, 2**31, 1024 * 16 + 300 + i) for i in range(2)]
    replies = [None, None]

    def recv(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk
            buf += chunk
        return buf

    def client(i):
        with socket.create_connection(srv.address, timeout=60) as s:
            s.sendall(b"RSV1" + bytes([0]) + struct.pack(">I", 128))
            for chunk in np.array_split(streams[i], 4):
                arr = chunk.astype(">i8")
                s.sendall(b"B" + struct.pack(">I", arr.size) + arr.tobytes())
            s.sendall(b"C")
            head = recv(s, 5)
            (size,) = struct.unpack(">I", head[1:])
            replies[i] = np.frombuffer(recv(s, 8 * size), ">i8").astype(np.int64)

    before = TK.launches
    with SampleServer(sampler_factory=factory) as srv:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert TK.launches - before == 2 * 17
    for data, got in zip(streams, replies):
        ref = DeviceSampler(SamplerConfig(128, 1, tile_size=1024), key=0, device="cpu")
        ref.sample_all(data)
        np.testing.assert_array_equal(got, ref.result().astype(np.int64))


def _state_bytes(state):
    return [None if t is None else t.detach().cpu().contiguous().view(torch.uint8) for t in state]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct"])
def test_row_operations_on_the_card_equal_the_cpu(cuda_device, mode):
    """reset_rows (a repeated row, k = 13, not a power of two), export_rows
    and adopt_rows on the card equal the same calls with device="cpu", and
    no row operation launches an update kernel."""
    R, k, B = 512, 13, 64
    cfg = SamplerConfig(k, R, tile_size=B, weighted=mode == "weighted", distinct=mode == "distinct")
    counter = {"uniform": TK, "weighted": TWK, "distinct": TDK}[mode]
    engines = {d: [ReservoirEngine(cfg, key=s, reusable=True, device=d) for s in (0, 1)]
               for d in (cuda_device, "cpu")}
    rng = np.random.default_rng(3)

    def feed():
        tile = rng.integers(0, 1 << 30, (R, B)).astype(np.int32) % (97 if mode == "distinct" else 1 << 30)
        kw = {"weights": rng.uniform(0.1, 2.0, (R, B)).astype(np.float32)} if mode == "weighted" else {}
        for engs in engines.values():
            for eng in engs:
                eng.sample(tile, **kw)

    feed()
    feed()
    rows = rng.permutation(R)[:100]
    rows = np.concatenate([rows, rows[:3]])
    before = counter.launches
    for engs in engines.values():
        engs[0].reset_rows(rows, 123)
        engs[1].adopt_rows(rows[:50], engs[0].export_rows(rows[50:100]))
    torch.cuda.synchronize()
    assert counter.launches == before
    feed()
    feed()
    assert counter.launches - before == 2 * 2
    for card, cpu in zip(engines[cuda_device], engines["cpu"]):
        assert card.reset_epochs == cpu.reset_epochs == 1
        for a, b in zip(_state_bytes(card.state), _state_bytes(cpu.state)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "distinct"])
def test_service_on_the_card_equals_the_cpu(cuda_device, mode):
    """A ReservoirService on the card (sessions recycled through reset_rows)
    gives every snapshot of the same service with device="cpu"."""
    from reservoir_tpu_torch import ReservoirService

    cfg = SamplerConfig(8, 64, tile_size=128, distinct=mode == "distinct")
    services = [ReservoirService(cfg, key=5, coalesce_bytes=4096, device=d) for d in (cuda_device, "cpu")]
    rng = np.random.default_rng(8)
    for i in range(96):  # 32 evictions
        chunk = rng.integers(0, 1 << 20, 50).astype(np.int32) % (500 if mode == "distinct" else 1 << 20)
        for svc in services:
            svc.open_session(f"s{i}")
            svc.ingest(f"s{i}", chunk)
    for svc in services:
        svc.sync()
    assert services[0].metrics.snapshot() == services[1].metrics.snapshot()
    assert services[0].metrics.recycles == 32
    for s in services[1].table.sessions():
        np.testing.assert_array_equal(services[0].snapshot(s.key), services[1].snapshot(s.key))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "weighted", "distinct", "gated"])
def test_standby_on_the_card_equals_one_on_the_cpu(cuda_device, mode, tmp_path):
    """A primary and its StandbyReplica on the card, and the same on the
    CPU, given the same calls (a recycled row among them): after every poll
    the card standby equals its primary and the CPU standby, it launches
    one update kernel a shipped tile, and after the promotion the card's
    promoted primary equals the CPU's."""
    from reservoir_tpu_torch.serve import ReservoirService, StandbyReplica

    cfg = SamplerConfig(8, 48, tile_size=64, weighted=mode == "weighted", distinct=mode == "distinct")
    pairs = {}
    for d in (cuda_device, "cpu"):
        ck = str(tmp_path / str(d))
        svc = ReservoirService(cfg, key=4, checkpoint_dir=ck, checkpoint_every=1 << 30, coalesce_bytes=4096,
                               gated=mode == "gated", device=d)
        pairs[d] = [svc, StandbyReplica(ck, device=d)]
    rng = np.random.default_rng(12)
    kernels = (TK, TWK, TDK)
    for r in range(4):
        keys = [f"s{i}" for i in range(40 + 2 * r)]
        chunks = rng.integers(0, 1 << 30, (len(keys), 70)).astype(np.int32) % (300 if mode == "distinct" else 1 << 30)
        w = rng.uniform(0.1, 2.0, chunks.shape).astype(np.float32) if mode == "weighted" else None
        for svc, _ in pairs.values():
            if r == 2:
                svc.close_session("s0")  # its row recycles at the next open
            for i, key in enumerate(keys):
                if key not in svc.table:
                    svc.open_session(key)
                svc.ingest(key, chunks[i], None if w is None else w[i])
            svc.sync()
        before = sum(k.launches for k in kernels) + TK.gated_launches + TDK.keepmax_launches
        standby = pairs[cuda_device][1]
        seq0 = standby.applied_seq
        standby.poll()
        torch.cuda.synchronize()
        applied = standby.applied_seq - seq0
        assert sum(k.launches for k in kernels) + TK.gated_launches + TDK.keepmax_launches - before == applied > 0
        pairs["cpu"][1].poll()
        states = [h.bridge.engine.peek_arrays() for p in pairs.values() for h in (p[0], p[1].service)]
        for s in states[1:]:
            np.testing.assert_array_equal(s[0], states[0][0])
            np.testing.assert_array_equal(s[1], states[0][1])
    promoted = [p[1].promote() for p in pairs.values()]
    for key in [s.key for s in promoted[1].table.sessions()]:
        np.testing.assert_array_equal(promoted[0].snapshot(key), promoted[1].snapshot(key))


@pytest.mark.cuda
def test_two_shard_cluster_merges_on_the_card_as_on_the_host(cuda_device, tmp_path):
    """Two shards on the card: merged_snapshot() and device="cuda" equal the
    device="host" merge for groups of 1 to 8 keys, with one
    merge_ring_gather launch and one algl_merge_draws launch a tree level
    a card call; a migration reads the same before and after; everything
    equals a CPU cluster's."""
    from reservoir_tpu_torch.serve import ShardedReservoirService

    cfg = SamplerConfig(8, 32, tile_size=64)
    clusters = [ShardedReservoirService(cfg, 2, str(tmp_path / name), key=6, coalesce_bytes=4096, devices=devs)
                for name, devs in (("card", None), ("cpu", ["cpu", "cpu"]))]
    rng = np.random.default_rng(2)
    keys = [f"k{i}" for i in range(24)]
    for cl in clusters:
        for key in keys:
            cl.open_session(key)
    for _ in range(3):
        chunks = rng.integers(0, 1 << 30, (len(keys), 50)).astype(np.int32)
        for cl in clusters:
            for key, chunk in zip(keys, chunks):
                cl.ingest(key, chunk)
            cl.sync()
    assert clusters[0].unit(0).service.device.type == "cuda"
    for n in (1, 2, 3, 5, 8):
        group = [keys[int(j)] for j in rng.integers(0, len(keys), n)]
        ring, draws = TM.launches, TK.merge_launches
        host = clusters[0].merged_snapshot(group, merge_key=n, device="host")
        assert (TM.launches, TK.merge_launches) == (ring, draws)
        default = clusters[0].merged_snapshot(group, merge_key=n)
        card = clusters[0].merged_snapshot(group, merge_key=n, device="cuda")
        levels = 0
        while n > 1:
            n, levels = n // 2 + n % 2, levels + 1
        assert (TM.launches - ring, TK.merge_launches - draws) == (2 if levels else 0, 2 * levels)
        np.testing.assert_array_equal(default, host)
        np.testing.assert_array_equal(card, host)
        np.testing.assert_array_equal(host, clusters[1].merged_snapshot(group, merge_key=len(group)))
    before = clusters[0].snapshot("k3")
    for cl in clusters:
        cl.migrate("k3", 1 - cl.shard_of("k3"))
    np.testing.assert_array_equal(clusters[0].snapshot("k3"), before)
    np.testing.assert_array_equal(clusters[1].snapshot("k3"), before)


# ------------------------------------------------------------ WIDE counters


def _wide_lifted(R, k, B, shift, device, gen):
    """A WIDE state past its fill with imminent accepts (``nxt = count + 1 +
    U[0, 3B)``), re-based to ``count + shift``."""
    s = T.init(key_from_seed(6), R, k, count_dtype="wide", device=device)
    s = TK.update_cuda(s, torch.randint(0, 2**30, (R, 2 * k), dtype=torch.int32, device=device,
                                        generator=gen))
    off = 1 + torch.randint(0, 3 * B, (R,), dtype=torch.int64, device=device, generator=gen)
    count = TU.add64(TU.words(s.count), TU.from_int(shift, (R,), device))
    return s._replace(count=TU.to_u32(count), nxt=TU.to_u32(TU.add_u32(count, off)))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, (1 << 31) - 300, (1 << 32) - 300, (1 << 33) + 12345])
@pytest.mark.parametrize("k", [16, 13, 6])
def test_wide_kernel_equals_plain_version_across_each_boundary(cuda_device, k, shift):
    R, B = 1024, 512
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    s = _wide_lifted(R, k, B, shift, cuda_device, gen)
    start = TU.words(s.count)
    before = TK.wide_launches
    for i in range(3):
        tile = torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=cuda_device,
                             generator=gen)
        valid = torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device,
                              generator=gen) if i == 2 else None
        ref = T.update_steady(_clone(s), tile, valid)
        s = TK.update_steady_cuda(s, tile, valid)
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), f
    assert TK.wide_launches - before == 3
    # every row took its elements exactly, across the boundary
    assert torch.equal(TU.words(s.count), TU.add_u32(start, 2 * B + valid.long()))


@pytest.mark.cuda
def test_wide_kernel_fill_and_misaligned_counters_equal_plain_version(cuda_device):
    """Fill tiles from empty, and counters whose words do not start on 8
    bytes (the wrapper copies them into aligned tensors)."""
    R, k, B = 1000, 13, 64
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    s = T.init(key_from_seed(2), R, k, count_dtype="wide", device=cuda_device)
    s32 = T.init(key_from_seed(2), R, k, device=cuda_device)
    for i in range(3):
        tile = torch.randint(-(2**31), 2**31 - 1, (R, 5 if i == 0 else B), dtype=torch.int32,
                             device=cuda_device, generator=gen)
        if i == 1:  # counters at an odd word offset
            for name in ("count", "nxt"):
                buf = torch.empty(2 * R + 1, dtype=torch.int32, device=cuda_device)
                buf[1:].copy_(getattr(s, name).view(torch.int32).flatten())
                s = s._replace(**{name: buf[1:].view(R, 2).view(torch.uint32)})
            assert s.count.data_ptr() % 8 == 4
        ref = T.update(_clone(s), tile)
        s = TK.update_cuda(s, tile)
        s32 = TK.update_cuda(s32, tile)
        for f in _FIELDS:
            assert torch.equal(_bits(getattr(s, f)), _bits(getattr(ref, f))), f
        # a zero high word: the int32 kernel's state
        assert torch.equal(s.samples, s32.samples) and torch.equal(s.log_w, s32.log_w)
        assert torch.equal(TU.words(s.nxt)[:, 0], s32.nxt.long())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 128])
def test_wide_merge_kernel_equals_plain_version(cuda_device, k):
    R = 512
    rng = np.random.default_rng(k)
    ca = rng.integers(0, 1 << 40, R).astype(np.uint64)
    cb = rng.integers(0, 1 << 40, R).astype(np.uint64)
    ca[:8] = [0, 1, 2**32 - 1, 2**32 + 1, 2**63 + 5, 2**64 - 5, 3, 0]
    cb[:8] = [0, 2, 2**32 + 5, 2**32 - 3, 2**63, 7, 2**31 + 1, 5]

    def planes(x):
        w = np.stack([(x & np.uint64(0xFFFFFFFF)), x >> np.uint64(32)], -1).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).view(torch.uint32).to(cuda_device)

    keys = torch.randint(0, 2**32, (R, 2), dtype=torch.int64, device=cuda_device)
    before = TK.wide_merge_launches
    got = TK.merge_draws_cuda(planes(ca), planes(cb), keys, k)
    want = T.merge_draws(planes(ca), planes(cb), keys, k)
    assert TK.wide_merge_launches - before == 1
    for f in ("j_a", "u_a", "u_b"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    s = torch.randint(0, 2**30, (R, k), dtype=torch.int32, device=cuda_device)
    m_s, m_c = T.merge_samples_keyed(s, planes(ca), s + 1, planes(cb), keys)
    assert m_c.shape == (R, 2) and TK.wide_merge_launches - before == 2
    w_s, w_c = T.merge_from_draws(s, planes(ca), s + 1, planes(cb), want)
    assert torch.equal(m_s, w_s) and torch.equal(_bits(m_c), _bits(w_c))


def _edge_counts(rng, R, k, wide):
    """``[2, R]`` counts of every kind a row's scan meets: both zero, under
    k (m < k), and, narrow, totals wrapping past 2^32 and denominators just
    past 2^31 (about every second attempt rejected); WIDE, counts just
    under 2^32 and pairs past 2^63 whose totals wrap past 2^64 (one of them
    to 3)."""
    kind = rng.integers(0, 4, R)
    under = rng.integers(0, k, (2, R))
    if wide:
        big = (np.uint64(2**32) - rng.integers(1, 4 * k, (2, R)).astype(np.uint64),
               np.uint64(2**63) + rng.integers(0, 2**40, (2, R)).astype(np.uint64))
        c = np.where(kind == 0, np.uint64(0), np.where(kind == 1, under.astype(np.uint64),
                                                       np.where(kind == 2, big[0], big[1])))
        c[:, -1] = [2**63 + 2, 2**63 + 1]
        return c.astype(np.uint64)
    a = rng.integers(0, 2**31, R)
    rejecting = np.stack([a, 2**31 + k + 1 + rng.integers(0, k + 1, R) - a])
    c = np.where(kind == 0, 0, np.where(kind == 1, under,
                                        np.where(kind == 2, rng.integers(2**31, 2**32, (2, R)), rejecting)))
    return c.astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("R, k", [(1, 3), (33, 33), (1000, 129), (97, 300)])
def test_step_parallel_draws_kernel_at_edge_shapes(cuda_device, wide, R, k):
    """The draws kernels (every step's draw in parallel, then the compare
    chain) against the plain ``merge_draws`` bit for bit, one launch a
    call: k not a multiple of 4 or of 32 and past one chunk of 128 steps,
    R not a multiple of a block's 32 rows, rows with m < k, and counts
    across 2^32 (narrow, with both signed readings) or across 2^32 and
    2^64 (WIDE)."""
    rng = np.random.default_rng(R * 1000 + k)
    counts = _edge_counts(rng, R, k, wide)
    keys = torch.from_numpy(rng.integers(0, 2**32, (R, 2)).astype(np.int64)).to(cuda_device)
    if wide:
        w = np.stack([counts & np.uint64(0xFFFFFFFF), counts >> np.uint64(32)], -1).astype(np.uint32)
        cases = [tuple(torch.from_numpy(w[i].view(np.int32)).view(torch.uint32).to(cuda_device)
                       for i in range(2))]
    else:
        c = torch.from_numpy(counts.view(np.int32)).to(cuda_device)
        cases = [tuple(c[i].contiguous().view(dt) for i, dt in enumerate(dtypes))
                 for dtypes in ((torch.int32, torch.uint32), (torch.uint32, torch.int32))]
    for ca, cb in cases:
        want = T.merge_draws(ca, cb, keys, k)
        before = TK.wide_merge_launches if wide else TK.merge_launches
        got = TK.merge_draws_cuda(ca, cb, keys, k)
        torch.cuda.synchronize()
        assert (TK.wide_merge_launches if wide else TK.merge_launches) - before == 1
        for f in ("j_a", "u_a", "u_b"):
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f


@pytest.mark.cuda
def test_card_wide_engine_equals_cpu_engine(cuda_device):
    R, k, B = 512, 13, 128
    rng = np.random.default_rng(12)
    cfg = SamplerConfig(k, R, B, count_dtype="wide")
    card = ReservoirEngine(cfg, key=1, device=cuda_device, reusable=True)
    host = ReservoirEngine(cfg, key=1, device="cpu", reusable=True)
    before = TK.wide_launches, TK.launches
    for i in range(4):
        tile = rng.integers(0, 2**31, (R, B)).astype(np.int32)
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        card.sample(torch.from_numpy(tile).to(cuda_device) if i % 2 else tile, valid)
        host.sample(tile, valid)
    card.reset_rows([1, 7, 7], 4)
    host.reset_rows([1, 7, 7], 4)
    for _ in range(2):
        tile = rng.integers(0, 2**31, (R, B)).astype(np.int32)
        card.sample(tile)
        host.sample(tile)
    assert (TK.wide_launches - before[0], TK.launches - before[1]) == (6, 0)
    for name, a in convert.state_to_numpy(card.state).items():
        np.testing.assert_array_equal(a, convert.state_to_numpy(host.state)[name])
    for a, b in zip(card.result_arrays(), host.result_arrays()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- the hooks (L5) and fused stream (L7)


def _pre_hashes(tile, how):
    """Pre-scramble hash planes (int32) for a tile of keys: a hash that
    collides often (``collide``: the keys' low nibble under a zero high
    word), or a mix of both words (``mix``)."""
    x = tile.view(torch.int64) if tile.dtype.itemsize == 8 else tile.view(torch.int32).to(torch.int64)
    if how == "collide":
        hi, lo = torch.zeros_like(x), x & 0xF
    else:
        hi, lo = ((x >> 32) ^ (x * 31)) & 0xFFFFFFFF, (x ^ (x >> 7)) & 0xFFFFFFFF
    to32 = lambda w: torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()  # noqa: E731
    return to32(hi), to32(lo)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["collide", "mix"])
@pytest.mark.parametrize("dtype, R, k, B", [
    (torch.int32, 512, 16, 256), (torch.int64, 512, 16, 256), (torch.int32, 64, 1, 130),
    (torch.int32, 3, 19370, 4096), (torch.int32, 3, 19371, 4096),
    (torch.int64, 3, 14528, 4096), (torch.int64, 3, 14529, 4096),
])
def test_prehashed_distinct_kernel_equals_plain_version(cuda_device, dtype, R, k, B, how):
    """The pre-hashed instantiation against ``update_prehashed``, bit for
    bit, narrow and wide, on chip and beyond shared memory (the k on each
    side of the limit), with a hash that gives many keys one hash (the
    order falls to the value words) and one that mixes them; a tile from
    empty, a Zipf tile, a ragged tile and fresh keys."""
    wide = dtype == torch.int64
    on_chip = TDK.kernel_info(k, wide, rule=TDK.HASHED)["dynamic_smem"] > 0
    assert on_chip == (TDK.kernel_info(k, wide)["dynamic_smem"] > 0)
    gen = torch.Generator(device=cuda_device).manual_seed(k + B)
    s = TD.init(key_from_seed(3), R, k, sample_dtype=dtype, device=cuda_device)
    before = (TDK.launches, TDK.prehashed_launches)
    for i, kind in enumerate(("random", "zipf", "zipf", "random")):
        tile = _card_keys(gen, R, B, cuda_device, dtype, kind)
        hashes = _pre_hashes(tile, how)
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if i == 2 else None)
        ref = TD.update_prehashed(_dclone(s), tile, hashes, valid)
        s = TDK.update_prehashed_cuda(s, _as_batch(tile, "planes" if wide and i == 1 else "int64"),
                                      hashes, valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert (TDK.launches, TDK.prehashed_launches) == (before[0], before[1] + 4)


@pytest.mark.cuda
def test_a_user_hash_of_max_max_is_kept_on_the_card(cuda_device):
    """Salts that send a pre-scramble hash to (MAX, MAX): the pre-hashed
    kernel keeps the key while the row is not full (the reference's XLA
    rule under a hash_fn), as its plain version does."""
    R, k, B = 32, 256, 128  # k > B: no row fills
    plant = 123456789
    s = _planted_state(R, k, torch.int32, cuda_device, plant)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tile = _card_keys(gen, R, B, cuda_device, torch.int32, "random")
    tile[:, 5] = plant
    hashes = (torch.where(tile < 0, -1, 0).to(torch.int32), tile.clone())  # the default hash's words
    ref = TD.update_prehashed(_dclone(s), tile, hashes)
    s = TDK.update_prehashed_cuda(s, tile, hashes)
    for f in _DFIELDS:
        a, b = getattr(s, f), getattr(ref, f)
        assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    assert (s.values == plant).any(dim=1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "none valid", "all valid", "planted", "k past shared memory"])
@pytest.mark.parametrize("layout", ["int32", "uint32", "int64", "planes"])
def test_keepmax_kernel_equals_plain_version_at_edge_shapes(cuda_device, layout, case):
    """The keep-max instantiation (``valid`` given) against the plain
    version, bit for bit: ragged counts, 0 and B valid in every row, a
    planted key whose salted hash is (MAX, MAX) in rows that are not full
    (kept, as XLA keeps it), on chip and at the first k past shared memory,
    narrow, uint32 and int64 keys, the wide tile also as (hi, lo) planes."""
    dtype = {"int32": torch.int32, "uint32": torch.uint32}.get(layout, torch.int64)
    wide = dtype == torch.int64
    R, k, B = 256, 256, 512
    if case == "k past shared memory":
        R, k, B = 3, 14529 if wide else 19371, 12288
        assert TDK.kernel_info(k, wide, rule=TDK.KEEPMAX)["dynamic_smem"] == 0
    else:
        assert TDK.kernel_info(k, wide, rule=TDK.KEEPMAX)["dynamic_smem"] > 0
    gen = torch.Generator(device=cuda_device).manual_seed(len(case) + len(layout))
    planted = 0x0123456789ABCDEF if wide else 123456789
    s = (_planted_state(R, k, dtype, cuda_device, planted) if case == "planted"
         else TD.init(key_from_seed(6), R, k, sample_dtype=dtype, device=cuda_device))
    before = _dlaunches()
    for i, kind in enumerate(("random", "zipf", "random")):
        tile = _card_keys(gen, R, B, cuda_device, dtype, kind)
        if case == "planted":
            tile.view(torch.int64 if wide else torch.int32)[:, 3] = planted
        if case == "none valid":
            valid = torch.zeros(R, dtype=torch.int32, device=cuda_device)
        elif case == "all valid":
            valid = torch.full((R,), B, dtype=torch.int32, device=cuda_device)
        else:
            valid = torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
            if case == "planted":  # rows that stay below k, and the planted lane inside
                valid = torch.randint(4, k // 2, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, _as_batch(tile, layout), valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
        if case == "planted" and i == 0:
            assert (_held(s) == planted).any(dim=1).all()
    assert _dlaunched(before) == (0, 3, 0)


def _held(state):
    lo = state.values.view(torch.int32)
    return lo if not state.wide else (state.value_hi.long() << 32) | (lo.long() & 0xFFFFFFFF)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["ragged", "mapped"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_a_planted_max_max_key_is_kept_on_a_ragged_and_a_mapped_tile(cuda_device, dtype, how):
    """Rows whose salts send a key to the hash (MAX, MAX), none full: a
    ragged tile and a mapped tile (``map_fn`` alone) keep the key, as the
    reference's XLA sort-merge keeps it, through one keep-max launch and
    bit for bit as the plain version; the same full tile unmapped and
    without ``valid`` drops it (the Pallas rule of the default kernel)."""
    wide = dtype == torch.int64
    R, k, B = 64, 512, 256
    planted = 0x0123456789ABCDEF if wide else 123456789
    s = _planted_state(R, k, dtype, cuda_device, planted)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    tile = _card_keys(gen, R, B, cuda_device, dtype, "random")
    mask = (1 << 57) - 1 if wide else (1 << 30) - 1  # keeps the planted key
    map_fn = (lambda x: x & mask) if how == "mapped" else None
    tile.view(torch.int64 if wide else torch.int32)[:, 7] = planted
    valid = (torch.randint(8, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
             if how == "ragged" else None)
    if how == "mapped":  # the planted key itself survives the map
        assert int(map_fn(torch.tensor(planted)).item()) == planted
    before = _dlaunches()
    ref = TD.update(_dclone(s), tile, valid, map_fn=map_fn)
    got = TDK.update_cuda(_dclone(s), tile, valid, map_fn=map_fn)
    assert _dlaunched(before) == (0, 1, 0)
    for f in _DFIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    assert (_held(got) == planted).any(dim=1).all()
    default = TDK.update_cuda(_dclone(s), tile.clone() if map_fn is None else map_fn(tile))
    assert _dlaunched(before) == (1, 1, 0)
    assert not (_held(default) == planted).any()


def _colliding(tile, how):
    """Pre-scramble hash planes that tie many keys: every key one hash
    (``one``), 3 hashes (``three``), or the planted hash of
    :func:`_planted_state` for every key (``max``)."""
    x = tile.view(torch.int64) if tile.dtype.itemsize == 8 else tile.view(torch.int32).to(torch.int64)
    if how == "one":
        hi, lo = torch.full_like(x, 7), torch.full_like(x, 12345)
    elif how == "three":
        hi, lo = torch.zeros_like(x), (x & 0x7FFFFFFF) % 3
    else:
        hi, lo = torch.zeros_like(x), torch.full_like(x, 123456789)
    to32 = lambda w: torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()  # noqa: E731
    return to32(hi), to32(lo)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["one", "three", "max"])
@pytest.mark.parametrize("dtype, R, k, B", [(torch.int32, 256, 64, 512), (torch.int64, 256, 64, 512),
                                            (torch.int32, 64, 256, 130), (torch.int32, 3, 19371, 4096)])
def test_prehashed_kernel_under_heavy_collisions_equals_plain_version(cuda_device, dtype, R, k, B, how):
    """The redesigned pre-hashed kernel against ``update_prehashed`` where
    the 64-bit hash orders nothing: many keys of one hash (the block's
    entries, the round's candidates and the threshold all tie, so every
    order and every repeat falls to the value words), three hashes, and a
    user hash that the salts send to (MAX, MAX) for every key (kept while
    a row is not full, then ordered by value at the threshold); fresh keys,
    repeats of held keys and a ragged tile."""
    wide = dtype == torch.int64
    s = (_planted_state(R, k, dtype, cuda_device, 123456789) if how == "max"
         else TD.init(key_from_seed(12), R, k, sample_dtype=dtype, device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(k + B + len(how))
    before = _dlaunches()
    for i in range(4):
        if i == 2:  # repeats of held keys beside fresh ones
            tile = _held(s)[:, :B // 2].repeat(1, 2)[:, :B].contiguous()
            tile = torch.cat([tile, _card_keys(gen, R, B - tile.shape[1], cuda_device, dtype, "random")], 1)
            tile = tile.to(dtype) if wide else tile.view(dtype).contiguous()
        else:
            tile = _card_keys(gen, R, B, cuda_device, dtype, "zipf" if i == 1 else "random")
        hashes = _colliding(tile, how)
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if i == 3 else None)
        ref = TD.update_prehashed(_dclone(s), tile, hashes, valid)
        s = TDK.update_prehashed_cuda(s, tile, hashes, valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert _dlaunched(before) == (0, 0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_prehashed_kernel_builds_without_spills(cuda_device, wide):
    """The redesigned pre-hashed kernel at the distinct shape (k = 256,
    four warps a block, one row a warp) spills nothing, narrow and wide,
    and keeps eight blocks an SM."""
    info = TDK.kernel_info(256, wide, rule=TDK.HASHED)
    assert info["local_bytes"] == 0, info
    assert info["warps_per_sm"] == 32, info


_HOOK_MODES = {
    "uniform": (dict(sample_dtype="float32"), lambda x: (x >> 8).to(torch.float32) * 0.5, None),
    "wide": (dict(count_dtype="wide"), lambda x: x * 3 + 7, None),
    "weighted": (dict(weighted=True), lambda x: x ^ 0x5A5A, None),
    "distinct": (dict(distinct=True), lambda x: x & 0x3FFF, lambda v: (v >> 16, v * 31)),
    "distinct_map": (dict(distinct=True), lambda x: x & 0x3FFF, None),
    "distinct_int64": (dict(distinct=True, element_dtype="int64"), lambda x: x & ~0xFFFF000,
                       lambda x: ((x >> 32) ^ x, x & 0xFF)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_HOOK_MODES))
def test_hooked_card_engine_equals_the_cpu_engine(cuda_device, mode):
    """A hooked engine on the card (map the tile, hash it, launch) against
    ``device="cpu"`` (the plain versions, map on accept), one launch a tile."""
    kw, map_fn, hash_fn = _HOOK_MODES[mode]
    R, k, B = 512, 13, 128
    cfg = SamplerConfig(k, R, B, **kw)
    card = ReservoirEngine(cfg, key=1, map_fn=map_fn, hash_fn=hash_fn, device=cuda_device)
    host = ReservoirEngine(cfg, key=1, map_fn=map_fn, hash_fn=hash_fn, device="cpu")
    rng = np.random.default_rng(17)
    counts = lambda: (TK.launches + TK.wide_launches, TWK.launches, *_dlaunches())  # noqa: E731
    before = counts()
    for i in range(4):
        tile = rng.integers(0, 1 << 20, (R, B)).astype(kw.get("element_dtype", "int32"))
        w = rng.uniform(0.0, 2.0, (R, B)).astype(np.float32) if kw.get("weighted") else None
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 3 else None
        card.sample(torch.from_numpy(tile).to(cuda_device) if i % 2 else tile, valid, weights=w)
        host.sample(tile, valid, weights=w)
    got = [a - b for a, b in zip(counts(), before)]
    # a distinct tile under a hash_fn takes the pre-hashed instantiation, a
    # mapped one without keep-max
    assert sum(got) == 4 and got[2] == 0
    assert got[4] == (4 if hash_fn is not None and kw.get("distinct") else 0)
    assert got[3] == (4 if hash_fn is None and kw.get("distinct") else 0)
    for a, b in zip(card.result_arrays(), host.result_arrays()):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_bridge_with_a_dtype_changing_map_equals_the_cpu_bridge(cuda_device, gated):
    """A bridge whose map turns int32 elements into float32 samples, gated
    or not, against ``device="cpu"``: a card flush ships the demux's
    element bytes, and the engine maps them (the gated bridge's fill
    flushes take that path too)."""
    S, B, n = 64, 16, 160
    cfg = SamplerConfig(4, S, B, sample_dtype="float32")
    data = np.random.default_rng(23).integers(0, 1 << 30, (S, n)).astype(np.int32)
    ids = np.tile(np.arange(S, dtype=np.int32), B)

    def run(device):
        bridge = DeviceStreamBridge(cfg, key=3, map_fn=lambda x: (x >> 8).to(torch.float32) * 0.5,
                                    gated=gated, gate_tile=8, device=device)
        for off in range(0, n, B):
            bridge.push_interleaved(ids, data[:, off:off + B].T.ravel())
        out = bridge.complete()
        return bridge.metrics.snapshot(), out

    before = (TK.launches, TK.gated_launches)
    metrics, got = run(cuda_device)
    launched = (TK.launches - before[0], TK.gated_launches - before[1])
    assert launched[0] >= 1 and (launched[1] >= 1 if gated else launched[1] == 0)
    assert metrics["gated_dispatches"] == launched[1]
    _, want = run("cpu")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "wide", "weighted", "distinct", "distinct_int64", "hooked"])
def test_fused_stream_equals_the_per_tile_path_on_the_card(cuda_device, mode):
    """``sample_stream(fused=True)`` against the per-tile path, bit for bit,
    with one launch a tile."""
    R, k, B, n = 1024, 16, 256, 5
    kw = {"uniform": {}, "wide": dict(count_dtype="wide"), "weighted": dict(weighted=True),
          "distinct": dict(distinct=True), "distinct_int64": dict(distinct=True, element_dtype="int64"),
          "hooked": dict(distinct=True)}[mode]
    hooks = dict(map_fn=lambda x: x & 0xFFFF, hash_fn=lambda v: (v >> 3, v * 31)) if mode == "hooked" else {}
    cfg = SamplerConfig(k, R, B, **kw)
    rng = np.random.default_rng(19)
    stream = rng.integers(0, 1 << 18, (R, n * B + 17)).astype(kw.get("element_dtype", "int32"))
    w = rng.uniform(0.0, 2.0, stream.shape).astype(np.float32) if kw.get("weighted") else None
    engines = [ReservoirEngine(cfg, key=2, reusable=True, device=cuda_device, **hooks) for _ in range(2)]
    counts = lambda: TK.launches + TK.wide_launches + TWK.launches + sum(_dlaunches())  # noqa: E731
    before = counts()
    engines[0].sample_stream(stream, weights=w, fused=True)
    torch.cuda.synchronize()
    assert counts() - before == n + 1  # n fused tiles and the ragged tail
    engines[1].sample_stream(stream, weights=w)
    for a, b in zip(engines[0].state, engines[1].state):
        assert (a is None and b is None) or torch.equal(a.view(torch.int32) if a.dtype == torch.uint32 else a,
                                                         b.view(torch.int32) if b.dtype == torch.uint32 else b)


# ------------------------------------------------------ the sharded engine (L4)

_MESH_MODES = {
    "uniform": ({}, None),
    "wide": (dict(count_dtype="wide"), None),
    "weighted": (dict(weighted=True), None),
    "distinct": (dict(distinct=True), None),
    "distinct_int64": (dict(distinct=True, element_dtype="int64"), None),
    "hooked": (dict(distinct=True), lambda x: x & 0x3FFF),
}


def _launch_counts():
    return {"algl": TK.launches, "wide": TK.wide_launches, "weighted": TWK.launches,
            "distinct": TDK.launches, "keepmax": TDK.keepmax_launches, "prehashed": TDK.prehashed_launches,
            "gather": TM.launches}


def _host_state(state):
    return {k: (None if v is None else v.view(np.uint8)) for k, v in convert.state_to_numpy(state).items()}


def _same_host_states(a, b):
    ha, hb = _host_state(a), _host_state(b)
    for name in ha:
        assert (ha[name] is None) == (hb[name] is None), name
        if ha[name] is not None:
            np.testing.assert_array_equal(ha[name], hb[name], err_msg=name)


def _mesh_run(cfg, engine_kw, map_fn, tiles, device_tiles=()):
    eng = ReservoirEngine(cfg, key=4, reusable=True, map_fn=map_fn, **engine_kw)
    for i, (tile, w, valid) in enumerate(tiles):
        if i in device_tiles:
            tile = torch.from_numpy(tile).to("cuda")
            w = None if w is None else torch.from_numpy(w).to("cuda")
        eng.sample(tile, valid, weights=w)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_MESH_MODES))
def test_meshed_card_engine_equals_the_unmeshed_card_engine_and_a_cpu_mesh(cuda_device, mode):
    """A meshed engine over 4 ranks of one card against the unmeshed card
    engine and a meshed engine on 4 CPU ranks, bit for bit, with exactly
    one launch of the mode's kernel a rank a tile."""
    from reservoir_tpu_torch.parallel import make_mesh

    kw, map_fn = _MESH_MODES[mode]
    R, k, B = 256, 9, 64
    rng = np.random.default_rng(31)
    dtype = kw.get("element_dtype", "int32")
    tiles = []
    for i in range(4):
        tile = rng.integers(0, 1 << 12 if kw.get("distinct") else 1 << 30, (R, B)).astype(dtype)
        w = rng.uniform(0.0, 2.0, (R, B)).astype(np.float32) if kw.get("weighted") else None
        valid = rng.integers(0, B + 1, R).astype(np.int32) if i == 2 else None
        tiles.append((tile, w, valid))
    meshed_cfg, plain_cfg = SamplerConfig(k, R, B, mesh_axis="res", **kw), SamplerConfig(k, R, B, **kw)
    before = _launch_counts()
    meshed = _mesh_run(meshed_cfg, dict(mesh=make_mesh(devices=[cuda_device] * 4)), map_fn, tiles,
                       device_tiles=(1, 3))
    torch.cuda.synchronize()
    got = {name: n - before[name] for name, n in _launch_counts().items()}
    if kw.get("distinct"):  # a ragged or mapped distinct tile takes keep-max
        want = {"keepmax": 4 * 4} if map_fn is not None else {"distinct": 3 * 4, "keepmax": 4}
    else:
        want = {"wide" if kw.get("count_dtype") else "weighted" if kw.get("weighted") else "algl": 4 * 4}
    assert got == {**{n: 0 for n in got}, **want}
    single = _mesh_run(plain_cfg, dict(device=cuda_device), map_fn, tiles, device_tiles=(1, 3))
    cpu_mesh = _mesh_run(meshed_cfg, dict(mesh=make_mesh(devices=["cpu"] * 4)), map_fn, tiles)
    _same_host_states(meshed.state, single.state)
    _same_host_states(meshed.state, cpu_mesh.state)
    rows = np.asarray([200, 3, 64, 3, 130], np.int32)
    for eng in (meshed, single):
        eng.reset_rows(rows, 8)
        eng.adopt_rows([1, 255, 70], eng.export_rows([128, 2, 191]))
        eng.sample(*tiles[0][:1], weights=tiles[0][1])
    _same_host_states(meshed.state, single.state)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_sharded_result_on_the_card_equals_the_plain_gather(cuda_device, wide):
    """``sharded_result`` over 4 ranks of the card: one all-gather launch,
    every rank's samples, sizes and total equal to ``gather_parts_plain``'s
    words and the host's sum."""
    from reservoir_tpu_torch.parallel import make_mesh, shard_state, sharded_result

    R, k = 512, 16
    state = T.init(key_from_seed(3), R, k, device=cuda_device, count_dtype="wide" if wide else "int32")
    rng = np.random.default_rng(37)
    if wide:
        counts = rng.integers(2**31, 2**40, R).astype(np.uint64)
        words = np.stack([counts & 0xFFFFFFFF, counts >> 32], 1).astype(np.uint32)
        state = state._replace(count=torch.from_numpy(words.view(np.int32)).to(cuda_device).view(torch.uint32))
    else:
        counts = rng.integers(2**28, 2**31 - 1, R).astype(np.int32)
        state = state._replace(count=torch.from_numpy(counts).to(cuda_device))
    state = state._replace(samples=torch.from_numpy(rng.integers(0, 1 << 30, (R, k)).astype(np.int32))
                           .to(cuda_device))
    mesh = make_mesh(devices=[cuda_device] * 4)
    shards = shard_state(state, mesh)
    before = TM.launches
    samples, sizes, totals = sharded_result(mesh)(shards)
    torch.cuda.synchronize()
    assert TM.launches - before == 1
    comm = TM.RingCommunicator(mesh.devices)
    leaves = [(*T.result(s), s.count) for s in shards]
    want = TM.gather_parts_plain(leaves, comm)
    for s, z, t, w in zip(samples, sizes, totals, want):
        assert torch.equal(_bits(s), _bits(w[0])) and torch.equal(z, w[1])
        if wide:
            np.testing.assert_allclose(float(t), float(counts.astype(np.float64).sum()), rtol=1e-6)
        else:
            total = int(counts.astype(np.int64).sum())
            assert int(t) == (total + 2**31) % 2**32 - 2**31


@pytest.mark.cuda
def test_meshed_bridge_on_the_card_recovers_as_a_cpu_mesh(cuda_device, tmp_path):
    """A meshed bridge over 4 ranks of the card, interleaved pushes, one
    launch a rank a flush; dropped after a checkpoint and recovered onto
    the mesh: the same samples as a meshed bridge on CPU ranks."""
    from reservoir_tpu_torch.parallel import make_mesh

    S, B, k = 64, 16, 4
    cfg = SamplerConfig(k, S, B, mesh_axis="res")
    rng = np.random.default_rng(41)
    ids = rng.integers(0, S, 4000).astype(np.int32)
    vals = rng.integers(0, 1 << 20, 4000).astype(np.int32)
    ref = DeviceStreamBridge(cfg, key=5, mesh=make_mesh(devices=["cpu"] * 4))
    ref.push_interleaved(ids, vals)
    want = ref.complete()
    before = TK.launches
    live = DeviceStreamBridge(cfg, key=5, mesh=make_mesh(devices=[cuda_device] * 4), gated=True,
                              checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert live.gate_inert_reason == "meshed engine (gated dispatch is single-device)"
    live.push_interleaved(ids[:2000], vals[:2000])
    live.drain_barrier()
    assert TK.launches - before == 4 * live.metrics.flushes
    seen = live.metrics.flushed_elements
    del live  # the drop: what was staged after the last flush is lost
    rec = DeviceStreamBridge.recover(str(tmp_path), mesh=make_mesh(devices=[cuda_device] * 4))
    assert rec.metrics.flushed_elements == seen
    # a flush takes everything staged before it: the flushed elements are
    # a prefix of the pushes, and the rest is pushed again
    rec.push_interleaved(ids[seen:], vals[seen:])
    for a, b in zip(rec.complete(), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "weighted", "distinct_int64"])
def test_meshed_engine_over_distinct_cards_equals_one_card(cuda_device, mode):
    """Ranks on every visible card (device tiles split across cards with
    peer copies, and ``sharded_result``'s cross-card gather) against the
    same ranks on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: the cross-card path")
    from reservoir_tpu_torch.parallel import make_mesh, sharded_result

    kw, _ = _MESH_MODES[mode]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    R, k, B = 64 * len(cards), 8, 64
    rng = np.random.default_rng(43)
    tiles = [(rng.integers(0, 1 << 12, (R, B)).astype(kw.get("element_dtype", "int32")),
              rng.uniform(0.0, 2.0, (R, B)).astype(np.float32) if kw.get("weighted") else None, None)
             for _ in range(3)]
    cfg = SamplerConfig(k, R, B, mesh_axis="res", **kw)
    spread = _mesh_run(cfg, dict(mesh=make_mesh(devices=cards)), None, tiles, device_tiles=(1,))
    one = _mesh_run(cfg, dict(mesh=make_mesh(devices=[cuda_device] * len(cards))), None, tiles)
    _same_host_states(spread.state, one.state)
    ops = TW if kw.get("weighted") else TD if kw.get("distinct") else T
    before = TM.launches
    got = sharded_result(spread.mesh, ops=ops)(spread._shards)
    assert TM.launches - before == len(cards)  # one launch a card
    want = sharded_result(one.mesh, ops=ops)(one._shards)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(_bits(g).cpu(), _bits(w).cpu())


# ---------------------------------------------- the selftest on the card


_KS_KEYS = ("ks_ok", "ks_distinct_ok", "ks_weighted_ok")


@pytest.mark.cuda
def test_device_selftest_passes_on_the_card(cuda_device):
    """Every kernel against its plain version at the engine's launch shape,
    the composite checks and the KS gates: every key true, every kernel
    launched."""
    from reservoir_tpu_torch.utils.selftest import KERNEL_CHECKS, KERNELS, device_selftest

    out = device_selftest()
    for name in KERNEL_CHECKS + ("kernel_parity", "gated_parity", "merge_parity") + _KS_KEYS:
        assert out[name] is True, (name, out.get(f"{name}_error"))
    assert out["platform"] == "gpu" and out["device_name"] == torch.cuda.get_device_name(0)
    assert all(out["launches"][name] > 0 for name in KERNELS), out["launches"]


@pytest.mark.cuda
def test_device_selftest_in_its_child_passes_on_the_card(cuda_device):
    from reservoir_tpu_torch.utils.selftest import KERNEL_CHECKS, device_selftest_subprocess

    out = device_selftest_subprocess(timeout_s=600.0)
    assert "partial" not in out and "error" not in out, out
    for name in KERNEL_CHECKS + ("kernel_parity", "gated_parity", "merge_parity") + _KS_KEYS:
        assert out[name] is True, (name, out.get(f"{name}_error"))


@pytest.mark.cuda
def test_a_flipped_bit_on_card_tensors_fails_the_selftest(cuda_device, monkeypatch):
    from reservoir_tpu_torch.utils import selftest

    seen = []

    def flipped(state, batch, valid=None, map_fn=None):
        out = real(state, batch, valid, map_fn)
        seen.append(out.samples.device.type)
        out.samples.view(torch.int32).view(-1)[5] ^= 1 << 7
        return out

    real = TK.update_steady_cuda
    monkeypatch.setattr(TK, "update_steady_cuda", flipped)
    for name in ("check_gated", "check_merge"):
        monkeypatch.setattr(selftest, name, lambda dev, on_card: True)
    for name in ("check_ks", "check_ks_distinct", "check_ks_weighted"):
        monkeypatch.setattr(selftest, name, lambda dev: (0.001, True))
    out = selftest.device_selftest()
    assert seen and set(seen) == {"cuda"}
    assert out["algl"] is False and out["algl_wide"] is False and out["kernel_parity"] is False
    assert out["weighted"] is True and out["merge_ring"] is True


# ------------------------------------ the mesh over two processes, on the card

_TWO_PROCESS_MESH = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from reservoir_tpu_torch import ReservoirEngine, SamplerConfig, convert
from reservoir_tpu_torch.ops import algorithm_l_cuda as TK
from reservoir_tpu_torch.ops import merge_cuda as TM
from reservoir_tpu_torch.parallel import make_mesh, multihost, sharded_result
pid, port, out_dir, backend = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
card = torch.device("cuda", pid if backend == "nccl" else 0)
torch.cuda.set_device(card)
assert multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, backend=backend, timeout=120)
mesh = make_mesh(devices=[card] * 2)
assert mesh.shape == {"res": 4} and mesh.local_ranks == (2 * pid, 2 * pid + 1)
save = {}
for mode, kw in (("uniform", {}), ("wide", {"count_dtype": "wide"}), ("weighted", {"weighted": True}),
                 ("distinct_int64", {"distinct": True, "element_dtype": "int64"})):
    cfg = SamplerConfig(16, 256, 64, mesh_axis="res", **kw)
    eng = ReservoirEngine(cfg, key=4, reusable=True, mesh=mesh)
    rng = np.random.default_rng(51)
    launches = dict(TK=TK.launches + TK.wide_launches, TM=TM.launches)
    for i in range(3):
        tile = rng.integers(0, 1 << 30, (256, 64)).astype(kw.get("element_dtype", "int32"))
        w = rng.uniform(0.0, 2.0, (256, 64)).astype(np.float32) if kw.get("weighted") else None
        if i == 1:  # a tile on the card: each process splits its own rows
            tile = torch.from_numpy(tile).to(card)
        eng.sample(tile, weights=w)
    torch.cuda.synchronize()
    if not kw.get("weighted") and not kw.get("distinct"):
        assert TK.launches + TK.wide_launches - launches["TK"] == 3 * 2  # one launch a local rank a tile
    samples, sizes = eng.peek_arrays()
    save[mode + "/samples"], save[mode + "/sizes"] = samples, sizes
    for name, v in convert.state_to_numpy(eng.state).items():
        if v is not None:
            save[f"{mode}/state/{name}"] = v
    before = TM.launches
    got = sharded_result(mesh, ops=eng._ops)(eng._shards)
    torch.cuda.synchronize()
    assert TM.launches - before == 1  # the local ranks' gather, one launch on the card
    assert all(t.device == card for t in got[0])
    save[mode + "/gathered"] = got[0][0].view(torch.int32).cpu().numpy()
np.savez(os.path.join(out_dir, f"proc{pid}.npz"), **save)
dist.destroy_process_group()
print("OK", pid)
"""


def _two_processes(tmp_path, backend):
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCESS_MESH, str(i), str(port), str(tmp_path), backend],
                              env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            proc.kill()
    for i, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"process {i}: {err[-3000:]}"
        assert f"OK {i}" in out
    got = []
    for i in range(2):
        with np.load(tmp_path / f"proc{i}.npz") as f:
            got.append({name: f[name] for name in f.files})
    return got


def _check_two_process_mesh(got, device):
    for mode, kw in (("uniform", {}), ("wide", {"count_dtype": "wide"}), ("weighted", {"weighted": True}),
                     ("distinct_int64", {"distinct": True, "element_dtype": "int64"})):
        eng = ReservoirEngine(SamplerConfig(16, 256, 64, **kw), key=4, reusable=True, device=device)
        rng = np.random.default_rng(51)
        for _ in range(3):
            tile = rng.integers(0, 1 << 30, (256, 64)).astype(kw.get("element_dtype", "int32"))
            w = rng.uniform(0.0, 2.0, (256, 64)).astype(np.float32) if kw.get("weighted") else None
            eng.sample(tile, weights=w)
        samples, sizes = eng.peek_arrays()
        state = {k: v for k, v in convert.state_to_numpy(eng.state).items() if v is not None}
        gathered = eng._ops.result(eng.state)[0].view(torch.int32).cpu().numpy()
        for pid, g in enumerate(got):
            np.testing.assert_array_equal(g[f"{mode}/samples"], samples, err_msg=f"{mode}, process {pid}")
            np.testing.assert_array_equal(g[f"{mode}/sizes"], sizes)
            np.testing.assert_array_equal(g[f"{mode}/gathered"], gathered)
            for name, v in state.items():
                np.testing.assert_array_equal(g[f"{mode}/state/{name}"].view(np.uint8), v.view(np.uint8),
                                              err_msg=f"{mode} {name}, process {pid}")


@pytest.mark.cuda
def test_two_gloo_processes_on_one_card_equal_the_unmeshed_card_engine(cuda_device, tmp_path):
    """Two processes joined over gloo, two ranks of the one card each: the
    rows each reads back (``peek_arrays``, ``state``, ``sharded_result``)
    equal the unmeshed card engine's, in every mode; gloo moves the card
    tensors across the processes."""
    _check_two_process_mesh(_two_processes(tmp_path, "gloo"), cuda_device)


@pytest.mark.cuda
def test_two_nccl_processes_one_card_each_equal_one_card(cuda_device, tmp_path):
    """The NCCL path: two processes, each on its own card (NCCL refuses two
    ranks on one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card a process: two processes need two cards")
    _check_two_process_mesh(_two_processes(tmp_path, "nccl"), cuda_device)


def _same_state(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def _copy(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 100, 2048])
@pytest.mark.parametrize("case", ["fill", "steady", "wide", "gated", "weighted", "weighted past 4 warps",
                                  "distinct", "distinct int64", "prehashed", "keepmax", "distinct one warp on chip",
                                  "distinct beyond shared memory"])
def test_every_launch_geometry_gives_the_default_bits(cuda_device, case, R):
    """Every rows-a-block each tile kernel was built for, at R = 1, at an R
    that is no multiple of any block, and at the serving plane's R = 2,048,
    with an odd k, and with a k where the launcher keeps fewer rows on chip
    than asked for or none (weighted: 8 warps' keys leave the chip where
    4 warps' stay; distinct: one warp's block fits, or none): the state
    equals the default launch's bit for bit, and each launch is counted."""
    from reservoir_tpu_torch.ops import blocking

    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(R)
    B, k = 256, 13

    def ints(rows, width, dtype=torch.int32):
        t = torch.randint(-(2**31), 2**31 - 1, (rows, width), dtype=torch.int32, device=dev, generator=gen)
        return t if dtype == torch.int32 else (t.to(torch.int64) * 0x9E3779B97F4A7C15 + 7)

    if case in ("fill", "steady", "wide", "gated"):
        wide = case == "wide"
        state = T.init(key_from_seed(3), R, k, device=dev, count_dtype="wide" if wide else "int32")
        if case != "fill":
            state = TK.update_cuda(state, ints(R, B))
        kernel = "algl_gated" if case == "gated" else "algl"
        if case == "gated":
            tile = ints(R, 16)
            nvalid = torch.randint(0, 17, (R,), dtype=torch.int32, device=dev, generator=gen)
            advance = nvalid + torch.randint(0, 500, (R,), dtype=torch.int32, device=dev, generator=gen)

            def run(st, b):
                return TK.update_gated_cuda(st, tile, nvalid, advance, block_r=b)
        else:
            tile = ints(R, B)
            fn = TK.update_cuda if case in ("fill", "wide") else TK.update_steady_cuda

            def run(st, b):
                return fn(st, tile, block_r=b)
        counter = "gated_launches" if case == "gated" else ("wide_launches" if wide else "launches")
        module = TK
    elif case.startswith("weighted"):
        if case == "weighted past 4 warps":
            k = 5001
        state = TW.init(key_from_seed(3), R, k, device=dev)
        state = TWK.update_cuda(state, ints(R, B), torch.rand((R, B), device=dev, generator=gen))
        tile, weights = ints(R, B), torch.rand((R, B), device=dev, generator=gen)
        kernel, module, counter = "weighted", TWK, "launches"

        def run(st, b):
            return TWK.update_cuda(st, tile, weights, block_r=b)
    else:
        dtype = torch.int64 if case == "distinct int64" else torch.int32
        if case == "distinct one warp on chip":
            k = 10001
        elif case == "distinct beyond shared memory":
            k = 19371
        state = TD.init(key_from_seed(3), R, k, sample_dtype=dtype, device=dev)
        state = TDK.update_cuda(state, ints(R, B, dtype) % 5000)
        tile = ints(R, B, dtype) % 5000
        hooks = {"hash_fn": lambda v: (v >> 3, v * 31)} if case == "prehashed" else {}
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=dev, generator=gen)
                 if case == "keepmax" else None)
        kernel, module = "distinct", TDK
        counter = "prehashed_launches" if hooks else "keepmax_launches" if case == "keepmax" else "launches"

        def run(st, b):
            return TDK.update_cuda(st, tile, valid, block_r=b, **hooks)
    torch.cuda.synchronize()
    want = run(_copy(state), None)
    choices = blocking.BLOCK_CHOICES[kernel]
    before = getattr(module, counter)
    for b in choices:
        got = run(_copy(state), b)
        torch.cuda.synchronize()
        assert _same_state(got, want), (case, R, k, b)
    assert getattr(module, counter) - before == len(choices)
