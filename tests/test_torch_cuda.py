"""The port's CUDA kernels on the card, held against the plain torch versions.

Every test here needs a CUDA card and skips without one.  This file imports
no jax, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reservoir_tpu_torch import DeviceSampler, DeviceStreamBridge, ReservoirEngine, SamplerConfig
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

    before = TDK.launches
    for i in range(4):
        tile = tile_of(i)
        valid = (torch.randint(0, tile.shape[1] + 1, (R,), dtype=torch.int32, device=cuda_device,
                               generator=gen) if i == 2 else None)
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, _as_batch(tile, layout), valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert TDK.launches - before == 4
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
    before = TDK.launches
    for i, kind in enumerate(("random", "random", "zipf", "random")):
        tile = _card_keys(gen, R, B, cuda_device, dtype, kind)
        valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=cuda_device, generator=gen)
                 if i == 3 else None)
        ref = TD.update(_dclone(s), tile, valid)
        s = TDK.update_cuda(s, tile, valid)
        for f in _DFIELDS:
            a, b = getattr(s, f), getattr(ref, f)
            assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32)), (f, i)
    assert TDK.launches - before == 4
    assert int(s.size.min()) == k


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
