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
from reservoir_tpu_torch.ops import fmath
from reservoir_tpu_torch.ops import weighted as TW
from reservoir_tpu_torch.ops import weighted_cuda as TWK
from reservoir_tpu_torch.ops.rng import key_from_seed

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
