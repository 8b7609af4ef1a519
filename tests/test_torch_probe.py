"""The port's liveness probe (``reservoir_tpu_torch/utils/probe.py``): a
throwaway child with a hard timeout, which returns the platform, or
``None`` for a child that hangs, exits non-zero or finds no card."""

from __future__ import annotations

import time

import pytest
import torch

from reservoir_tpu_torch.utils import probe


def test_a_cpu_pinned_probe_returns_cpu():
    assert probe.probe_backend_proc(60.0, device="cpu") == "cpu"


def test_the_card_probe_names_the_gpu_or_finds_none():
    assert probe.probe_backend_proc(60.0) == ("gpu" if torch.cuda.is_available() else None)


@pytest.mark.parametrize("snippet", ["import time; time.sleep(60)", "import sys; sys.exit(3)",
                                     "import sys; sys.stdout.write('')"],
                         ids=["hangs", "exits_non_zero", "says_nothing"])
def test_a_child_that_fails_gives_none_within_the_timeout(monkeypatch, snippet):
    monkeypatch.setattr(probe, "PROBE_SNIPPET", snippet)
    t0 = time.perf_counter()
    assert probe.probe_backend_proc(3.0) is None
    assert time.perf_counter() - t0 < 20


def test_the_probe_snippet_puts_a_tensor_on_the_card():
    for word in ("torch.cuda.is_available()", "device='cuda'", "synchronize()", "get_device_name(0)"):
        assert word in probe.PROBE_SNIPPET


def test_an_unknown_device_raises():
    with pytest.raises(ValueError, match="device must be"):
        probe.probe_backend_proc(1.0, device="tpu")
