"""The port's parity selftest (``reservoir_tpu_torch/utils/selftest.py``) on
the CPU, where the kernel wrappers run the plain versions: every check
reports ``True`` at the interpret shapes; a wrapper that flips a bit, or
raises, makes its check and ``kernel_parity`` false (with ``<name>_error``);
without a card nothing runs and ``kernel_parity`` is false; the child
process keeps the last stage it printed on a timeout or a crash and gives an
error when it printed none.  The four checks the reference also has
(``algl``, ``algl_fill``, ``distinct``, ``weighted``) draw the JAX
selftest's inputs, and their plain side equals its XLA side bit for bit.
Every child has a timeout."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu.ops import distinct as JD
from reservoir_tpu.ops import weighted as JW
from reservoir_tpu_torch import convert
from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
from reservoir_tpu_torch.ops import merge_cuda as mkern
from reservoir_tpu_torch.ops import weighted_cuda as wkern
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.utils import probe, selftest

CPU = torch.device("cpu")
#: the reference's interpret shapes
R, B = 8, 64
KS_KEYS = ("ks_ok", "ks_distinct_ok", "ks_weighted_ok")


@pytest.fixture(scope="module")
def run():
    """One whole selftest on the CPU, with the stages it emitted."""
    stages = []
    out = selftest.device_selftest(emit_partial=stages.append, device="cpu")
    return out, stages


def test_every_check_passes_on_the_cpu(run):
    out, _ = run
    for name in selftest.KERNEL_CHECKS + ("kernel_parity", "gated_parity", "merge_parity") + KS_KEYS:
        assert out[name] is True, (name, out.get(f"{name}_error"))
    assert not [k for k in out if k.endswith("_error")]
    assert out["platform"] == "cpu" and out["seconds"] > 0
    for name in ("ks_uniform", "ks_distinct", "ks_weighted"):
        assert 0 < out[name] < 0.01
    # on CPU tensors the wrappers launch nothing
    assert out["launches"] == {name: 0 for name in selftest.KERNELS}
    assert "pallas_parity" not in out


def test_a_copy_of_the_dict_is_emitted_after_each_stage(run):
    out, stages = run
    assert len(stages) == 6  # the kernel checks, the two composites, the three KS gates
    assert stages[0]["kernel_parity"] is True and "gated_parity" not in stages[0]
    assert "ks_ok" in stages[3] and "ks_distinct_ok" not in stages[3]
    assert stages[-1] == {k: v for k, v in out.items()}
    json.dumps(stages)


def test_without_a_card_nothing_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = selftest.device_selftest()
    assert out["kernel_parity"] is False
    assert "no CUDA device" in out["error"]
    assert not set(selftest.KERNEL_CHECKS) & set(out)


def _fast_composites(monkeypatch, *checks):
    """The composite checks as stubs, and only ``checks`` of the kernel
    checks (with ``distinct``, which no patch here touches): the whole run
    is ``test_every_check_passes_on_the_cpu``'s."""
    kept = {name: selftest._KERNEL_CHECKS[name] for name in checks + ("distinct",)}
    monkeypatch.setattr(selftest, "_KERNEL_CHECKS", kept)
    for name in ("check_gated", "check_merge"):
        monkeypatch.setattr(selftest, name, lambda dev, on_card: True)
    for name in ("check_ks", "check_ks_distinct", "check_ks_weighted"):
        monkeypatch.setattr(selftest, name, lambda dev: (0.001, True))


def _flipped(fn):
    """``fn`` whose result has one bit of its first leaf flipped."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0]
        if isinstance(first, tuple):  # gather_parts: a tuple of leaves a rank
            first = first[0]
        words = first.view(torch.int32).view(-1)
        words[0] ^= 1
        return out

    return call


@pytest.mark.parametrize("name, module, attr", [
    ("weighted", wkern, "update_cuda"),
    ("algl_gated", kern, "update_gated_cuda"),
    ("merge_ring", mkern, "gather_parts"),
    ("merge_draws", kern, "merge_draws_cuda"),
])
def test_a_flipped_bit_fails_its_check_and_kernel_parity(monkeypatch, name, module, attr):
    _fast_composites(monkeypatch, name)
    monkeypatch.setattr(module, attr, _flipped(getattr(module, attr)))
    out = selftest.device_selftest(device="cpu")
    assert out[name] is False and out["kernel_parity"] is False
    assert out["distinct"] is True
    assert f"{name}_error" not in out


def test_a_wrapper_that_raises_is_recorded_under_its_check(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("launch failed: CUDA error 700")

    _fast_composites(monkeypatch, "algl", "algl_fill", "algl_wide")
    monkeypatch.setattr(kern, "update_cuda", boom)
    out = selftest.device_selftest(device="cpu")
    assert out["kernel_parity"] is False
    for name in ("algl_fill", "algl_wide"):  # the checks that launch update_cuda
        assert out[name] is False
        assert out[f"{name}_error"] == "RuntimeError: launch failed: CUDA error 700"
    assert out["algl"] is True and out["distinct"] is True


def test_a_composite_check_that_raises_is_recorded(monkeypatch):
    _fast_composites(monkeypatch)

    def boom(dev):
        raise ValueError("a reservoir holds 3 samples, not 32")

    monkeypatch.setattr(selftest, "check_ks_distinct", boom)
    out = selftest.device_selftest(device="cpu")
    assert out["ks_distinct_ok"] is False and "ks_distinct" not in out
    assert out["ks_distinct_error"] == "ValueError: a reservoir holds 3 samples, not 32"
    assert out["ks_ok"] is True and out["ks_weighted_ok"] is True


# ------------------------------------------------------------ the child


@pytest.mark.parametrize("body, want", [
    ("_p({'kernel_parity': True, 'algl': True}); time.sleep(60)", "timed out"),
    ("_p({'kernel_parity': True, 'algl': True}); sys.stderr.write('segfault'); os._exit(7)", "rc 7"),
    ("sys.stderr.write('no card'); sys.exit(3)", None),
], ids=["hangs_after_a_stage", "crashes_after_a_stage", "prints_nothing"])
def test_the_child_keeps_its_last_stage(monkeypatch, body, want):
    code = ("import json, os, sys, time\n"
            "def _p(d):\n"
            "    sys.stdout.write(json.dumps(d) + '\\n'); sys.stdout.flush()\n" + body + "\n")
    monkeypatch.setattr(selftest, "_child_code", lambda device: code)
    out = selftest.device_selftest_subprocess(timeout_s=5.0, skip_probe=True, device="cpu")
    if want is None:
        assert out["kernel_parity"] is False and "rc 3" in out["error"] and "no card" in out["error"]
        assert "partial" not in out
    else:
        assert out["kernel_parity"] is True and out["algl"] is True
        assert want in out["partial"]
        if want == "rc 7":
            assert "segfault" in out["partial"]


def test_the_child_probes_first_and_reads_its_last_line(monkeypatch):
    monkeypatch.setattr(selftest, "_child_code", lambda device: (
        "import json\nprint(json.dumps({'stage': 1}))\nprint(json.dumps({'kernel_parity': True, "
        f"'device': {device!r}}}))\n"))
    assert selftest.device_selftest_subprocess(timeout_s=60.0, device="cpu") == {"kernel_parity": True,
                                                                                 "device": "cpu"}
    monkeypatch.setattr(probe, "probe_backend_proc", lambda timeout_s, device=None: None)
    out = selftest.device_selftest_subprocess(timeout_s=60.0, device="cpu")
    assert out["kernel_parity"] is False and "unreachable" in out["error"]


def test_the_child_imports_only_the_port():
    code = selftest._child_code(None)
    assert "reservoir_tpu_torch.utils.selftest" in code
    assert "jax" not in code.replace("reservoir_tpu_torch", "") and "reservoir_tpu." not in code


# ------------------------------------------- the reference's inputs, bit for bit


def _jax_host(state) -> dict:
    out = {}
    for name, value in zip(type(state)._fields, state):
        if value is not None and jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        if value is not None:
            out[name] = np.asarray(value)
    return out


def _same_state(jstate, tstate) -> None:
    got = {k: v for k, v in convert.state_to_numpy(tstate).items() if v is not None}
    want = _jax_host(jstate)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].view(np.uint8), w.view(np.uint8), err_msg=name)


def _iota(width, start=0):
    return start + jax.lax.broadcasted_iota(jnp.int32, (R, width), 1)


@pytest.mark.parametrize("seed, shape", [(0, (8, 64)), (4, (3, 5)), (2**31 + 5, (1000,))])
def test_jax_random_draws_on_the_ports_threefry(seed, shape):
    key = key_from_seed(seed & 0xFFFFFFFF)
    jkey = jr.key(seed & 0xFFFFFFFF)
    np.testing.assert_array_equal(selftest.jax_bits(key, shape).numpy().astype(np.uint32),
                                  np.asarray(jr.bits(jkey, shape, jnp.uint32)))
    np.testing.assert_array_equal(selftest.jax_uniform(key, shape).numpy().view(np.uint32),
                                  np.asarray(jr.uniform(jkey, shape)).view(np.uint32))
    for lo, hi in ((0, 500), (1, 5), (-7, 2**20 + 3)):
        np.testing.assert_array_equal(selftest.jax_randint(key, shape, lo, hi).numpy(),
                                      np.asarray(jr.randint(jkey, shape, lo, hi, jnp.int32)))
    np.testing.assert_array_equal(selftest._fold_in(key, 2).numpy().astype(np.uint32),
                                  np.asarray(jr.key_data(jr.fold_in(jkey, 2))))


def test_the_algl_check_takes_the_references_inputs_and_xla_side():
    k = 16
    state = JA.update(JA.init(jr.key(0), R, k), _iota(max(B, k)))
    batch = 10_000 + _iota(B)
    tstate, tbatch = selftest.algl_inputs(CPU, False)
    _same_state(state, tstate)
    np.testing.assert_array_equal(tbatch.numpy(), np.asarray(batch))
    (ref, got), = selftest.check_algl(CPU, False)
    _same_state(JA.update_steady(state, batch), ref)
    _same_state(JA.update_steady(state, batch), got)


def test_the_algl_fill_check_takes_the_references_inputs_and_xla_side():
    ref = JA.init(jr.key(8), R, 96)
    tstate, tiles = selftest.algl_fill_inputs(CPU, False)
    _same_state(ref, tstate)
    pairs = selftest.check_algl_fill(CPU, False)
    assert len(pairs) == len(tiles) == 2
    for t, (tile, (tref, _)) in enumerate(zip(tiles, pairs)):
        batch = 1 + t * B + _iota(B)
        np.testing.assert_array_equal(tile.numpy(), np.asarray(batch))
        ref = JA.update(ref, batch)
        _same_state(ref, tref)


def test_the_distinct_check_takes_the_references_inputs_and_xla_side():
    s_ref = JD.init(jr.key(6), R, 8)
    tstate, tiles = selftest.distinct_inputs(CPU, False)
    _same_state(s_ref, tstate)
    pairs = selftest.check_distinct(CPU, False)[:3]  # the int32 steps; int64 follow
    for step, (tile, (tref, _)) in enumerate(zip(tiles, pairs)):
        batch = jr.randint(jr.fold_in(jr.key(7), step), (R, B), 0, 500, jnp.int32)
        np.testing.assert_array_equal(tile.numpy(), np.asarray(batch))
        s_ref = JD.update(s_ref, batch)
        _same_state(s_ref, tref)


def test_the_weighted_check_takes_the_references_inputs_and_xla_side():
    state = JW.init(jr.key(3), R, 8)
    elems = _iota(B)
    weights = jr.randint(jr.key(4), (R, B), 1, 5).astype(jnp.float32)
    weights = weights * (jr.uniform(jr.key(5), (R, B)) > 0.2)
    tstate, telems, tweights = selftest.weighted_inputs(CPU, False)
    _same_state(state, tstate)
    np.testing.assert_array_equal(telems.numpy(), np.asarray(elems))
    np.testing.assert_array_equal(tweights.numpy().view(np.uint32), np.asarray(weights).view(np.uint32))
    assert 0 < int((tweights == 0).sum()) < R * B // 2
    (ref, _), = selftest.check_weighted(CPU, False)
    _same_state(JW.update(state, elems, weights), ref)
