"""The port's host staging (``reservoir_tpu_torch.native``): its C++ demux
(built with g++ from ``_native/staging_buffer.cc``) and its numpy demux
against the JAX package's ``NativeStaging`` on the same feeds, tile for
tile and count for count; the parallel demux; and the build rules (a failed
build raises, no build leaves a temporary file)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from reservoir_tpu.native import NativeStaging as JStaging
from reservoir_tpu_torch import _build, native
from reservoir_tpu_torch.native import NativeStaging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(S, B, dtype, weighted, native_):
    """The JAX package's staging and the port's, each attached to its own
    zeroed tile (and weights)."""
    out = []
    for st in (JStaging(S, B, dtype, weighted=weighted),
               NativeStaging(S, B, dtype, weighted=weighted, native=native_)):
        tile = np.zeros((S, B), dtype)
        w = np.zeros((S, B), np.float32) if weighted else None
        st.attach(tile, w)
        out.append((st, tile, w))
    return out


@pytest.mark.parametrize("native_", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("dtype, weighted", [(np.int32, False), (np.int32, True), (np.int64, False)],
                         ids=["int32", "weighted", "int64"])
def test_interleaved_demux_equals_jax(dtype, weighted, native_):
    S, B, n = 7, 16, 3000
    rng = np.random.default_rng(0)
    # skewed streams: hot rows fill long before cold ones
    streams = np.minimum(rng.geometric(0.3, n) - 1, S - 1).astype(np.int32)
    elems = rng.integers(-(2**62), 2**62, n).astype(dtype)
    weights = rng.random(n).astype(np.float32) if weighted else None
    (js, jt, jw), (ts, tt, tw) = _pair(S, B, dtype, weighted, native_)
    assert ts.available() == native_
    done = 0
    flushes = 0
    while done < n:
        # uneven batch sizes, each resumed where the last one stopped
        stop = min(n, done + int(rng.integers(1, 400)))
        while done < stop:
            args = (streams[done:stop], elems[done:stop], None if weights is None else weights[done:stop])
            took = js.push_interleaved(*args)
            assert ts.push_interleaved(*args) == took
            done += took
            if done < stop:
                jv, tv = np.zeros(S, np.int32), np.zeros(S, np.int32)
                assert js.take(jv) == ts.take(tv) == int(jv.sum())
                np.testing.assert_array_equal(jv, tv)
                for s in range(S):
                    np.testing.assert_array_equal(jt[s, : jv[s]], tt[s, : tv[s]])
                    if weighted:
                        np.testing.assert_array_equal(jw[s, : jv[s]], tw[s, : tv[s]])
                flushes += 1
    assert flushes > 10


@pytest.mark.parametrize("native_", [True, False], ids=["native", "numpy"])
def test_push_chunk_and_fill_equal_jax(native_):
    (js, jt, _), (ts, tt, _) = _pair(4, 8, np.int32, False, native_)
    for st in (js, ts):
        assert st.push_chunk(1, np.arange(5, dtype=np.int32)) == 5
        assert st.push_chunk(1, np.arange(5, dtype=np.int32)) == 3  # the row fills at 8
        assert st.row_full(1) and not st.row_full(0) and st.fill(1) == 8
    jv, tv = np.zeros(4, np.int32), np.zeros(4, np.int32)
    assert js.take(jv) == ts.take(tv) == 8
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jt, tt)
    assert ts.fill(1) == 0


@pytest.mark.parametrize("native_", [True, False], ids=["native", "numpy"])
def test_bad_input_raises(native_):
    (ts, tile, _), = _pair(2, 4, np.int32, False, native_)[1:]
    with pytest.raises(ValueError, match="stream id 5 out of range .* at position 1"):
        ts.push_interleaved(np.array([0, 5], np.int32), np.array([1, 2], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        ts.push_chunk(2, np.array([1], np.int32))
    with pytest.raises(ValueError, match="weights required iff"):
        ts.push_chunk(0, np.array([1], np.int32), np.array([1.0], np.float32))
    with pytest.raises(ValueError, match="tile must be"):
        ts.attach(np.zeros((2, 5), np.int32))
    with pytest.raises(ValueError, match="C-contiguous"):
        ts.attach(np.zeros((4, 2), np.int32).T)
    with pytest.raises(ValueError, match="out_valid"):
        ts.take(np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="4-byte"):
        NativeStaging(2, 4, np.int64, weighted=True, native=native_)


def test_parallel_demux_equals_numpy_staging():
    """The range-parallel C++ demux (4 threads; the pool reads
    ``RESERVOIR_STAGING_THREADS`` once, so a fresh process) against the
    numpy staging over a batch far above the parallel threshold with many
    rows overflowing: the same consumed prefixes and rows at every flush."""
    child = r"""
import numpy as np
from reservoir_tpu_torch.native import NativeStaging

S, B, n = 500, 32, 200_000
rng = np.random.default_rng(1)
streams = rng.integers(0, S, n).astype(np.int32)
elems = rng.integers(0, 1 << 30, n).astype(np.int32)
w = rng.random(n).astype(np.float32)

def run(st, weighted):
    tile = np.zeros((S, B), np.int32)
    wt = np.zeros((S, B), np.float32) if weighted else None
    st.attach(tile, wt)
    valid = np.zeros(S, np.int32)
    consumed, tiles = 0, []
    while consumed < n:
        took = st.push_interleaved(streams[consumed:], elems[consumed:],
                                   w[consumed:] if weighted else None)
        st.take(valid)
        tiles.append((tile.copy(), None if wt is None else wt.copy(), valid.copy()))
        assert took > 0
        consumed += took
    return tiles

for weighted in (False, True):
    nat = NativeStaging(S, B, np.int32, weighted=weighted)
    assert nat.available() and nat.threads() == 4, nat.threads()
    ref = NativeStaging(S, B, np.int32, weighted=weighted, native=False)
    ta, tb = run(nat, weighted), run(ref, weighted)
    assert len(ta) == len(tb) > 5, (len(ta), len(tb))
    for (a, wa, va), (b, wb, vb) in zip(ta, tb):
        assert np.array_equal(va, vb)
        for s in range(S):
            assert np.array_equal(a[s, : va[s]], b[s, : vb[s]])
            if weighted:
                assert np.array_equal(wa[s, : va[s]], wb[s, : vb[s]])
print("PARALLEL_OK")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, RESERVOIR_STAGING_THREADS="4"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PARALLEL_OK" in proc.stdout


def test_a_failed_build_raises_and_leaves_no_temporary_file(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_OUT", str(tmp_path / "out"))
    # a source that does not compile: the staging raises, it never
    # falls back to numpy
    bad = tmp_path / "staging_buffer.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCE", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="compilation failed"):
        NativeStaging(2, 4, np.int32)
    monkeypatch.setattr(_build, "CXX", "no-such-c++-compiler")
    with pytest.raises(RuntimeError, match="not found on PATH"):
        _build.build_host(str(bad))
    # nvcc is resolved before any temporary file is made
    def no_nvcc():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_digest", lambda: "0" * 16)
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.build_all()
    # a compiler that fails, or cannot be started, leaves nothing behind
    with pytest.raises(RuntimeError, match="compilation failed"):
        _build._compile({"x": (["false"], str(bad), str(tmp_path / "out" / "libx.so"))})
    with pytest.raises(OSError):
        _build._compile({"x": ([str(tmp_path / "missing")], str(bad), str(tmp_path / "out" / "libx.so"))})
    assert os.listdir(tmp_path / "out") == []


def test_the_library_is_keyed_by_its_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_OUT", str(tmp_path))
    src = tmp_path / "a.cc"
    src.write_text('extern "C" int f() { return 1; }\n')
    first = _build.build_host(str(src))
    assert os.path.basename(first).startswith("liba-") and _build.build_host(str(src)) == first
    src.write_text('extern "C" int f() { return 2; }\n')
    second = _build.build_host(str(src))
    assert second != first and sorted(os.listdir(tmp_path)) == sorted(
        ["a.cc", os.path.basename(first), os.path.basename(second)])
