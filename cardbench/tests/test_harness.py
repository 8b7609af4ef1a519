"""The harness on the CPU: it finds every file by name, its statistics take
every sample and the whole window, its timeline reads the idle share, its
yardstick matches the values recorded on the card, and nothing it runs
loads JAX or the JAX package.

    python -m pytest cardbench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cardbench import bounds, harness
from cardbench.stats import percentile
from cardbench.timeline import from_events, short_name

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())


# ------------------------------------------------------------------ registry

@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.load_cell(BENCH, workload)
    assert harness.load_module("loops", cell.traffic["loop"]).run
    mode = harness.load_module("modes", cell.config["mode"])
    assert mode.engine and mode.CONTROL
    for m in cell.end_to_end:
        assert harness.load_module("e2e_metrics", m["name"]).value
    for m in cell.per_layer:
        assert harness.load_module("layer_metrics", m["name"]).value
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_a_cell_added_in_a_copy_is_found_without_an_edit(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.HERE, copy / "cardbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (copy / "cardbench" / "traffic" / "device_ingest.b512.pool2.json").write_text(json.dumps(
        {"loop": "device_ingest", "tile_width": 512, "pool_tiles": 2, "in_flight": 1, "snapshot_every": 8,
         "warmup_tiles": 4}))
    (copy / "cardbench" / "layer_metrics" / "tiles.count.py").write_text(
        "def value(run):\n    return run.record.get('tiles')\n")
    bench["workloads"].append({"name": "weighted.small", "config": "weighted-16384x64",
                               "traffic": "device_ingest.b512.pool2", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiles.count", "unit": "tiles", "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "elems_per_s", "workloads": ["weighted.small"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from cardbench import harness; "
            "cell = harness.load_cell(json.load(open('BENCHMARK.json')), 'weighted.small'); "
            "print(json.dumps([cell.traffic['tile_width'], [m['name'] for m in cell.per_layer], "
            "harness.load_module('layer_metrics', 'tiles.count').value("
            "type('R', (), {'record': {'tiles': 7}})()), str(harness.HERE)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    width, layer, tiles, here = json.loads(out.stdout)
    assert width == 512 and layer == ["tiles.count"] and tiles == 7
    assert Path(here) == copy / "cardbench"


def test_an_unknown_name_raises():
    with pytest.raises(KeyError):
        harness.load_cell(BENCH, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("layer_metrics", "no.such.metric")


# ---------------------------------------------------------------- statistics

def test_the_p95_is_taken_over_every_sample():
    values = [1.0] * 94 + [100.0] * 6
    assert percentile(values, 95) == 100.0
    assert percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile([], 95) is None
    run = SimpleNamespace(record={"snapshot_ms": values, "merge_ms": values})
    assert harness.load_module("e2e_metrics", "merge_p95_ms").value(run) == 100.0
    assert harness.load_module("layer_metrics", "snapshot_p95_ms").value(run) == 100.0


def test_each_rate_is_taken_over_the_whole_window():
    run = SimpleNamespace(record={"elements": 3_000_000, "rounds": 250, "window_s": 2.5, "setup_s": 4.0})
    assert harness.load_module("e2e_metrics", "elems_per_s").value(run) == 1_200_000
    assert harness.load_module("e2e_metrics", "rounds_per_s").value(run) == 100
    assert harness.load_module("e2e_metrics", "setup_s").value(run) == 4.0


# ------------------------------------------------------------------ timeline

def _events():
    """A synthetic window of 100 us: two sample spans, each launching one
    kernel, a snapshot span with a device-to-host copy, a gap."""
    ann = lambda name, ts, dur: {"cat": "user_annotation", "name": "cardbench." + name, "ts": ts, "dur": dur}  # noqa: E731
    rt = lambda corr, ts: {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,  # noqa: E731
                           "args": {"correlation": corr}}
    dev = lambda cat, name, corr, ts, dur: {"cat": cat, "name": name, "ts": ts, "dur": dur,  # noqa: E731
                                            "args": {"correlation": corr}}
    return [
        ann("window", 1000, 100),
        ann("sample", 1000, 5), rt(1, 1002), dev("kernel", "void wtd::update_kernel<true, 4>(float*, int)", 1, 1003, 30),
        ann("sample", 1010, 5), rt(2, 1012), dev("kernel", "void wtd::update_kernel<true, 4>(float*, int)", 2, 1033, 30),
        ann("snapshot", 1070, 20), rt(3, 1071), dev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 3, 1075, 4),
        dev("kernel", "void other(int)", 99, 900, 50),  # before the window, no launch seen
    ]


def test_the_idle_share_comes_from_the_timeline():
    tl = from_events(_events())
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy() == [(1003.0, 1063.0), (1075.0, 1079.0)]
    assert tl.busy_s() == pytest.approx(64e-6)
    run = SimpleNamespace(timeline=tl)
    assert harness.load_module("layer_metrics", "device.idle_pct.ingest").value(run) == pytest.approx(36.0)
    assert harness.load_module("layer_metrics", "device.idle_pct.merge").value(run) == pytest.approx(36.0)
    gaps = tl.idle_gaps()
    # 1079-1100, its middle inside the snapshot span; 1063-1075 between spans
    assert gaps[0] == ("snapshot", pytest.approx(21e-6))
    assert sorted(g[0] for g in gaps) == ["loop", "sample", "snapshot"]


def test_device_ops_are_tied_to_the_span_that_launched_them():
    tl = from_events(_events())
    ks = tl.kernels("wtd::update_kernel")
    assert [op.span for op in ks] == ["sample", "sample"]
    assert ks[0].name == "wtd::update_kernel<true, 4>"
    run = SimpleNamespace(timeline=tl)
    assert harness.load_module("layer_metrics", "snapshot.copy_ms").value(run) == pytest.approx(0.004)
    assert harness.load_module("layer_metrics", "engine.sample_host_us").value(run) == pytest.approx(5.0)
    assert tl.by_name()[0] == ("wtd::update_kernel<true, 4>", pytest.approx(60e-6))


def test_short_names_drop_void_and_the_arguments():
    assert short_name("void at::native::(anonymous namespace)::k<(a)1>(int, float)") == \
        "at::native::(anonymous namespace)::k<(a)1>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"
    assert short_name("plain") == "plain"


def test_a_roofline_share_reads_nothing_without_its_kernel():
    tl = from_events(_events())
    run = SimpleNamespace(timeline=tl, work={"launches": 2, "lanes": 1, "rows": 1, "k": 1, "inserts": 0,
                                              "rows_inserting": 0})
    assert harness.load_module("layer_metrics", "distinct_update.roofline_pct").value(run) is None
    assert harness.load_module("layer_metrics", "merge.tree_ms").value(run) is None


# -------------------------------------------------------------------- bounds

def test_the_frozen_bounds_match_the_values_recorded_on_the_card():
    # PERF.md section 6: the weighted kernel's zero-weight scan at [16384, 1024]
    ms, by = bounds.weighted_bound_ms(0, 0, 16384 * 1024, 16384, 64)
    assert (round(ms, 4), by) == (0.0214, "bytes")
    # the 4-rank gather at [65536, 128] samples and a count (0.2019, bytes)
    # and sharded_result's 8-rank gather of 1,064,960 words (0.0916, bytes)
    assert round(bounds.gather_bound_ms(4, 65536 * 129)[0], 4) == 0.2019
    assert round(bounds.gather_bound_ms(8, 1_064_960)[0], 4) == 0.0916
    # the distinct kernel's lanes alone at [4096, 1024]: 68 ops a lane
    ms, by = bounds.distinct_bound_ms(4096 * 1024, 0, 0, 4096, 256)
    assert by == "operations" and ms == pytest.approx(1e3 * 68 * 4096 * 1024 / (64 * 132 * 1.98e9))


def test_work_is_counted_from_two_states():
    before = np.array([[-np.inf, -1.0, -2.0], [-3.0, -4.0, -5.0]], np.float32)
    after = np.array([[-0.5, -1.0, -1.5], [-3.0, -4.0, -5.0]], np.float32)
    assert bounds.weighted_work(before, after) == (1, 1)
    hi = np.array([[1, 2, -1], [5, 6, 7]], np.int32)
    lo = np.zeros((2, 3), np.int32)
    new_hi = np.array([[1, 3, 2], [5, 6, 7]], np.int32)
    assert bounds.net_inserts((hi, lo, np.array([2, 3])), (new_hi, lo, np.array([3, 3]))) == (1, 1)


# ------------------------------------------------------------------- imports

def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("reservoir_tpu_torch", "reservoir_tpu_torch.engine", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, SimpleNamespace())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "reservoir_tpu.ops", SimpleNamespace())
    assert harness.forbidden_modules() == ["jaxlib", "reservoir_tpu"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_references_import_nothing_of_the_program_or_jax():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"reservoir_tpu_torch", "reservoir_tpu", "jax", "jaxlib", "flax"}, path
    code = ("import sys, cardbench.reference.weighted, cardbench.reference.distinct; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'reservoir_tpu_torch', 'reservoir_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"reservoir_tpu", "jax", "jaxlib", "flax"}, path


def test_a_run_holds_neither_jax_nor_the_jax_package():
    code = ("import sys, time, json, torch; from cardbench import harness; "
            "cell = harness.load_cell(json.load(open('BENCHMARK.json')), 'distinct.ingest'); "
            "cell.config.update(num_reservoirs=16, max_sample_size=4, check_rows=16); "
            "cell.traffic.update(tile_width=64, warmup_tiles=2, snapshot_every=2); "
            "ctx = harness.Context(cell, 5, 0.2, False, torch.device('cpu'), time.perf_counter()); "
            "out = harness.load_module('loops', 'device_ingest').run(ctx); "
            "print(json.dumps([all(c.ok for c in out.checks), harness.forbidden_modules(), "
            "'reservoir_tpu_torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]
