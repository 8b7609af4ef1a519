"""Each cell driven on the CPU at a size a test run holds, past the look for
a card: a sound run is correct; the control (the reference in the
program's place, in the precision below the configuration's) is not; and
with the timed path broken underneath, each fault the cell can have makes
``correct`` false.  Every row is compared at this size.

The control at the cells' own size runs on the card: ``python -m
cardbench.control --workload <cell> --seeds a,b,c --seconds <run_seconds>``;
and ``test_a_cell_runs_correct_on_the_card`` below runs one short cell
there.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cardbench import harness
from reservoir_tpu_torch import engine as program_engine
from reservoir_tpu_torch.parallel import merge as program_merge

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
MERGE_CELLS = [c for c in CELLS if harness.load_cell(BENCH, c).traffic["loop"] == "shard_merge"]
INGEST_CELLS = [c for c in CELLS if c not in MERGE_CELLS]


def run_small(workload: str, seed: int = 11, precision=None, **traffic) -> harness.Outcome:
    cell = harness.load_cell(BENCH, workload)
    cell.config.update(num_reservoirs=32, max_sample_size=8, check_rows=32, merge_check_rows=32)
    cell.traffic.update(tile_width=128, warmup_tiles=6, warmup_rounds=2, snapshot_every=3, **traffic)
    ctx = harness.Context(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter(), precision)
    return harness.load_module("loops", cell.traffic["loop"]).run(ctx)


def correct(outcome: harness.Outcome) -> bool:
    return all(c.ok for c in outcome.checks)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = run_small(workload, seed=2**31 + 99)
    assert correct(out), [(c.name, c.value) for c in out.checks]
    assert all(c.answers for c in out.checks) and out.record["window_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    control = harness.load_module("modes", harness.load_cell(BENCH, workload).config["mode"]).CONTROL
    assert not correct(run_small(workload, precision=control))


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(program_engine.ReservoirEngine, "sample", lambda self, tile, valid=None, weights=None: None)


def _half_the_batch(monkeypatch):
    sample = program_engine.ReservoirEngine.sample

    def half(self, tile, valid=None, weights=None):
        w = tile.shape[1] // 2
        sample(self, tile[:, :w].contiguous(), valid, None if weights is None else weights[:, :w].contiguous())

    monkeypatch.setattr(program_engine.ReservoirEngine, "sample", half)


def _answer_altered(monkeypatch):
    peek, tree = program_engine.ReservoirEngine.peek_arrays, program_merge._tree_for

    def altered_peek(self):
        samples, sizes = peek(self)
        samples = samples.copy()
        samples[len(samples) // 2, 0] += 1
        return samples, sizes

    def altered_tree(mode, items, key_words):
        out = [x.clone() for x in tree(mode, items, key_words)]
        out[0].view(torch.int32)[len(out[0]) // 2, 0] += 1
        return tuple(out)

    monkeypatch.setattr(program_engine.ReservoirEngine, "peek_arrays", altered_peek)
    monkeypatch.setattr(program_merge, "_tree_for", altered_tree)


def _no_exchange(monkeypatch):
    def own_blocks_only(rank_leaves, comm=None):
        d = len(rank_leaves)
        return [tuple(torch.cat([leaf] * d) for leaf in leaves) for leaves in rank_leaves]

    monkeypatch.setattr(program_merge, "gather_parts", own_blocks_only)


def _seen_tile_skipped(monkeypatch):
    """A tile whose memory an engine has read before is counted and not
    sampled: exact on a pool that repeats, so each dispatch has to differ."""
    sample, seen = program_engine.ReservoirEngine.sample, set()

    def skip_seen(self, tile, valid=None, weights=None):
        if (id(self), tile.data_ptr()) in seen:
            self._shards = [st._replace(count=st.count + tile.shape[1]) for st in self._shards]
            return
        seen.add((id(self), tile.data_ptr()))
        sample(self, tile, valid, weights)

    monkeypatch.setattr(program_engine.ReservoirEngine, "sample", skip_seen)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_batch": _half_the_batch,
          "answer_altered": _answer_altered, "seen_tile_skipped": _seen_tile_skipped, "no_exchange": _no_exchange}


def _dispatches_differ(workload: str) -> bool:
    """A weighted tile's draws are keyed on the count, so a repeated tile
    changes the state; a distinct one only where the mix freshens each
    dispatch (``device_ingest.b8192.pool8`` does not: a tile skipped as seen
    goes unnoticed there)."""
    cell = harness.load_cell(BENCH, workload)
    return cell.config["mode"] != "distinct" or cell.traffic.get("fresh_lanes", 0) > 0


@pytest.mark.parametrize("workload,fault",
                         [(c, f) for c in CELLS for f in FAULTS
                          if (f != "no_exchange" or c in MERGE_CELLS)
                          and (f != "seen_tile_skipped" or _dispatches_differ(c))])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small(workload)
    assert not correct(out)
    assert sum(c.wrong for c in out.checks) >= 1


def test_fresh_lanes_show_a_tile_skipped_as_seen(monkeypatch):
    """The repeating distinct pool hides the fault (``PERF.md`` lists the
    blind spot); ``fresh_lanes`` in the ingest mix would show it."""
    _seen_tile_skipped(monkeypatch)
    assert correct(run_small("distinct.ingest"))
    assert not correct(run_small("distinct.ingest", fresh_lanes=64))


def test_the_answers_read_are_the_cells_row_sample():
    out = run_small(INGEST_CELLS[0])
    snaps = [c for c in out.checks if c.name == "snapshot_words_off"][0]
    assert snaps.answers == len(out.record["snapshot_ms"]) >= 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_a_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload", workload, "--seed", "2147483777",
                          "--seconds", "2", "--trace", "0"], cwd=harness.REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
