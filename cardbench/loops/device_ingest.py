"""A closed loop of tiles that live on the card, with snapshots read while
tiles are in flight.

Parameters (the traffic file): ``tile_width`` (B, elements a stream a
tile), ``pool_tiles`` (tiles made on the card from the seed, dispatched in
an order the seed fixes: consecutive random permutations of the pool),
``in_flight`` (tiles queued at most: before tile t the loop waits on the
event recorded after tile t - in_flight), ``snapshot_every`` (one
``peek_arrays()`` a that many tiles), ``warmup_tiles`` (tiles fed, with
their snapshots, before the window opens) and, optionally,
``fresh_lanes``: before each dispatch the first that many lanes of every
row of its tile are xored with a mark the seed draws for that dispatch
(the mode's ``freshen``), so that no dispatch repeats an earlier one.

End-to-end readings: every element of every tile dispatched in the window
(all complete at its closing synchronise) over the window's seconds; each
snapshot's time from the ``peek_arrays()`` call to its host arrays.
"""

from __future__ import annotations

import time

import numpy as np

from cardbench.harness import Check, Context, Outcome, load_module, no_span, share, tile_order, words_off

#: the longest order drawn: past any window (at 0.1 ms a tile, 100 s)
MAX_TILES = 1 << 20


def run(ctx: Context) -> Outcome:
    import torch

    cfg, tr = ctx.config, ctx.traffic
    mode = load_module("modes", cfg["mode"])
    R, B, P = cfg["num_reservoirs"], tr["tile_width"], tr["pool_tiles"]
    in_flight, every = tr["in_flight"], tr["snapshot_every"]
    key = ctx.key_words(0)
    rows = np.sort(ctx.rng(1).choice(R, min(cfg["check_rows"], R), replace=False)).astype(np.int64)
    order = tile_order(ctx.rng(2), P, MAX_TILES)
    lanes = tr.get("fresh_lanes", 0)
    marks = ctx.rng(3).integers(0, 2**31, MAX_TILES) if lanes else None
    applied = np.zeros(P, np.int64)  # the mark each pool tile holds now
    pool = mode.make_pool(cfg, P, B, ctx.generator(), ctx.device)
    engine = mode.engine(cfg, B, key, ctx.device)
    events = [torch.cuda.Event() for _ in range(in_flight)] if ctx.device.type == "cuda" else None
    tiles = 0

    def feed(span) -> None:
        nonlocal tiles
        slot, p = tiles % in_flight, int(order[tiles])
        if events is not None and tiles >= in_flight:
            events[slot].synchronize()
        if lanes:
            with span("freshen"):
                mode.freshen(pool, p, int(marks[tiles] ^ applied[p]), lanes)
            applied[p] = marks[tiles]
        with span("sample"):
            mode.sample(engine, pool, p)
        if events is not None:
            events[slot].record()
        tiles += 1

    for i in range(tr["warmup_tiles"]):
        feed(no_span)
        if (i + 1) % every == 0:
            engine.peek_arrays()
    ctx.synchronize()
    before = mode.work_state(engine.state) if ctx.trace else None
    start_tiles = tiles

    snapshot_ms, snapshots = [], []
    with ctx.window() as w:
        end = w.start + ctx.seconds
        while True:
            feed(w.span)
            if (tiles - start_tiles) % every == 0:
                t0 = time.perf_counter()
                with w.span("snapshot"):
                    arrays = engine.peek_arrays()
                snapshot_ms.append((time.perf_counter() - t0) * 1e3)
                prev = snapshots[-1][1] if snapshots else None
                snapshots.append((tiles, share(prev, mode.snapshot_rows(arrays, rows))))
            if time.perf_counter() >= end:
                break
        ctx.synchronize()
        w.close()

    n = tiles - start_tiles
    state = engine.state
    final = mode.state_rows(state, rows)
    counts = mode.counts(state)
    work = {"launches": n, "lanes": R * B, "rows": R, "k": cfg["max_sample_size"]}
    if ctx.trace:
        work.update(mode.work(before, mode.work_state(state)))
    peak = ctx.memory_peak()
    del engine, state, before
    ctx.free()

    fresh = {}
    if lanes:  # the pool as made, and each dispatch's mark
        for p in range(P):
            mode.freshen(pool, p, int(applied[p]), lanes)
        fresh = {"marks": marks, "lanes": lanes}
    checkpoints = sorted({t for t, _ in snapshots} | {tiles})
    want = mode.reference_ingest(cfg, pool, rows, key, order, checkpoints, **fresh)
    if ctx.precision is not None:  # the control: the reference in the program's place
        got = mode.reference_ingest(cfg, pool, rows, key, order, checkpoints, ctx.precision, **fresh)
        snapshots = [(t, got[t]["snapshot"]) for t, _ in snapshots]
        final = got[tiles]["state"]
    snap_off = [words_off(s, want[t]["snapshot"]) for t, s in snapshots]
    expected = (tiles * B + 2**31) % 2**32 - 2**31
    state_off = words_off(final, want[tiles]["state"]) + int((counts != expected).sum())
    checks = [
        Check("snapshot_words_off", sum(snap_off), 0, len(snap_off), sum(1 for x in snap_off if x)),
        Check("state_words_off", state_off, 0, 1, int(state_off > 0)),
    ]
    record = {
        "window_s": w.stop - w.start,
        "setup_s": w.start - ctx.t0,
        "elements": n * R * B,
        "tiles": n,
        "snapshot_ms": snapshot_ms,
    }
    return Outcome(record, work, checks, peak, w.timeline)
