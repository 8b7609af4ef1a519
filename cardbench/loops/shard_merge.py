"""Shards of one logical stream on one card, merged each round through the
configuration's stream merger.

Parameters (the traffic file): ``shards`` (engines, and ranks of the
stream mesh, all on the one card), ``tile_width`` (B), ``pool_tiles`` (each
shard's own pool, made on the card from the seed and dispatched in an
order the seed fixes for that shard), ``warmup_rounds`` and, optionally,
``fresh_lanes`` (as for ``device_ingest``: each shard's tile of a round
has its first that many lanes xored with a mark the seed draws for that
shard and round).

A round is one tile into every shard, each shard's ``engine.state``, and
the merger over ``make_mesh(devices=[card] * shards, axis="stream")`` fed
those states; it ends when the merged leaves are in the run's host buffers
(pinned, made once).  End-to-end
readings: each merge's time from the merger's call (once the shards' work
has completed) to its host leaves, and rounds over the window's seconds.
"""

from __future__ import annotations

import time

import numpy as np

from cardbench.harness import Check, Context, Outcome, load_module, no_span, share, tile_order, words_off

#: the longest order drawn a shard: past any window
MAX_ROUNDS = 1 << 17


def run(ctx: Context) -> Outcome:
    import torch

    from reservoir_tpu_torch.parallel import make_mesh

    cfg, tr = ctx.config, ctx.traffic
    mode = load_module("modes", cfg["mode"])
    S, B, P = tr["shards"], tr["tile_width"], tr["pool_tiles"]
    R = cfg["num_reservoirs"]
    rows = np.sort(ctx.rng(1).choice(R, min(cfg["merge_check_rows"], R), replace=False)).astype(np.int64)
    orders = np.stack([tile_order(ctx.rng(2, s), P, MAX_ROUNDS) for s in range(S)])
    lanes = tr.get("fresh_lanes", 0)
    marks = np.stack([ctx.rng(3, s).integers(0, 2**31, MAX_ROUNDS) for s in range(S)]) if lanes else None
    applied = np.zeros((S, P), np.int64)  # the mark each pool tile holds now
    gen = ctx.generator()
    pools = [mode.make_pool(cfg, P, B, gen, ctx.device) for _ in range(S)]
    keys = mode.shard_keys(ctx, S)
    engines = [mode.engine(cfg, B, key, ctx.device) for key in keys]
    merger = mode.stream_merger(make_mesh(devices=[ctx.device] * S, axis="stream"))
    rounds = 0
    # the merged leaves land in host buffers made once (pinned on the card),
    # so a merge's time holds no page faults of fresh host memory
    hosts = []

    def one_round(span) -> tuple:
        nonlocal rounds
        if lanes:
            with span("freshen"):
                for s in range(S):
                    p = int(orders[s, rounds])
                    mode.freshen(pools[s], p, int(marks[s, rounds] ^ applied[s, p]), lanes)
                    applied[s, p] = marks[s, rounds]
        with span("shard_samples"):
            for s, engine in enumerate(engines):
                mode.sample(engine, pools[s], int(orders[s, rounds]))
        with span("shard_states"):
            states = [engine.state for engine in engines]
            ctx.synchronize()
        t0 = time.perf_counter()
        with span("merge"):
            out = mode.merge(merger, states)
            if not hosts:
                hosts.extend(torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=ctx.device.type == "cuda")
                             for leaf in out)
            for host, leaf in zip(hosts, out):
                host.copy_(leaf, non_blocking=True)
            ctx.synchronize()
        rounds += 1
        return [host.numpy() for host in hosts], (time.perf_counter() - t0) * 1e3

    for _ in range(tr["warmup_rounds"]):
        one_round(no_span)
    ctx.synchronize()
    start_rounds = rounds

    merge_ms, merges = [], []
    with ctx.window() as w:
        end = w.start + ctx.seconds
        while True:
            leaves, ms = one_round(w.span)
            merge_ms.append(ms)
            prev = merges[-1][1] if merges else None
            merges.append((rounds, share(prev, mode.merged_rows(leaves, rows))))
            if time.perf_counter() >= end:
                break
        ctx.synchronize()
        w.close()

    n = rounds - start_rounds
    finals = [mode.state_rows(engine.state, rows) for engine in engines]
    counts = np.concatenate([mode.counts(engine.state) for engine in engines])
    work = {"merges": n, "ranks": S, "gather_words": mode.gather_words(cfg)}
    peak = ctx.memory_peak()
    del engines, merger, leaves
    ctx.free()

    fresh = {}
    if lanes:  # the pools as made, and each dispatch's mark
        for s in range(S):
            for p in range(P):
                mode.freshen(pools[s], p, int(applied[s, p]), lanes)
        fresh = {"marks": marks, "lanes": lanes}
    checkpoints = sorted({t for t, _ in merges})
    want = mode.reference_merge(cfg, pools, rows, keys, orders, checkpoints, **fresh)
    if ctx.precision is not None:  # the control: the reference in the program's place
        got = mode.reference_merge(cfg, pools, rows, keys, orders, checkpoints, ctx.precision, **fresh)
        merges = [(t, got["merged"][t]) for t, _ in merges]
        finals = got["shards"]
    merge_off = [words_off(m, want["merged"][t]) for t, m in merges]
    expected = (rounds * B + 2**31) % 2**32 - 2**31
    shard_off = sum(words_off(f, s) for f, s in zip(finals, want["shards"])) + int((counts != expected).sum())
    checks = [
        Check("merge_words_off", sum(merge_off), 0, len(merge_off), sum(1 for x in merge_off if x)),
        Check("shard_words_off", shard_off, 0, 1, int(shard_off > 0)),
    ]
    record = {
        "window_s": w.stop - w.start,
        "setup_s": w.start - ctx.t0,
        "rounds": n,
        "merge_ms": merge_ms,
    }
    return Outcome(record, work, checks, peak, w.timeline)
