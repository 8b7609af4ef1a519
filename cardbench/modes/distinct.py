"""The distinct (salted bottom-k) mode: its engine, its inputs, what a run
reads back, and its reference (:mod:`cardbench.reference.distinct`).

Inputs: int32 keys by bench.py's Zipf-1.1 recipe, ``min(u^-10, 10^7)``
with ``u`` uniform on ``[1e-6, 1)``, made on the card from the seed.  A
traffic mix with ``fresh_lanes`` xors a tile's first lanes with a mark
the seed draws for each dispatch (:func:`freshen`), so every dispatch
brings keys no earlier one had.  Every shard of a merge takes the same
engine key, so all share salts, as the merge requires.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from cardbench.reference import distinct as ref

#: the control: the reference with its keys cut to 16 bits, the integer
#: width below the configuration's int32 keys
CONTROL = "int16"
#: what a merger takes and returns, in order
LEAVES = ("values", "hash_hi", "hash_lo", "size", "count", "salts")


def engine(config: dict, width: int, key_words, device):
    from reservoir_tpu_torch import ReservoirEngine, SamplerConfig

    cfg = SamplerConfig(config["max_sample_size"], config["num_reservoirs"], tile_size=width,
                        element_dtype=config["element_dtype"], distinct=True)
    return ReservoirEngine(cfg, key=np.asarray(key_words, np.uint32), reusable=True, device=device)


def make_pool(config: dict, tiles: int, width: int, gen, device) -> Dict[str, torch.Tensor]:
    """The pool, a tile at a time, so that the uniforms of one tile are the
    only buffer beside it."""
    keys = torch.empty((tiles, config["num_reservoirs"], width), dtype=torch.int32, device=device)
    for tile in keys:
        u = torch.rand(tile.shape, generator=gen, device=device).mul_(1.0 - 1e-6).add_(1e-6)
        tile.copy_(u.pow_(-10.0).clamp_(max=1e7))
    return {"keys": keys}


def freshen(pool: Dict[str, torch.Tensor], p: int, word: int, lanes: int) -> None:
    """Xor the first ``lanes`` keys of every row of pool tile ``p`` with
    ``word``, in place, on the stream the engine launches on."""
    pool["keys"][p, :, :lanes].bitwise_xor_(word)


def sample(engine, pool: Dict[str, torch.Tensor], p: int) -> None:
    engine.sample(pool["keys"][p])


def shard_keys(ctx, shards: int) -> List[np.ndarray]:
    """One engine key for every shard: shared salts."""
    return [ctx.key_words(0)] * shards


def snapshot_rows(arrays, rows: np.ndarray) -> Dict[str, np.ndarray]:
    samples, sizes = arrays
    return {"samples": samples[rows].copy(), "size": sizes[rows].copy()}


def state_rows(state, rows: np.ndarray) -> Dict[str, np.ndarray]:
    idx = torch.from_numpy(rows).to(state.values.device)
    return {name: getattr(state, name).index_select(0, idx).cpu().numpy().view(np.int32) for name in LEAVES}


def counts(state) -> np.ndarray:
    return state.count.cpu().numpy()


def work_state(state) -> tuple:
    """What the bound's work is counted from: the hashes and sizes."""
    return state.hash_hi.cpu().numpy(), state.hash_lo.cpu().numpy(), state.size.cpu().numpy()


def work(before: tuple, after: tuple) -> Dict[str, float]:
    from cardbench.bounds import net_inserts

    inserts, rows_inserting = net_inserts(before, after)
    return {"inserts": inserts, "rows_inserting": rows_inserting}


def stream_merger(mesh):
    from reservoir_tpu_torch.parallel.merge import distinct_stream_merger

    return distinct_stream_merger(mesh)


def merge(merger, states: Sequence) -> tuple:
    return merger(*([getattr(s, name) for s in states] for name in LEAVES))


def merged_rows(leaves: Sequence[np.ndarray], rows: np.ndarray) -> Dict[str, np.ndarray]:
    return {name: leaf[rows].view(np.int32).copy() for name, leaf in zip(LEAVES, leaves)}


def gather_words(config: dict) -> int:
    """32-bit words of one shard's merger leaves: three ``[R, k]`` planes,
    size and count, four salts a row."""
    R, k = config["num_reservoirs"], config["max_sample_size"]
    return 3 * R * k + 2 * R + 4 * R


# ------------------------------------------------------------------ reference

#: tiles a reference step takes at most, so that its sort stays small
_STEP_TILES = 64


class _Replay:
    """The checked rows of several shards replayed tile by tile: each
    shard's bottom k of the keys it has seen.  A tile's lanes past the
    fresh ones are the same at every dispatch, so their bottom k is made
    once a pool tile; the fresh lanes are xored with the dispatch's mark
    and hashed anew."""

    def __init__(self, config: dict, pools: Sequence, rows: np.ndarray, hasher: ref.Hasher, lanes: int) -> None:
        self.k, self.lanes, self.hasher, self.m = config["max_sample_size"], lanes, hasher, len(rows)
        self.rows = np.tile(rows, len(pools))
        base, fresh = [], []
        for pool in pools:
            keys = pool["keys"]
            sub = keys.index_select(1, torch.from_numpy(rows).to(keys.device))  # [P, m, B]
            fresh.append(sub[:, :, :lanes].to(hasher.device))
            tiles = []
            for p in range(sub.shape[0]):
                vals = hasher.narrow(sub[p, :, lanes:])
                tiles.append(torch.stack(ref.bottom_k(hasher.keys(vals, rows), vals, self.k)))
            base.append(torch.stack(tiles))
        self.base = torch.stack(base)  # [S, P, 2, m, k]
        self.fresh = torch.stack(fresh)  # [S, P, m, lanes]
        n = len(self.rows)
        self.state = (torch.full((n, self.k), ref.PAD, dtype=torch.int64, device=hasher.device),
                      torch.zeros((n, self.k), dtype=torch.int64, device=hasher.device))

    def step(self, tiles: np.ndarray, marks: np.ndarray) -> None:
        """Shard ``s`` takes pool tiles ``tiles[s]`` (``[S, n]``), their
        fresh lanes xored with ``marks[s]``."""
        S, n = tiles.shape
        k, m, dev = self.k, self.m, self.hasher.device
        shard = torch.arange(S, device=dev)[:, None]
        q = torch.from_numpy(np.asarray(tiles, np.int64)).to(dev)
        b = self.base[shard, q]  # [S, n, 2, m, k]
        parts = [self.state, (b[:, :, 0].permute(0, 2, 1, 3).reshape(S * m, n * k),
                              b[:, :, 1].permute(0, 2, 1, 3).reshape(S * m, n * k))]
        if self.lanes:
            mark = torch.from_numpy(np.asarray(marks, np.int32)).to(dev)
            vals = self.fresh[shard, q] ^ mark[:, :, None, None]  # [S, n, m, lanes]
            vals = self.hasher.narrow(vals.permute(0, 2, 1, 3).reshape(S * m, n * self.lanes))
            parts.append(ref.bottom_k(self.hasher.keys(vals, self.rows), vals, k))
        self.state = ref.union(parts, k)

    def shard(self, s: int) -> tuple:
        return tuple(x[s * self.m:(s + 1) * self.m] for x in self.state)


def _state(st: Dict[str, np.ndarray], count: int, salts: np.ndarray) -> Dict[str, np.ndarray]:
    n = st["size"].shape[0]
    wrapped = (count + 2**31) % 2**32 - 2**31
    return {"values": st["values"], "hash_hi": st["hash_hi"], "hash_lo": st["hash_lo"], "size": st["size"],
            "count": np.full(n, wrapped, np.int32), "salts": salts}


def _marks(marks, shape) -> np.ndarray:
    return np.zeros(shape, np.int64) if marks is None else np.asarray(marks)


def reference_ingest(config: dict, pool, rows: np.ndarray, key_words, order: np.ndarray,
                     checkpoints: Sequence[int], precision: str = "int32", device=None,
                     marks=None, lanes: int = 0) -> Dict[int, dict]:
    """The rows' states after each checkpoint's number of tiles: ``{tiles:
    {"state": ..., "snapshot": ...}}``.  ``pool`` is the pool as made; tile
    ``t``'s first ``lanes`` lanes were xored with ``marks[t]``."""
    hasher = ref.Hasher(key_words, config["num_reservoirs"], device or pool["keys"].device, precision)
    replay = _Replay(config, [pool], rows, hasher, lanes)
    salts = hasher.salts_i32()[rows]
    width = pool["keys"].shape[2]
    want = set(checkpoints)
    marks = _marks(marks, len(order))
    out, done = {}, 0
    for t in sorted(want | set(range(_STEP_TILES, max(want), _STEP_TILES))):
        replay.step(order[None, done:t], marks[None, done:t])
        done = t
        if t in want:
            st = _state(ref.planes(*replay.state), t * width, salts)
            out[t] = {"state": st, "snapshot": {"samples": st["values"], "size": st["size"]}}
    return out


def reference_merge(config: dict, pools: Sequence, rows: np.ndarray, keys: Sequence, orders: np.ndarray,
                    checkpoints: Sequence[int], precision: str = "int32", device=None,
                    marks=None, lanes: int = 0) -> dict:
    """The rows' merge after each checkpoint's number of rounds, and every
    shard's rows' state after the last: ``{"merged": {rounds: leaves},
    "shards": [state, ...]}``.  ``pools`` are the pools as made; shard
    ``s``'s tile of round ``t`` had its first ``lanes`` lanes xored with
    ``marks[s, t]``."""
    hasher = ref.Hasher(keys[0], config["num_reservoirs"], device or pools[0]["keys"].device, precision)
    replay = _Replay(config, pools, rows, hasher, lanes)
    salts = hasher.salts_i32()[rows]
    S, width = len(pools), pools[0]["keys"].shape[2]
    want = set(checkpoints)
    marks = _marks(marks, orders.shape)
    merged = {}
    for t in range(max(want)):
        replay.step(orders[:, t:t + 1], marks[:, t:t + 1])
        if t + 1 in want:
            root = ref.union([replay.shard(s) for s in range(S)], config["max_sample_size"])
            merged[t + 1] = _state(ref.planes(*root), S * (t + 1) * width, salts)
    last = max(want)
    return {"merged": merged,
            "shards": [_state(ref.planes(*replay.shard(s)), last * width, salts) for s in range(S)]}
