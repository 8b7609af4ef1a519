"""The weighted (A-ExpJ) mode: its engine, its inputs, what a run reads
back, and its reference (:mod:`cardbench.reference.weighted`).

Inputs: int32 elements drawn uniformly over all 32-bit words, and float32
weights ``exp(N(0, 1))`` (lognormal), made on the card from the seed.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cardbench.reference import weighted as ref
from cardbench.reference.common import split_rows

#: the control: the reference with its weights rounded to bfloat16, the
#: precision below the configuration's float32
CONTROL = "bfloat16"


def engine(config: dict, width: int, key_words, device):
    from reservoir_tpu_torch import ReservoirEngine, SamplerConfig

    cfg = SamplerConfig(config["max_sample_size"], config["num_reservoirs"], tile_size=width,
                        element_dtype=config["element_dtype"], weighted=True)
    return ReservoirEngine(cfg, key=np.asarray(key_words, np.uint32), reusable=True, device=device)


def make_pool(config: dict, tiles: int, width: int, gen, device) -> Dict[str, torch.Tensor]:
    shape = (tiles, config["num_reservoirs"], width)
    elems = torch.randint(-(2**31), 2**31 - 1, shape, dtype=torch.int32, device=device, generator=gen)
    weights = torch.randn(shape, generator=gen, device=device).exp_()
    return {"elems": elems, "weights": weights}


def sample(engine, pool: Dict[str, torch.Tensor], p: int) -> None:
    engine.sample(pool["elems"][p], weights=pool["weights"][p])


def snapshot_rows(arrays, rows: np.ndarray) -> Dict[str, np.ndarray]:
    samples, sizes = arrays
    return {"samples": samples[rows].copy(), "size": sizes[rows].copy()}


def state_rows(state, rows: np.ndarray) -> Dict[str, np.ndarray]:
    idx = torch.from_numpy(rows).to(state.samples.device)
    return {"samples": state.samples.index_select(0, idx).cpu().numpy(),
            "lkeys": state.lkeys.index_select(0, idx).cpu().numpy(),
            "count": state.count.index_select(0, idx).cpu().numpy(),
            "xw": state.xw.index_select(0, idx).cpu().numpy(),
            "key": state.key.index_select(0, idx).cpu().numpy().astype(np.uint32)}


def counts(state) -> np.ndarray:
    return state.count.cpu().numpy()


def work_state(state) -> np.ndarray:
    """What the bound's work is counted from: the log keys."""
    return state.lkeys.cpu().numpy()


def work(before: np.ndarray, after: np.ndarray) -> Dict[str, float]:
    from cardbench.bounds import weighted_work

    accepts, fills = weighted_work(before, after)
    return {"accepts": accepts, "fills": fills}


# ------------------------------------------------------------------ reference

def _rows(pool: Dict[str, torch.Tensor], rows: np.ndarray, name: str) -> np.ndarray:
    """``[m, P, B]``: the rows' part of each pool tile, on the host."""
    idx = torch.from_numpy(rows).to(pool[name].device)
    return pool[name].index_select(1, idx).cpu().numpy().transpose(1, 0, 2)


def _as_state(st: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {name: st[name].copy() for name in ("samples", "lkeys", "count", "xw", "key")}


def reference_ingest(config: dict, pool, rows: np.ndarray, key_words, order: np.ndarray,
                     checkpoints: Sequence[int], precision: str = "float32") -> Dict[int, dict]:
    """The rows' states after each checkpoint's number of tiles: ``{tiles:
    {"state": ..., "snapshot": ...}}``."""
    streams = ref.Streams(split_rows(key_words, rows), config["max_sample_size"], _rows(pool, rows, "elems"),
                          _rows(pool, rows, "weights"), precision)
    want = set(checkpoints)
    out = {}
    for t in range(max(want)):
        streams.step(int(order[t]))
        if t + 1 in want:
            st = _as_state(streams.state)
            samples, size = ref.result(st)
            out[t + 1] = {"state": st, "snapshot": {"samples": samples, "size": size}}
    return out
