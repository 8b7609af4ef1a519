"""The tile kernels' launch-geometry sweep on the card, and the autotune
cache's winners.

    python -m reservoir_tpu_torch.tools.block_sweep --kernel algl|weighted|distinct|gate
        --cache FILE [--shape R,k,B] [--variants 32,64,128,256] [--timeout 600] [--out FILE]

The port's counterpart of the JAX package's ``tools/tpu_block_sweep.py``
and ``tools/tpu_best_block.py`` in one script.  ``--kernel`` sweeps one
kernel at its headline shape (:data:`SHAPES`: ``algl_update`` at config 5,
``weighted_update`` at config 4, ``distinct_update`` at the distinct
benchmark's shape, the skip gate at the gated A/B shape) or at ``--shape``.
A kernel's variants are rows a block (by default every one it is built
for, :data:`~..ops.blocking.BLOCK_CHOICES`); the gate's are
``gate_tile:gate_push_chunk`` pairs.  The variants run in a child process
with a hard timeout, so a variant that hangs costs its timeout and is
reported, never inherited.  In the child, every variant's output is held
bit for bit against the default geometry's on the same input (a variant
that differs is reported and never recorded); then each is timed in
:data:`TURNS` turns, first to last and back: the kernels' as the bare
launch through its ctypes entry point (every argument made beforehand,
CUDA events around 10 launches back to back, each on its own copy of the
state, the median of 5 rounds a turn), the gate as the host-fed second
pass of a fresh gated bridge a turn, so every timed pass runs at the same
depth of the stream.
Each variant's result is one JSON line appended to ``--out``, with the
card's name and power limit.  A non-default variant is recorded only where
it beats the default in every turn by more than the spread of either's
turns (:func:`beats_default`); of those, the fastest goes through
:func:`~..ops.autotune.record_if_better` into ``--cache``, where the
engine and the bridge read it.  Where none does, nothing is recorded and
the launches stay the default's.  ``--cache`` is required, so a sweep
never writes the checkout's cache by default.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SHAPES", "GATE_VARIANTS", "TURNS", "beats_default", "default_variants", "main", "sweep"]

#: each kernel's headline shape (R, k, B): config 5's uniform engine,
#: config 4's weighted engine, the distinct benchmark's engine, and the
#: skip gate's A/B shape (64 streams, k = 16, 4,096-wide tiles)
SHAPES: Dict[str, Tuple[int, int, int]] = {
    "algl": (65536, 128, 2048),
    "weighted": (16384, 64, 1024),
    "distinct": (4096, 256, 1024),
    "gate": (64, 16, 4096),
}
#: tiles of one gate pass (the gated A/B shape's stream: 40 tiles a stream)
GATE_STEPS = 40
#: the gate's variants: the default (64, 1 Mi) first, then the tile axis,
#: then the push-slice axis
GATE_VARIANTS = ((64, 1 << 20), (32, 1 << 20), (128, 1 << 20), (256, 1 << 20), (64, 1 << 18),
                 (64, 1 << 22))
#: back-to-back launches between two events, and timed rounds a turn
BATCH, REPS = 10, 5
#: timed turns of every variant, first to last, then last to first, ...
TURNS = 4


def default_variants(kernel: str) -> List[Tuple[int, int]]:
    """A kernel's variants ``(block_r, 0)``: every rows-a-block it is built
    for; the gate's ``(gate_tile, gate_push_chunk)`` pairs."""
    if kernel == "gate":
        return list(GATE_VARIANTS)
    from ..ops.blocking import BLOCK_CHOICES

    return [(b, 0) for b in BLOCK_CHOICES[kernel]]


def _turns(order: list) -> list:
    """:data:`TURNS` passes over ``order``, every other one reversed."""
    return [order if t % 2 == 0 else order[::-1] for t in range(TURNS)]


def beats_default(times: List[float], default_times: List[float]) -> bool:
    """Whether a variant's times (one a turn, lower is better) beat the
    default's of the same turns in every turn by more than the spread
    (largest less smallest) of either's turns."""
    if not times or len(times) != len(default_times):
        return False
    spread = max(max(times) - min(times), max(default_times) - min(default_times))
    return all(d - t > spread for t, d in zip(times, default_times))


def _parse_variants(kernel: str, text: str) -> List[Tuple[int, int]]:
    out = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        nums = [int(x) for x in part.split(":")]
        out.append((nums[0], nums[1] if len(nums) > 1 else (1 << 20 if kernel == "gate" else 0)))
    return out


# ------------------------------------------------------------------ child


def _event_ms(launch, setup) -> List[float]:
    """Milliseconds a launch: CUDA events around ``BATCH`` back-to-back
    launches, each on its own ``setup()`` argument made before the first
    event; one warm-up, then ``REPS`` rounds."""
    import torch

    times = []
    for i in range(REPS + 1):
        args = [setup() for _ in range(BATCH)]
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for a in args:
            launch(a)
        e1.record()
        torch.cuda.synchronize()
        if i:
            times.append(e0.elapsed_time(e1) / BATCH)
        del args
    return times


def _same(a, b) -> bool:
    """Every field of two states equal bit for bit."""
    import torch

    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            return False
    return True


def _clone(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


def _kernel_case(kernel: str, R: int, k: int, B: int, dev):
    """``(state, wrapper, bare, entry)`` at a steady point of the kernel's
    stream: ``wrapper(state, block_r)`` runs the wrapper on a state,
    ``bare(state, rows)`` makes the ctypes arguments of one launch on that
    state at ``rows`` rows a block, and the launch is ``entry(*args)``."""
    import torch

    from ..ops import algorithm_l as aplain
    from ..ops import algorithm_l_cuda as akern
    from ..ops import distinct as dplain
    from ..ops import distinct_cuda as dkern
    from ..ops import weighted as wplain
    from ..ops import weighted_cuda as wkern
    from ..ops.rng import key_from_seed

    gen = torch.Generator(device=dev)
    gen.manual_seed(48)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "algl":
        def tile():
            return torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=dev, generator=gen)

        state = akern.update_cuda(aplain.init(key_from_seed(0), R, k, device=dev), tile())
        for _ in range(6):  # the steady tile from count 7 B
            akern.update_steady_cuda(state, tile())
        batch = tile()
        key32 = state.key.to(torch.int32)  # the kernel's key words (never written)
        lib = akern._library()

        def bare(st, rows):
            return (st.samples.data_ptr(), st.count.data_ptr(), st.nxt.data_ptr(), st.log_w.data_ptr(),
                    key32.data_ptr(), batch.data_ptr(), None, R, k, B, 0, rows, stream)

        return state, (lambda st, b: akern.update_steady_cuda(st, batch, block_r=b)), bare, \
            lib.algl_update_rows
    if kernel == "weighted":
        def tiles(t):
            elems = (t * B + torch.arange(B, dtype=torch.int32, device=dev))[None, :].expand(R, B)
            elems = elems.contiguous()
            return elems, 1.0 + 0.5 * torch.cos(elems.to(torch.float32) * 1e-3) ** 2

        state = wplain.init(key_from_seed(0), R, k, device=dev)
        for t in range(7):  # the steady tile from count 7 B
            wkern.update_cuda(state, *tiles(t))
        elems, weights = tiles(7)
        key32 = state.key.to(torch.int32)
        lib = wkern._library()

        def bare(st, rows):
            return (st.samples.data_ptr(), st.lkeys.data_ptr(), st.count.data_ptr(), st.xw.data_ptr(),
                    key32.data_ptr(), elems.data_ptr(), weights.data_ptr(), None, R, k, B, rows, stream)

        return state, (lambda st, b: wkern.update_cuda(st, elems, weights, block_r=b)), bare, \
            lib.weighted_update_rows

    def zipf():
        u = torch.rand((R, B), generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
        return torch.clamp(u ** -10.0, max=1e7).to(torch.int32)

    state = dplain.init(key_from_seed(0), R, k, device=dev)
    for _ in range(8):  # the steady Zipf tile after 8
        state = dkern.update_cuda(state, zipf())
    keys = zipf()
    lib = dkern._library()

    def bare(st, rows):
        return (st.values.data_ptr(), None, st.hash_hi.data_ptr(), st.hash_lo.data_ptr(),
                st.size.data_ptr(), st.count.data_ptr(), st.salts.data_ptr(), keys.data_ptr(), None, 1,
                None, None, None, R, k, B, rows, dkern.DEFAULT, stream)

    return state, (lambda st, b: dkern.update_cuda(st, keys, block_r=b)), bare, lib.distinct_update_rows


def _measure_kernel(kernel: str, R: int, k: int, B: int, variants, dev) -> List[dict]:
    import torch

    from ..ops.blocking import DEFAULT_BLOCK

    state, wrapper, bare, entry = _kernel_case(kernel, R, k, B, dev)
    want = wrapper(_clone(state), None)
    torch.cuda.synchronize()
    default = DEFAULT_BLOCK[kernel]
    out = {}
    for rows, _ in variants:
        got = wrapper(_clone(state), None if rows == default else rows)
        torch.cuda.synchronize()
        out[rows] = {"block_r": rows, "default": rows == default, "same_bits": _same(got, want), "ms": []}
        del got
    for rows in (r for turn in _turns([rows for rows, _ in variants]) for r in turn):
        if not out[rows]["same_bits"]:
            continue

        def setup(rows=rows):
            st = _clone(state)
            return st, bare(st, rows)  # the copy stays alive with its pointers

        def launch(made, rows=rows):
            code = entry(*made[1])
            if code:
                raise RuntimeError(f"{kernel} launch at {rows} rows a block failed: CUDA error {code}")

        out[rows]["ms"].append(statistics.median(_event_ms(launch, setup)))
    for rec in out.values():
        if rec["ms"]:
            rec["elem_per_sec"] = R * B / (1e-3 * min(rec["ms"]))
    return list(out.values())


def _measure_gate(R: int, k: int, B: int, variants, dev) -> List[dict]:
    import numpy as np
    import torch

    from ..config import SamplerConfig
    from ..stream.bridge import DeviceStreamBridge

    cfg = SamplerConfig(max_sample_size=k, num_reservoirs=R, tile_size=B)
    data = np.random.default_rng(0).integers(0, 1 << 30, (R, B * GATE_STEPS), dtype=np.int64).astype(np.int32)
    times: List[List[float]] = [[] for _ in variants]
    states: list = [None] * len(variants)

    def one_pass(bridge) -> float:
        t0 = time.perf_counter()
        for s in range(R):
            bridge.push(s, data[s])
        bridge.flush()
        bridge.drain_barrier()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # a turn is a fresh bridge a variant, its first pass untimed and its
    # second timed, so every timed pass runs at the same depth of the stream
    for turn in _turns(list(range(len(variants)))):
        for i in turn:
            tile, chunk = variants[i]
            bridge = DeviceStreamBridge(cfg, key=0, reusable=True, gated=True, gate_tile=tile,
                                        gate_push_chunk=chunk, device=dev)
            one_pass(bridge)
            times[i].append(one_pass(bridge))
            states[i] = bridge.engine.state
            bridge.complete()
    want = states[list(map(tuple, variants)).index(GATE_VARIANTS[0])]
    out = []
    for (tile, chunk), state, s in zip(variants, states, times):
        out.append({"gate_tile": tile, "gate_push_chunk": chunk, "default": (tile, chunk) == GATE_VARIANTS[0],
                    "same_bits": _same(state, want), "s": s, "elem_per_sec": R * B * GATE_STEPS / min(s)})
    return out


def _card() -> dict:
    import torch

    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        line = "nvidia-smi unavailable"
    return {"device_kind": torch.cuda.get_device_name(0), "card": line}


def _child(jobs: List[dict]) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("block_sweep needs a CUDA card")
    dev = torch.device("cuda")
    card = _card()
    for job in jobs:
        R, k, B = job["shape"]
        variants = [tuple(v) for v in job["variants"]]
        if job["kernel"] == "gate":
            recs = _measure_gate(R, k, B, variants, dev)
        else:
            recs = _measure_kernel(job["kernel"], R, k, B, variants, dev)
        for rec in recs:
            print(json.dumps({"kernel": job["kernel"], "R": R, "k": k, "B": B, **card, **rec}), flush=True)


# ----------------------------------------------------------------- parent


def _default_variant(kernel: str) -> Tuple[int, int]:
    from ..ops.blocking import DEFAULT_BLOCK

    return GATE_VARIANTS[0] if kernel == "gate" else (DEFAULT_BLOCK[kernel], 0)


def _times(rec: dict) -> List[float]:
    """A record's times, one a turn: ms for a kernel, seconds for the gate."""
    return rec["s"] if rec["kernel"] == "gate" else rec["ms"]


def sweep(jobs: List[dict], cache: str, timeout: float = 600.0, out: Optional[str] = None) -> List[dict]:
    """Run ``jobs`` (``{"kernel", "shape": (R, k, B), "variants"}`` each,
    the default variant added where it is missing) in one child process
    with a hard ``timeout``; returns every variant's record and appends
    each to ``out``.  Each record says whether it ``beats_default``
    (:func:`beats_default`, only where its bits held); of a job's variants
    that do, the fastest (the least median turn) goes through
    :func:`~..ops.autotune.record_if_better` into ``cache`` (``cached``).
    Raises if the child fails or times out: a geometry that cannot build or
    launch is a failure, not a fallback."""
    from statistics import median

    from ..ops import autotune

    jobs = [dict(job, variants=[list(v) for v in job["variants"]]) for job in jobs]
    for job in jobs:
        default = list(_default_variant(job["kernel"]))
        if default not in job["variants"]:
            job["variants"].insert(0, default)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "reservoir_tpu_torch.tools.block_sweep", "--child",
                           json.dumps(jobs)], capture_output=True, text=True, timeout=timeout, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"the sweep's child failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    groups: Dict[tuple, List[dict]] = {}
    for rec in records:
        groups.setdefault((rec["kernel"], rec["R"], rec["k"], rec["B"]), []).append(rec)
    for (kernel, R, k, B), recs in groups.items():
        default = next((r for r in recs if r["default"]), None)
        for rec in recs:
            rec["beats_default"] = bool(default is not None and rec is not default and rec["same_bits"]
                                        and beats_default(_times(rec), _times(default)))
            rec["cached"] = False
        winners = [r for r in recs if r["beats_default"]]
        if not winners:
            continue  # the default holds: no entry, so launches stay the default's
        won = min(winners, key=lambda r: median(_times(r)))
        geometry = (autotune.Geometry(0, 0, 0, won["gate_tile"], won["gate_push_chunk"]) if kernel == "gate"
                    else autotune.Geometry(won["block_r"], 0, 0))
        won["cached"] = autotune.record_if_better(won["device_kind"], R, k, B, "int32", geometry,
                                                  won["elem_per_sec"], source="block_sweep", path=cache,
                                                  kernel=kernel)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="block_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SHAPES))
    ap.add_argument("--shape", default=None, help="R,k,B (default: the kernel's headline shape)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated rows a block (gate: gate_tile:gate_push_chunk pairs)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--cache", default=None,
                    help="the autotune cache a winner is recorded into (the engine and the bridge read "
                         "$RESERVOIR_ALGL_AUTOTUNE_CACHE)")
    ap.add_argument("--out", default=os.path.join("build", "block_sweep.jsonl"))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(json.loads(args.child))
        return 0
    if args.kernel is None or args.cache is None:
        ap.error("--kernel and --cache are required")
    shape = tuple(int(x) for x in args.shape.split(",")) if args.shape else SHAPES[args.kernel]
    if len(shape) != 3:
        ap.error("--shape takes R,k,B")
    variants = (_parse_variants(args.kernel, args.variants) if args.variants
                else default_variants(args.kernel))
    records = sweep([{"kernel": args.kernel, "shape": shape, "variants": variants}], args.cache, args.timeout,
                    args.out)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if records and all(r["same_bits"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
