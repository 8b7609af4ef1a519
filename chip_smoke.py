"""Smoke test of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's four paths on ``"cuda"`` — the uniform engine,
``ReservoirEngine(SamplerConfig(k=128, R=65536, tile_size=2048), key=0)``,
the weighted engine, ``ReservoirEngine(SamplerConfig(k=64, R=16384,
tile_size=1024, weighted=True), key=0)``, and the distinct engine,
``ReservoirEngine(SamplerConfig(k=256, R=4096, tile_size=1024,
distinct=True, element_dtype=...), key=0)`` with int32 and int64 keys, and
the merge path, four shard engines of each of those configurations combined
by ``parallel.merge``'s stream mergers through the all-gather kernel — and
holds each CUDA kernel against its plain torch version.  Phases, each of
which fails the run with a non-zero exit:

1. device: require a CUDA card; print its name and power limit;
2. build: compile ``reservoir_tpu_torch/csrc`` with nvcc, print the seconds;
3. kernel vs plain version on the card at R=65536, k=128, B=2048, for
   int32 and float32 tiles (with -0.0 and NaN bit patterns planted), and
   for int32 at k=100: a partial fill tile of width 64, a tile across the
   fill boundary, two steady tiles and a ragged tile — samples, count, nxt
   and log_w must be bit-identical;
4. the kernel's log over all 2^24 points of the uniform grid, and its exp
   and log1p over the ranges the chain visits, must equal the torch recipe
   bit for bit;
5. the plain version on the CPU for rows 0..1023 must equal the kernel's
   rows bit for bit;
6. engine path: 8 device-resident tiles then 2 numpy tiles (pinned host
   copies), then ``result_arrays()``: every size is k, every sample lies in
   its row's stream with no repeats, the kernel was launched once per tile,
   and the sampled positions pass the one-sample KS gate;
7. timings (CUDA events around 10 back-to-back launches, median of 11
   such runs): the kernel per fill tile and per steady tile beside the
   plain version and the bound, and per steady tile deep in the stream
   (count 24 B) beside the bound, with the kernel's build (registers a
   thread, local memory for spills, shared memory a block, resident warps
   an SM), the engine's
   elements/s fed from the device and from the host, a host tile's
   snapshot into pinned memory and copy to the card, and the engine fed
   from the host once its pinned buffers are warm;
8. weighted kernel vs plain version on the card at R=16384, k=64, B=1024,
   for int32 and float32 tiles (with -0.0 and NaN bit patterns planted): a
   partial fill tile of width 32 from empty, a tile across the fill's end
   with ~30% zero weights, two steady tiles with the benchmark's weights
   ``1 + 0.5 cos^2(elem * 1e-3)``, a ragged tile, and a tile with subnormal
   and lognormal weights — samples, lkeys, count and xw must be
   bit-identical;
9. the plain weighted version on the CPU for rows 0..1023 must equal the
   kernel's rows bit for bit;
10. weighted engine path: 8 device-resident tiles then 2 numpy tiles, each
   with weight ``pos % 3`` for the element ``row * N + pos``: every size is
   k, no zero-weight element is sampled, every sample lies in its row's
   stream with no repeats, the kernel was launched once per tile, the share
   of weight-2 samples is within 0.005 of 2/3, and the positions sampled
   within the weight-1 class pass the KS gate;
11. weighted timings as in 7: the kernel per fill tile (from empty) and per
   steady tile (from count 7 B) beside the plain version, the bound and the
   build, and the steady tile again with every weight 0 (the scan without
   acceptances) beside its bytes bound;
12. distinct kernel vs plain version on the card at R=4096, k=256, B=1024,
   for int32, uint32 and int64 keys, from a state whose salts send a
   planted key to the hash (MAX, MAX) in every 97th row: a partial tile of
   width 64 from empty (the planted key in every row), a tile across the
   fill's end, three Zipf tiles (bench.py's recipe), a tile of one value,
   a tile of values already held, a tile of negative keys and a ragged tile
   — values, value_hi, hash_hi, hash_lo, size and count must be
   bit-identical, and no planted row may hold the planted key; then, at
   R=8, k=19371 (int32) and k=14529 (int64), the first k whose row block
   passes shared memory, two tiles that fill the rows and evict;
13. the plain distinct version on the CPU for rows 0..1023 must equal the
   kernel's rows bit for bit;
14. distinct engine path, int32 and int64 keys: 8 device-resident Zipf
   tiles then 2 numpy tiles, then ``result_arrays()``: the kernel was
   launched once per tile, every row equals an exact host oracle (the k
   smallest scrambled hashes among the row's distinct keys, in numpy with
   the port's own hashing), every size is min(k, #distinct), and the share
   of sampled keys seen at least 10 times in their row is within 0.01 of
   that share among all the row's distinct keys (uniform over distinct
   values, not weighted by frequency);
15. distinct timings as in 7: the kernel on a Zipf tile from empty, on a
   steady Zipf tile (after 8) and on a steady tile of fresh random keys
   (int32), and on a steady Zipf tile and a Zipf tile from empty with int64
   keys, each beside the plain version, the bound and the build;
   ``torch.sort`` of the ``[R, k + B]`` packed hashes as context (not the
   same function);
16. the all-gather kernel vs its plain version, bit for bit on every rank's
   copy: ``ring_all_gather`` for d in {2, 3, 4, 8} ranks on the card, b in
   {1, 5, 64, 4096}, W in {1, 8, 129} and int32, uint32 and float32 words
   (NaN payloads and -0.0 planted), each twice back to back on one
   communicator (the flags count epochs); ``gather_parts`` on mixed leaves
   and at the main path's shape (4 ranks of ``[65536, 128]`` samples and
   ``[65536]`` counts); with two or more cards, the same with the ranks on
   distinct cards, else a line that says the cross-card path was not run;
17. the merge tree on the card equals the same on the CPU: uniform,
   weighted and distinct ``merge_samples_device`` over P in {2, 3, 5, 8}
   parts with partial fills (4 ranks on the card against the host tree),
   and the three stream mergers over 5 shards of 256 rows;
18. the merge path at full width, the launch counts set to 0 before it:
   four uniform shard engines (R=65536, k=128, B=2048, their own seeds) fed
   streams of 1000, 4096, 6144 and 8192 elements a row, merged by
   ``uniform_stream_merger``: every merged size is k, every count the
   total, no position twice in a row, the KS gate over the union stream,
   and each shard's share of the samples within 5 sigma of its share of the
   stream; four distinct shard engines (R=4096, k=256, one seed, so shared
   salts) fed 1, 2, 3 and 4 Zipf tiles, merged by
   ``distinct_stream_merger``: equal, entry for entry, to one engine run
   over all 10 tiles, and on rows 0..1023 to the exact oracle; four
   weighted shard engines (R=16384, k=64, their own seeds) fed 1, 2, 3 and
   4 tiles with weight ``pos % 3``, merged by ``weighted_stream_merger``:
   no zero-weight sample, the weight-2 share within 0.005 of 2/3; one
   gather launch a merger; and beside each merger, ``gather_parts`` on its four shards' own
   leaves (its launch shape) against the plain version, every rank's copy
   bit for bit, in a launch that the path's count leaves out;
19. merge timings as in 7: the all-gather at phase 18's uniform shape
   beside its bytes bound, its plain version and ``torch.stack`` of the
   packed blocks once a rank (the library yardstick; over NCCL only where
   there is more than one card), and one batched pairwise merge of each
   mode at its configuration's shape (host clock, synchronised; the
   uniform one, a second of host-launched tensor code, once);
20. bridge build: the host staging library built with g++ and loaded
   (``NativeStaging(...).available()``), with ``os.cpu_count()`` and the
   demux's thread count;
21. the stream bridge at full width, ``DeviceStreamBridge(SamplerConfig(
   k=128, R=65536, tile_size=2048), key=0)``: R x B x 3 random (stream,
   element) pairs through ``push_interleaved``, pipelined and serial, the
   launch count set to 0 before the pipelined run: both states
   bit-identical, each flush where the staging contract puts it (from the
   pairs' ranks in their rows), one ``algl_update`` a flush, equal to the
   card engine fed the same per-row streams in tiles of 1536, and rows
   0..1023 equal to the plain version on the CPU; ``algl_update`` timed on
   the second flush's ragged tile beside the same tile full; the weighted
   (R=16384, k=64, B=1024) and distinct (R=4096, k=256, B=1024, int32 and
   int64 Zipf keys) bridges journal their flushes, and the card engine fed
   the journaled tiles must reach the same state; ``DeviceSampler`` (R=1,
   B=2048, k=128) equals the engine on the same stream;
22. bridge timings at full width (host clock around a window that ends in
   ``drain_barrier()`` and ``torch.cuda.synchronize()``, after a warm
   pass): elem/s for (a) the random pairs, (b) a lockstep interleave, one
   full tile a step, (c) ``push_tile`` of host tiles, each with its stage
   table (demux, take, copy by CUDA events, dispatch, wait in reserve);
   the engine's rates from phase 7; the wire's ceiling, 4RB bytes over
   the copy's ms; and, from one ``torch.profiler`` window over feed (b),
   how much of the tile copies' time overlaps the demux of the next tile;
23. bridge recovery on the card: R=4096, B=1024, ``checkpoint_every=2``,
   dropped halfway; ``recover()`` and the rest of the stream from the
   durable watermark give the uninterrupted run's samples, bit for bit.

A phase's line ends with the seconds since the script started.

The line before the last is ``{"kernels": [...]}``, and the line before it
``{"bridge": {...}}`` (phases 20-23); the last line is
``{"ok": true, "device": {...}}``.  Without a card, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

R, K, B = 65536, 128, 2048
# the weighted path: bench.py's weighted configuration (BASELINE.md config 4)
WR, WK, WB = 16384, 64, 1024
ROWS_CPU = 1024
REPS = 11
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor float32
# FLOP/s; int32 ALU ops/s from the SM layout (64 INT32 lanes per SM x 132
# SMs x 1.98 GHz)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT32 = 64 * 132 * 1.98e9
# work per acceptance, counted from csrc/: four Threefry-2x32 blocks (~79
# integer ops each) plus the draw words, slot and gather index; log (x2),
# exp, log1p and the skip arithmetic in float32 (an FMA counted as 2)
INT_OPS_PER_ACCEPT = 330
FLOPS_PER_ACCEPT = 134
# state bytes per row and tile (count, nxt, log_w read and written, key
# read); per acceptance one 32-byte sector gathered, but no more than the
# tile, and one written, but each sample reaches memory once (rewrites stay
# in L2); a fill element is 4 bytes read and 4 written under the same caps
STATE_BYTES_PER_ROW = 28
SECTOR_BYTES = 32
# the weighted kernel, counted from csrc/weighted.cu: per weight lane the
# scan's adds and flushes and the ballots; per acceptance three Threefry
# blocks, the search ballots and the warp minimum, log twice, exp and two
# divisions; per filled slot two Threefry blocks, a log and a division
W_INT_OPS_PER_LANE = 4
W_FLOPS_PER_LANE = 16
W_INT_OPS_PER_ACCEPT = 320
W_FLOPS_PER_ACCEPT = 90
W_INT_OPS_PER_FILL = 175
W_FLOPS_PER_FILL = 28
# bytes: every weight read once (4 per lane), per row the lkeys read (4 k),
# count and xw read and written and the key read (24); one 32-byte sector
# of elements gathered per filled or accepted element, but no more than the
# element tile; one sector of samples and one of lkeys written per filled or
# accepted slot, but each slot reaches memory once (rewrites stay in L2)
W_STATE_BYTES_PER_ROW = 24
# the distinct path: bench.py's distinct configuration (BASELINE.md config 3)
DR, DK, DB = 4096, 256, 1024
# the bridge's recovery phase: tiles small enough that the journal costs
# seconds
RR, RB = 4096, 1024
# the distinct kernel, counted from csrc/distinct.cu and csrc/hashing.cuh:
# per lane the scramble (4 salt xors, 6 rounds of an add, fmix32's 3 shifts,
# 3 xors and 2 multiplies, and the Feistel xor) and the compare and ballot;
# per insertion a binary search (8 integer ops a step) and the shift of
# half the block on average (one move per word)
D_OPS_PER_LANE = 68
D_OPS_PER_SEARCH_STEP = 8
# bytes per row: the threshold entry read (8), size and count read and
# written (16), the salts read (16); a row that inserts reads and writes its
# block (12 bytes an entry narrow, 16 wide)
D_STATE_BYTES_PER_ROW = 40


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's line (it opens with ``[``) ends with the
    seconds since the script started, so the log shows where the run's
    time goes."""
    if msg.startswith("["):
        msg = f"{msg} | t+{time.perf_counter() - T_START:.1f} s"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# the compared fields of each state: words compared as integers, and floats
FIELDS = {
    "ReservoirState": (("samples", "count", "nxt"), ("log_w",)),
    "WeightedState": (("samples", "count"), ("lkeys", "xw")),
    "DistinctState": (("values", "value_hi", "hash_hi", "hash_lo", "size", "count"), ()),
}


def same(a, b) -> bool:
    words, floats = FIELDS[type(a).__name__]
    for f in words + floats:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(bits(x), bits(y))):
            return False
    return True


def max_abs_err(a, b) -> float:
    """Largest difference over the compared fields, as values (int fields
    and sample words as int64, float fields as float64); 0 when
    bit-identical."""
    words, floats = FIELDS[type(a).__name__]
    err = 0.0
    for f in words:
        if getattr(a, f) is None:
            continue
        x, y = bits(getattr(a, f)).long(), bits(getattr(b, f)).long()
        err = max(err, float((x - y).abs().max().item()))
    for f in floats:
        x, y = getattr(a, f).double(), getattr(b, f).double()
        both = torch.isfinite(x) & torch.isfinite(y)
        if both.any():
            err = max(err, float((x[both] - y[both]).abs().max().item()))
        if not torch.equal(bits(getattr(a, f))[~both], bits(getattr(b, f))[~both]):
            err = float("inf")
    return err


def clone(state, rows=None, device=None):
    sl = slice(None) if rows is None else slice(0, rows)
    return type(state)(*(None if t is None else t[sl].clone().to(device or t.device) for t in state))


def event_ms(fn, reps: int = REPS, setup=None, batch: int = 1) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``batch``
    back-to-back calls, each on its own ``setup()`` argument made before
    the first event, divided by ``batch``; the median over ``reps`` such
    runs after one warm-up.  Back-to-back launches keep the host's launch
    overhead out of a short kernel's time."""
    times = []
    for i in range(reps + 1):
        args = [setup() if setup is not None else None for _ in range(batch)]
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for arg in args:
            fn(arg)
        e1.record()
        torch.cuda.synchronize()
        if i:
            times.append(e0.elapsed_time(e1) / batch)
        del args
    return statistics.median(times)


def build_text(info: dict) -> str:
    """A kernel's build as its timing line shows it."""
    return (f"{info['registers']} registers, {info['local_bytes']} bytes local (spills), "
            f"{info['static_smem'] + info['dynamic_smem']} bytes shared a block, "
            f"{info['warps_per_sm']} resident warps an SM")


def bound_ms(accepts: int, fill_elems: int) -> tuple:
    """The uniform kernel's bound for a tile with ``accepts`` acceptances
    and ``fill_elems`` elements copied by the fill over all R rows."""
    moved = SECTOR_BYTES * accepts + 4 * fill_elems
    nbytes = R * STATE_BYTES_PER_ROW + min(moved, 4 * R * B) + min(moved, 4 * R * K)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(accepts * INT_OPS_PER_ACCEPT / PEAK_INT32, accepts * FLOPS_PER_ACCEPT / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weighted_bound_ms(accepts: int, fills: int, lanes: int) -> tuple:
    """The weighted kernel's bound for a tile of ``lanes`` weights with
    ``accepts`` acceptances and ``fills`` filled slots over all rows."""
    moved = accepts + fills
    gathered = min(SECTOR_BYTES * moved, 4 * lanes)
    written = min(2 * SECTOR_BYTES * moved, 8 * WR * WK)
    nbytes = 4 * lanes + WR * (4 * WK + W_STATE_BYTES_PER_ROW) + gathered + written
    t_bytes = nbytes / PEAK_BYTES
    int_ops = W_INT_OPS_PER_LANE * lanes + W_INT_OPS_PER_ACCEPT * accepts + W_INT_OPS_PER_FILL * fills
    flops = W_FLOPS_PER_LANE * lanes + W_FLOPS_PER_ACCEPT * accepts + W_FLOPS_PER_FILL * fills
    t_ops = max(int_ops / PEAK_INT32, flops / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bench_weights(elems: torch.Tensor) -> torch.Tensor:
    """bench.py's weighted tile weights, ``1 + 0.5 cos^2(elem * 1e-3)``."""
    return (1.0 + 0.5 * torch.cos(elems.float() * 1e-3) ** 2).contiguous()


def weight_tile(gen, rows: int, width: int, kind: str, dev) -> torch.Tensor:
    w = torch.exp(torch.randn((rows, width), generator=gen, device=dev))
    if kind == "zeros":
        w = torch.where(torch.rand((rows, width), generator=gen, device=dev) < 0.3, 0.0, w)
    elif kind == "subnormal":
        u = torch.rand((rows, width), generator=gen, device=dev)
        w = torch.where(u < 0.2, 1e-40, torch.where(u < 0.25, 1.4e-45, w))
    return w.float().contiguous()


def weighted_tile(gen, t: int, width: int, kind: str, dtype, dev):
    """Tile t of the weighted plan: elements ``t * WB + lane`` (as
    bench.py feeds them) for the benchmark's weights, random words
    otherwise; float32 samples get -0.0 and NaN payloads planted."""
    if kind == "bench":
        elems = t * WB + torch.arange(width, dtype=torch.int32, device=dev)[None, :].expand(WR, width)
        elems = elems.contiguous()
        weights = bench_weights(elems)
    else:
        elems = torch.randint(-(2**31), 2**31 - 1, (WR, width), dtype=torch.int32, device=dev,
                              generator=gen)
        weights = weight_tile(gen, WR, width, kind, dev)
    return (plant_bits(elems) if dtype == torch.float32 else elems), weights


def plant_bits(t: torch.Tensor) -> torch.Tensor:
    """An int32 tile, with -0.0 and NaN payloads planted in place (they must
    travel as bits), viewed as float32."""
    width = t.shape[1]
    t[::7, 0] = -(2**31)            # -0.0
    t[1::7, 1 % width] = 0x7FC00001  # quiet NaN with a payload
    t[2::7, 2 % width] = -1          # 0xFFFFFFFF, negative NaN
    t[3::11, width - 1] = 0x7F800001  # signalling NaN
    return t.view(torch.float32)


def random_tile(gen, width: int, dtype, dev) -> torch.Tensor:
    t = torch.randint(-(2**31), 2**31 - 1, (R, width), dtype=torch.int32, device=dev, generator=gen)
    return plant_bits(t) if dtype == torch.float32 else t


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "reservoir_tpu_torch", "csrc")):
        fail("run chip_smoke.py from a checkout of the repository (reservoir_tpu_torch/ is missing)")
    sys.path.insert(0, here)
    import reservoir_tpu_torch as rtt

    if not os.path.abspath(rtt.__file__).startswith(here + os.sep):
        fail(f"reservoir_tpu_torch was imported from {rtt.__file__}, not from this checkout")
    for name in list(sys.modules):
        if name == "jax" or name.startswith("jax.") or name == "reservoir_tpu" or name.startswith("reservoir_tpu."):
            fail(f"{name} was imported")
    from reservoir_tpu_torch import _build
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import fmath
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    kern._library()
    wkern._library()
    dkern._library()
    mkern._library()
    log(f"[2 build] csrc built and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version, full width
    gen = torch.Generator(device=dev)
    cpu_checks = []
    worst_err = 0.0
    plan = [(64, False, True), (B, False, True), (B, False, False), (B, False, False), (B, True, False)]
    # k = 100 as well: with a k that is not a power of two, dividing by k
    # and multiplying by its float32 reciprocal round differently
    for dtype, k in ((torch.int32, K), (torch.float32, K), (torch.int32, 100)):
        gen.manual_seed(11)
        state_k = plain.init(key_from_seed(7), R, k, sample_dtype=dtype, device=dev)
        start_cpu = clone(state_k, ROWS_CPU, "cpu")
        fed = []
        for width, ragged, fill in plan:
            tile = random_tile(gen, width, dtype, dev)
            valid = (
                torch.randint(0, width + 1, (R,), dtype=torch.int32, device=dev, generator=gen)
                if ragged else None
            )
            before = clone(state_k)
            ref = (plain.update if fill else plain.update_steady)(before, tile, valid)
            state_k = (kern.update_cuda if fill else kern.update_steady_cuda)(state_k, tile, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state_k, ref))
            if not same(state_k, ref):
                fail(f"kernel != plain version ({dtype}, k {k}, width {width}, ragged {ragged}, "
                     f"fill {fill})")
            fed.append((tile[:ROWS_CPU].cpu(), None if valid is None else valid[:ROWS_CPU].cpu(), fill))
            del ref, before
        log(f"[3 kernel vs plain] {dtype}, k {k}: {len(plan)} tiles (partial fill, fill crossing, "
            "2 steady, ragged) bit-identical")
        cpu_checks.append((f"{dtype}, k {k}", start_cpu, fed, clone(state_k, ROWS_CPU, "cpu")))

    # 4. fmath on the card
    grid = (torch.arange(1, 2**24 + 1, dtype=torch.float64, device=dev) * 2.0**-24).float()
    ranges = {
        "log": grid,
        "exp": torch.cat([
            -30.0 * torch.rand(2**22, generator=gen, device=dev),
            -86.5 - 2.0 * torch.rand(2**20, generator=gen, device=dev),
        ]),
        "log1p": torch.cat([
            -torch.rand(2**22, generator=gen, device=dev),
            -torch.exp(-100.0 * torch.rand(2**20, generator=gen, device=dev)),
        ]),
    }
    for name, x in ranges.items():
        got = kern.fmath_cuda(x, name)
        want = getattr(fmath, name)(x)
        bad = int((bits(got) != bits(want)).sum().item())
        if bad:
            fail(f"kernel {name} differs from the torch recipe on {bad} of {x.numel()} inputs")
        log(f"[4 fmath] kernel {name} == torch recipe on {x.numel()} inputs")
    del grid, ranges

    # 5. card vs CPU
    for case, state_c, fed, want in cpu_checks:
        for tile, valid, fill in fed:
            state_c = (plain.update if fill else plain.update_steady)(state_c, tile, valid)
        if not same(state_c, want):
            fail(f"CPU plain version != kernel on rows 0..{ROWS_CPU - 1} ({case})")
        log(f"[5 card vs CPU] {case}: rows 0..{ROWS_CPU - 1} bit-identical")
    del cpu_checks

    # 6. the engine path
    N = 10 * B
    rows = torch.arange(R, dtype=torch.int32, device=dev)[:, None] * N
    cols = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    dev_tiles = [rows + (t * B) + cols for t in range(8)]
    host_rows = np.arange(R, dtype=np.int32)[:, None] * N
    host_cols = np.arange(B, dtype=np.int32)[None, :]
    host_tiles = [host_rows + (t * B) + host_cols for t in (8, 9)]
    torch.cuda.synchronize()
    kern.launches = 0
    wkern.launches = 0
    engine = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tile in dev_tiles:
        engine.sample(tile)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tile in host_tiles:
        engine.sample(tile)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    samples, sizes = engine.result_arrays()
    main_launches = kern.launches
    if main_launches != 10 or wkern.launches != 0:
        fail(f"the engine launched algl_update {main_launches} times and weighted_update "
             f"{wkern.launches} times for 10 uniform tiles")
    if not (sizes == K).all():
        fail("not every reservoir holds k samples")
    row_of = samples // N
    pos = samples % N
    if not (row_of == np.arange(R)[:, None]).all():
        fail("a sample lies outside its row's stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a row sampled one position twice")
    ks = ks_one_sample_uniform(pos.ravel(), N)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of sampled positions is not below {KS_GATE}")
    dev_eps = 8 * R * B / t_dev
    host_eps = 2 * R * B / t_host
    log(f"[6 engine] 10 tiles, launches {main_launches}, sizes all {K}, KS {ks:.6f} < {KS_GATE}; "
        f"{dev_eps:.6e} elem/s fed from the device, {host_eps:.6e} elem/s fed from the host")
    del dev_tiles, host_tiles, engine

    # 7. timings at the main path's shapes
    (_, s0, fill_tile, _), (_, state, steady_tile, _), (deep_label, deep, deep_tile, _) = \
        uniform_timing_cases(gen, dev)
    fill_ms = event_ms(lambda s: kern.update_cuda(s, fill_tile), setup=lambda: clone(s0), batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = plain.update_accepts(clone(s0), fill_tile, fill=True)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fill_bound, fill_by = bound_ms(fill_accepts, R * K)
    del ref, fill_tile, s0
    steady_ms = event_ms(lambda s: kern.update_steady_cuda(s, steady_tile), setup=lambda: clone(state),
                         batch=10)
    plain_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, steady_accepts = plain.update_accepts(clone(state), steady_tile, fill=False)
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
    steady_plain_ms = statistics.median(plain_times)
    steady_bound, steady_by = bound_ms(steady_accepts, 0)
    deep_ms = event_ms(lambda s: kern.update_steady_cuda(s, deep_tile), setup=lambda: clone(deep), batch=10)
    _, deep_accepts = plain.update_accepts(clone(deep), deep_tile, fill=False)
    deep_bound, deep_by = bound_ms(deep_accepts, 0)
    del steady_tile, state, deep_tile, deep
    # where a host-fed tile's time goes: the engine's snapshot into pinned
    # memory (host clock), then the non-blocking copy to the card (events)
    host_tile = np.arange(R * B, dtype=np.int32).reshape(R, B)
    pinned = torch.empty((R, B), dtype=torch.int32, pin_memory=True)
    snap_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pinned.numpy()[...] = host_tile
        snap_times.append(1e3 * (time.perf_counter() - t0))
    snapshot_ms = statistics.median(snap_times)
    h2d_ms = event_ms(lambda _: pinned.to(dev, non_blocking=True))
    del pinned
    # the engine fed from the host once its pinned buffers are allocated
    warm = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=1)
    warm.sample(host_tile)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        warm.sample(host_tile)
    torch.cuda.synchronize()
    warm_host_eps = 4 * R * B / (time.perf_counter() - t0)
    del host_tile, warm
    card = card_line()
    build = kern.kernel_info()
    log(f"[7 timings] {card} | fill tile (count 0 -> {B}): kernel {fill_ms:.4f} ms, plain "
        f"{fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts {fill_accepts}; "
        f"build {build_text(build)}")
    log(f"[7 timings] {card} | steady tile (count {7 * B} -> {8 * B}): kernel {steady_ms:.4f} ms, "
        f"plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms ({steady_by}), "
        f"accepts {steady_accepts}")
    log(f"[7 timings] {card} | {deep_label}: kernel {deep_ms:.4f} ms, bound {deep_bound:.4f} ms "
        f"({deep_by}), accepts {deep_accepts}")
    log(f"[7 timings] {card} | engine: {dev_eps:.6e} elem/s fed from the device, "
        f"{host_eps:.6e} elem/s fed from the host")
    log(f"[7 timings] {card} | host tile of {4 * R * B} bytes: snapshot into pinned memory "
        f"{snapshot_ms:.2f} ms, copy to the card {h2d_ms:.2f} ms "
        f"({4 * R * B / h2d_ms / 1e6:.2f} GB/s); engine fed 4 more host tiles after a warm-up: "
        f"{warm_host_eps:.6e} elem/s")

    weighted = weighted_phases(gen, dev)
    distinct = distinct_phases(gen, dev)
    merge = merge_phases(gen, dev)
    bridge = bridge_phases(gen, dev, here, {"device_fed": dev_eps, "host_fed": host_eps,
                                            "host_fed_warm": warm_host_eps})

    card = card_line()
    log(card)
    log(json.dumps({"bridge": bridge}))
    log(json.dumps({"kernels": [{
        "name": "algl_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algorithm_l.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l_pallas.py:110",
        "launches": main_launches,
        "bridge_launches": bridge["launches"],
        "max_abs_err": worst_err,
        "ms": steady_ms,
        "plain_ms": steady_plain_ms,
        "bound_ms": steady_bound,
        "bound_by": steady_by,
        "library_ms": None,
        "fill_tile": {"ms": fill_ms, "plain_ms": fill_plain_ms, "bound_ms": fill_bound,
                      "bound_by": fill_by, "accepts": fill_accepts},
        "steady_accepts": steady_accepts,
        "deep_steady_tile": {"ms": deep_ms, "bound_ms": deep_bound, "bound_by": deep_by,
                             "accepts": deep_accepts},
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
        "host_tile_ms": {"snapshot": snapshot_ms, "h2d": h2d_ms},
        "warm_host_fed_elem_per_s": warm_host_eps,
        "build": build,
        "bridge_ragged_flush": bridge["ragged_flush"],
    }, weighted, distinct, merge]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def uniform_timing_cases(gen, dev) -> list:
    """Phase 7's tiles, each ``(label, state, tile, fill)``: random int32
    tiles at the main path's shape as the fill tile from count 0, the
    steady tile from count 7 B and a steady tile deep in the stream, from
    count 24 B, where a row expects ~5 accepts (``kernel_ab.py`` times the
    same)."""
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(23)
    s0 = plain.init(key_from_seed(0), R, K, device=dev)
    fill_tile = random_tile(gen, B, torch.int32, dev)
    state = kern.update_cuda(clone(s0), fill_tile)
    for _ in range(6):  # steady tiles 2..7: count reaches 7 * B
        kern.update_steady_cuda(state, random_tile(gen, B, torch.int32, dev))
    steady_tile = random_tile(gen, B, torch.int32, dev)
    deep = clone(state)
    for _ in range(17):  # tiles 8..24: count reaches 24 * B
        kern.update_steady_cuda(deep, random_tile(gen, B, torch.int32, dev))
    deep_tile = random_tile(gen, B, torch.int32, dev)
    return [(f"fill tile (count 0 -> {B})", s0, fill_tile, True),
            (f"steady tile (count {7 * B} -> {8 * B})", state, steady_tile, False),
            (f"steady tile deep in the stream (count {24 * B} -> {25 * B})", deep, deep_tile, False)]


def weighted_timing_cases(dev) -> list:
    """Phase 11's tiles, each ``(label, state, elems, weights)``: bench.py's
    tiles (elements ``t * WB + lane``, weights ``1 + 0.5 cos^2(elem *
    1e-3)``) as the fill tile from empty, the steady tile from count 7 B,
    and that tile with every weight 0 (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    def bench_tile(t):
        elems = (t * WB + torch.arange(WB, dtype=torch.int32, device=dev))[None, :].expand(WR, WB)
        elems = elems.contiguous()
        return elems, bench_weights(elems)

    s0 = wplain.init(key_from_seed(0), WR, WK, device=dev)
    fill_e, fill_w = bench_tile(0)
    state = wkern.update_cuda(clone(s0), fill_e, fill_w)
    for t in range(1, 7):  # tiles 1..6: count reaches 7 * B
        wkern.update_cuda(state, *bench_tile(t))
    steady_e, steady_w = bench_tile(7)
    return [("fill tile from empty", s0, fill_e, fill_w), ("steady tile (count 7B)", state, steady_e, steady_w),
            ("steady tile with every weight 0", state, steady_e, torch.zeros_like(steady_w))]


def weighted_phases(gen, dev) -> dict:
    """Phases 8-11, the weighted path; returns its ``kernels`` entry."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    # 8. weighted kernel vs plain version, full width
    plan = [(32, False, "lognormal"), (WB, False, "zeros"), (WB, False, "bench"),
            (WB, False, "bench"), (WB, True, "lognormal"), (WB, False, "subnormal")]
    worst_err = 0.0
    cpu_checks = []
    for dtype in (torch.int32, torch.float32):
        gen.manual_seed(31)
        state = wplain.init(key_from_seed(3), WR, WK, sample_dtype=dtype, device=dev)
        start_cpu = clone(state, ROWS_CPU, "cpu")
        fed = []
        for t, (width, ragged, kind) in enumerate(plan):
            elems, weights = weighted_tile(gen, t, width, kind, dtype, dev)
            valid = (torch.randint(0, width + 1, (WR,), dtype=torch.int32, device=dev, generator=gen)
                     if ragged else None)
            ref = wplain.update(clone(state), elems, weights, valid)
            state = wkern.update_cuda(state, elems, weights, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"weighted kernel != plain version ({dtype}, tile {t}: width {width}, {kind}, "
                     f"ragged {ragged})")
            fed.append((elems[:ROWS_CPU].cpu(), weights[:ROWS_CPU].cpu(),
                        None if valid is None else valid[:ROWS_CPU].cpu()))
            del ref
        filled = int((state.lkeys > float("-inf")).sum(1).min().item())
        if filled != WK:
            fail(f"a weighted reservoir holds {filled} < k keys after {len(plan)} tiles")
        log(f"[8 weighted kernel vs plain] {dtype}: {len(plan)} tiles (partial fill, fill end with "
            "zero weights, 2 steady with bench weights, ragged, subnormal) bit-identical")
        cpu_checks.append((f"{dtype}", start_cpu, fed, clone(state, ROWS_CPU, "cpu")))
        del state

    # 9. card vs CPU
    for case, state_c, fed, want in cpu_checks:
        for elems, weights, valid in fed:
            state_c = wplain.update(state_c, elems, weights, valid)
        if not same(state_c, want):
            fail(f"CPU plain weighted version != kernel on rows 0..{ROWS_CPU - 1} ({case})")
        log(f"[9 weighted card vs CPU] {case}: rows 0..{ROWS_CPU - 1} bit-identical")
    del cpu_checks

    # 10. the weighted engine path: element row * N + pos with weight pos % 3
    N = 10 * WB
    rows = torch.arange(WR, dtype=torch.int32, device=dev)[:, None] * N
    cols = torch.arange(WB, dtype=torch.int32, device=dev)[None, :]
    dev_tiles = [(rows + t * WB + cols, ((t * WB + cols) % 3).float().expand(WR, WB).contiguous())
                 for t in range(8)]
    host_rows = np.arange(WR, dtype=np.int32)[:, None] * N
    host_cols = np.arange(WB, dtype=np.int32)[None, :]
    host_tiles = [(host_rows + t * WB + host_cols,
                   np.broadcast_to(((t * WB + host_cols) % 3).astype(np.float32), (WR, WB)).copy())
                  for t in (8, 9)]
    torch.cuda.synchronize()
    kern.launches = 0
    wkern.launches = 0
    engine = rtt.ReservoirEngine(
        rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB, weighted=True), key=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tile, weights in dev_tiles:
        engine.sample(tile, weights=weights)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tile, weights in host_tiles:
        engine.sample(tile, weights=weights)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    samples, sizes = engine.result_arrays()
    launches = wkern.launches
    if launches != 10 or kern.launches != 0:
        fail(f"the weighted engine launched weighted_update {launches} times and algl_update "
             f"{kern.launches} times for 10 tiles")
    if not (sizes == WK).all():
        fail("not every weighted reservoir holds k samples")
    row_of = samples // N
    pos = samples % N
    if not (row_of == np.arange(WR)[:, None]).all():
        fail("a weighted sample lies outside its row's stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a weighted row sampled one position twice")
    cls = pos % 3
    if (cls == 0).any():
        fail(f"{int((cls == 0).sum())} zero-weight elements were sampled")
    share2 = float((cls == 2).mean())
    if abs(share2 - 2.0 / 3.0) > 0.005:
        fail(f"weight-2 share {share2:.6f} is not within 0.005 of 2/3")
    ks = ks_one_sample_uniform((pos[cls == 1] - 1) // 3, N // 3)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of weight-1 positions is not below {KS_GATE}")
    dev_eps = 8 * WR * WB / t_dev
    host_eps = 2 * WR * WB / t_host
    log(f"[10 weighted engine] 10 tiles, launches {launches}, sizes all {WK}, no zero-weight "
        f"sample, weight-2 share {share2:.6f} (2/3 +- 0.005), weight-1 KS {ks:.6f} < {KS_GATE}; "
        f"{dev_eps:.6e} elem/s fed from the device, {host_eps:.6e} elem/s fed from the host")
    del dev_tiles, host_tiles, engine

    # 11. timings at the weighted path's shapes (bench tiles)
    (_, s0, fill_e, fill_w), (_, state, steady_e, steady_w), (_, _, _, zero_w) = weighted_timing_cases(dev)
    fill_ms = event_ms(lambda s: wkern.update_cuda(s, fill_e, fill_w), setup=lambda: clone(s0),
                       batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = wplain.update_accepts(clone(s0), fill_e, fill_w)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fills = int((ref.lkeys > float("-inf")).sum().item())
    fill_bound, fill_by = weighted_bound_ms(fill_accepts, fills, WR * WB)
    del ref, fill_e, fill_w
    steady_ms = event_ms(lambda s: wkern.update_cuda(s, steady_e, steady_w),
                         setup=lambda: clone(state), batch=10)
    plain_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, steady_accepts = wplain.update_accepts(clone(state), steady_e, steady_w)
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
    steady_plain_ms = statistics.median(plain_times)
    steady_bound, steady_by = weighted_bound_ms(steady_accepts, 0, WR * WB)
    # the same tile with every weight 0: the scan and state traffic alone,
    # with no acceptance
    scan_ms = event_ms(lambda s: wkern.update_cuda(s, steady_e, zero_w), setup=lambda: clone(state),
                       batch=10)
    scan_bound, _ = weighted_bound_ms(0, 0, WR * WB)
    del state, steady_e, steady_w, zero_w
    build = wkern.kernel_info(WK)
    card = card_line()
    log(f"[11 weighted timings] {card} | fill tile (count 0 -> {WB}): kernel {fill_ms:.4f} ms, "
        f"plain {fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts "
        f"{fill_accepts}, fills {fills}")
    log(f"[11 weighted timings] {card} | steady tile (count {7 * WB} -> {8 * WB}): kernel "
        f"{steady_ms:.4f} ms, plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms "
        f"({steady_by}), accepts {steady_accepts}; the same tile with zero weights (no "
        f"acceptance) {scan_ms:.4f} ms, bound {scan_bound:.4f} ms (bytes); build {build_text(build)}")
    log(f"[11 weighted timings] {card} | engine: {dev_eps:.6e} elem/s fed from the device, "
        f"{host_eps:.6e} elem/s fed from the host")
    return {
        "name": "weighted_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/weighted.cu",
        "replaces": "reservoir_tpu/ops/weighted_pallas.py:95",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": steady_ms,
        "plain_ms": steady_plain_ms,
        "bound_ms": steady_bound,
        "bound_by": steady_by,
        "library_ms": None,
        "fill_tile": {"ms": fill_ms, "plain_ms": fill_plain_ms, "bound_ms": fill_bound,
                      "bound_by": fill_by, "accepts": fill_accepts, "fills": fills},
        "steady_accepts": steady_accepts,
        "steady_tile_zero_weights_ms": scan_ms,
        "steady_tile_zero_weights_bound_ms": scan_bound,
        "build": build,
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
    }


def distinct_bound_ms(lanes: int, wide: bool, inserts: int, rows_inserting: int) -> tuple:
    """The distinct kernel's bound for a tile of ``lanes`` keys over DR rows,
    with ``inserts`` entries new to the state over ``rows_inserting`` rows
    (the least inserts any order of candidates needs)."""
    planes = 4 if wide else 3
    nbytes = (8 if wide else 4) * lanes + DR * D_STATE_BYTES_PER_ROW + rows_inserting * 2 * DK * 4 * planes
    t_bytes = nbytes / PEAK_BYTES
    per_insert = D_OPS_PER_SEARCH_STEP * (DK.bit_length() - 1) + planes * DK // 2
    t_ops = (D_OPS_PER_LANE * lanes + per_insert * inserts) / PEAK_INT32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _hash_key(state) -> torch.Tensor:
    """A state's hashes as int64 in unsigned order (padding is the largest)."""
    hi = state.hash_hi.long() & 0xFFFFFFFF
    lo = state.hash_lo.long() & 0xFFFFFFFF
    return (hi - 2**31) * 2**32 + lo


def net_inserts(before, after) -> tuple:
    """``(entries of after not in before, rows with any)``: hashes identify
    keys, since the scramble is a permutation."""
    both = torch.sort(torch.cat([_hash_key(before), _hash_key(after)], 1), dim=1).values
    common = ((both[:, 1:] == both[:, :-1]) & (both[:, 1:] != 2**63 - 1)).sum(1)
    new = after.size.long() - common
    return int(new.sum().item()), int((new > 0).sum().item())


def zipf_keys(gen, rows: int, width: int, dtype, dev) -> torch.Tensor:
    """bench.py's distinct keys (``min(u ** -10, 1e7)``, u uniform on
    [1e-6, 1)); 8-byte keys are those times an odd 64-bit constant, which
    keeps which keys are equal and spreads them over both words."""
    u = torch.rand((rows, width), generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
    t = torch.clamp(u ** -10.0, max=1e7).to(torch.int64)
    return wide_or_narrow(t, dtype)


def wide_or_narrow(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int64:
        return (t * (0x9E3779B97F4A7C15 - 2**64)).contiguous()
    return t.to(torch.int32).view(dtype).contiguous()


def held_keys(state) -> torch.Tensor:
    """The state's keys as int64 (wide) or int32 words (narrow)."""
    lo = state.values.view(torch.int32)
    if state.value_hi is None:
        return lo
    return (state.value_hi.long() << 32) | (lo.long() & 0xFFFFFFFF)


def distinct_oracle(tiles, salts, samples, sizes) -> tuple:
    """Phase 14's exact host oracle, in numpy with the port's hashing: each
    row's k smallest scrambled hashes among its distinct keys (a hash of
    (MAX, MAX) is never taken).  Returns ``(ok, message, share of sampled
    keys seen >= 10 times, that share among all distinct keys)``."""
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import hashing

    def scrambled(keys):
        if keys.dtype.itemsize == 8:
            hi, lo = dplain.split_values_host(keys)
        else:
            hi, lo = hashing.default_hash64(keys)
        sh, sl = hashing.scramble64(hi, lo, salts[:, 0:1], salts[:, 1:2], salts[:, 2:3], salts[:, 3:4])
        return (sh.astype(np.uint64) << np.uint64(32)) | sl.astype(np.uint64)

    top = np.uint64(2**64 - 1)
    h = scrambled(np.concatenate(tiles, axis=1))
    h.sort(axis=1)
    rows, n = h.shape
    first = np.ones(h.shape, bool)
    first[:, 1:] = h[:, 1:] != h[:, :-1]
    first &= h != top
    rank = np.cumsum(first, axis=1)
    want_size = np.minimum(DK, rank[:, -1])
    if not (sizes == want_size).all():
        bad = int(np.flatnonzero(sizes != want_size)[0])
        return False, f"row {bad} holds {sizes[bad]} keys, min(k, #distinct) is {want_size[bad]}", 0, 0
    sel = first & (rank <= DK)
    want = np.full((rows, DK), top, np.uint64)
    r_idx, c_idx = np.nonzero(sel)
    want[r_idx, rank[r_idx, c_idx] - 1] = h[r_idx, c_idx]
    got = scrambled(samples)
    got[np.arange(DK)[None, :] >= sizes[:, None]] = top
    if not (got == want).all():
        bad = int(np.flatnonzero((got != want).any(1))[0])
        return False, f"row {bad} differs from the k smallest hashes of its distinct keys", 0, 0
    starts = np.flatnonzero(first.ravel())
    ends = np.append(starts[1:], rows * n)
    # a run ends where the next distinct key starts, or at its row's end
    ends = np.minimum(ends, (starts // n + 1) * n)
    heavy = (ends - starts) >= 10
    sampled = sel.ravel()[starts]
    return True, "", float(heavy[sampled].mean()), float(heavy.mean())


def distinct_timing_cases(gen, dev) -> list:
    """Phase 15's tiles in its order, each ``(label, state, tile, wide)``:
    Zipf tiles from empty and after 8 Zipf tiles, and fresh random keys
    after 8, with int32 and int64 keys (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(47)
    s0 = dplain.init(key_from_seed(0), DR, DK, device=dev)
    cases = [("Zipf tile from empty (int32)", s0, zipf_keys(gen, DR, DB, torch.int32, dev), False)]
    state = clone(s0)
    for _ in range(8):
        state = dkern.update_cuda(state, zipf_keys(gen, DR, DB, torch.int32, dev))
    cases.append(("steady Zipf tile after 8 (int32)", state, zipf_keys(gen, DR, DB, torch.int32, dev), False))
    cases.append(("steady tile of fresh random keys after 8 Zipf (int32)", state,
                  torch.randint(-(2**31), 2**31 - 1, (DR, DB), dtype=torch.int32, device=dev, generator=gen),
                  False))
    ws0 = dplain.init(key_from_seed(0), DR, DK, sample_dtype=torch.int64, device=dev)
    ws = clone(ws0)
    for _ in range(8):
        ws = dkern.update_cuda(ws, zipf_keys(gen, DR, DB, torch.int64, dev))
    cases.append(("steady Zipf tile after 8 (int64)", ws, zipf_keys(gen, DR, DB, torch.int64, dev), True))
    cases.append(("Zipf tile from empty (int64)", ws0, zipf_keys(gen, DR, DB, torch.int64, dev), True))
    return cases


def distinct_phases(gen, dev) -> dict:
    """Phases 12-15, the distinct path; returns its ``kernels`` entry."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.convert import distinct_state_from_numpy, distinct_state_to_numpy
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.hashing import salt_for_target
    from reservoir_tpu_torch.ops.rng import key_from_seed

    # 12. distinct kernel vs plain version, full width
    plant_rows = torch.arange(0, DR, 97)
    worst_err = 0.0
    cpu_checks = []
    plan = [("partial", 64, False), ("fill end", DB, False), ("zipf", DB, False), ("zipf", DB, False),
            ("zipf", DB, False), ("one value", DB, False), ("held", DB, False), ("negative", DB, False),
            ("ragged", DB, True)]
    for dtype in (torch.int32, torch.uint32, torch.int64):
        gen.manual_seed(41)
        wide = dtype == torch.int64
        plant = (0x01234567, 0x89ABCDEF) if wide else (0, 123456789)
        plant_key = (plant[0] << 32) | plant[1]
        host = distinct_state_to_numpy(dplain.init(key_from_seed(4), DR, DK, sample_dtype=dtype))
        salts = host["salts"].copy()
        for r in plant_rows.tolist():
            salts[r, 2:] = salt_for_target(plant, (0xFFFFFFFF, 0xFFFFFFFF), tuple(int(x) for x in salts[r, :2]))
        host["salts"] = salts
        state = distinct_state_from_numpy(**host, device=dev)
        start_cpu = clone(state, ROWS_CPU, "cpu")
        fed = []
        for t, (kind, width, ragged) in enumerate(plan):
            if kind in ("partial", "fill end"):
                tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (DR, width), generator=gen, device=dev),
                                      dtype)
            elif kind == "one value":
                tile = wide_or_narrow(torch.full((DR, width), -77777, dtype=torch.int64, device=dev), dtype)
            elif kind == "held":
                tile = held_keys(state).repeat(1, DB // DK).contiguous()
                tile = tile.view(dtype) if not wide else tile
            elif kind == "negative":
                tile = -torch.randint(1, 2**62 if wide else 2**31, (DR, width), generator=gen, device=dev)
                tile = tile if wide else tile.to(torch.int32).view(dtype).contiguous()
            else:
                tile = zipf_keys(gen, DR, width, dtype, dev)
            if kind in ("partial", "ragged"):
                key = plant_key if wide else plant[1]
                tile.view(torch.int64 if wide else torch.int32)[:, 5] = key
            valid = None
            if ragged:
                valid = torch.randint(0, width + 1, (DR,), dtype=torch.int32, device=dev, generator=gen)
                valid[:2] = torch.tensor([0, width], dtype=torch.int32, device=dev)
            batch = tile
            if wide and kind == "fill end":  # an 8-byte tile as its (hi, lo) planes
                w = tile.view(torch.int32).view(DR, width, 2)
                batch = (w[..., 1].contiguous(), w[..., 0].contiguous())
            ref = dplain.update(clone(state), tile, valid)
            state = dkern.update_cuda(state, batch, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"distinct kernel != plain version ({dtype}, tile {t}: {kind}, width {width})")
            fed.append((tile[:ROWS_CPU].cpu(), None if valid is None else valid[:ROWS_CPU].cpu()))
            del ref
        held = held_keys(state)
        planted = (held[plant_rows] == (plant_key if wide else plant[1])).any().item()
        if planted:
            fail(f"a row whose salts send the planted key to (MAX, MAX) holds it ({dtype})")
        elsewhere = int((held == (plant_key if wide else plant[1])).any(1).sum().item())
        if int(state.size.min().item()) != DK:
            fail(f"a distinct reservoir holds fewer than k keys after {len(plan)} tiles ({dtype})")
        log(f"[12 distinct kernel vs plain] {dtype}: {len(plan)} tiles (partial, fill end, 3 Zipf, one "
            f"value, held, negative, ragged) bit-identical; the planted key is held by no planted row "
            f"and by {elsewhere} of the others")
        cpu_checks.append((f"{dtype}", start_cpu, fed, clone(state, ROWS_CPU, "cpu")))
        del state
    # beyond shared memory: the first k whose row block passes a block's
    # shared memory runs the instantiation that keeps it in global memory
    for dtype, k_big in ((torch.int32, 19371), (torch.int64, 14529)):
        wide = dtype == torch.int64
        if dkern.kernel_info(k_big, wide)["dynamic_smem"] != 0:
            fail(f"the distinct kernel at k {k_big} ({dtype}) reports a block in shared memory")
        state = dplain.init(key_from_seed(5), 8, k_big, sample_dtype=dtype, device=dev)
        for t in range(2):
            tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (8, 12288), generator=gen, device=dev), dtype)
            ref = dplain.update(clone(state), tile)
            state = dkern.update_cuda(state, tile)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"distinct kernel != plain version beyond shared memory ({dtype}, k {k_big}, tile {t})")
        if int(state.size.min().item()) != k_big:
            fail(f"a distinct reservoir at k {k_big} ({dtype}) holds fewer than k keys after 2 tiles")
        log(f"[12 distinct kernel vs plain] {dtype}, k {k_big} (beyond shared memory, R 8): 2 tiles "
            "(fill, evict) bit-identical")
        del state, ref

    # 13. card vs CPU
    for case, state_c, fed, want in cpu_checks:
        for tile, valid in fed:
            state_c = dplain.update(state_c, tile, valid)
        if not same(state_c, want):
            fail(f"CPU plain distinct version != kernel on rows 0..{ROWS_CPU - 1} ({case})")
        log(f"[13 distinct card vs CPU] {case}: rows 0..{ROWS_CPU - 1} bit-identical")
    del cpu_checks

    # 14. the distinct engine path, 4-byte and 8-byte keys
    rates = {}
    main_launches = 0
    for name, dtype in (("int32", torch.int32), ("int64", torch.int64)):
        gen.manual_seed(43)
        dev_tiles = [zipf_keys(gen, DR, DB, dtype, dev) for _ in range(8)]
        host_tiles = [zipf_keys(gen, DR, DB, dtype, dev).cpu().numpy() for _ in range(2)]
        torch.cuda.synchronize()
        kern.launches = 0
        wkern.launches = 0
        dkern.launches = 0
        engine = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB,
                                                       distinct=True, element_dtype=name), key=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tile in dev_tiles:
            engine.sample(tile)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        for tile in host_tiles:
            engine.sample(tile)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        salts = distinct_state_to_numpy(engine.state)["salts"]
        samples, sizes = engine.result_arrays()
        launches = dkern.launches
        if launches != 10 or kern.launches or wkern.launches:
            fail(f"the distinct engine ({name}) launched distinct_update {launches} times, algl_update "
                 f"{kern.launches} and weighted_update {wkern.launches} times for 10 tiles")
        main_launches += launches
        tiles = [t.cpu().numpy() for t in dev_tiles] + host_tiles
        ok, msg, share_sampled, share_all = distinct_oracle(tiles, salts, samples, sizes)
        if not ok:
            fail(f"distinct engine ({name}): {msg}")
        if abs(share_sampled - share_all) > 0.01:
            fail(f"distinct engine ({name}): the share of sampled keys seen >= 10 times, "
                 f"{share_sampled:.6f}, is not within 0.01 of their share of distinct keys, {share_all:.6f}")
        rates[name] = {"device_fed": 8 * DR * DB / t_dev, "host_fed": 2 * DR * DB / t_host}
        log(f"[14 distinct engine] {name}: 10 tiles, launches {launches}, every row equals the exact "
            f"oracle, sizes {int(sizes.min())}..{int(sizes.max())}; keys seen >= 10 times: "
            f"{share_sampled:.6f} of the sample, {share_all:.6f} of the distinct keys; "
            f"{rates[name]['device_fed']:.6e} elem/s fed from the device, "
            f"{rates[name]['host_fed']:.6e} elem/s fed from the host")
        del dev_tiles, host_tiles, tiles, engine

    # 15. timings at the distinct path's shapes
    def timed(state, tile, wide=False) -> dict:
        ms = event_ms(lambda s: dkern.update_cuda(s, tile), setup=lambda: clone(state), batch=10)
        plain_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = dplain.update(state, tile)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
        inserts, rows_in = net_inserts(state, ref)
        bound, by = distinct_bound_ms(tile.shape[0] * tile.shape[1], wide, inserts, rows_in)
        return {"ms": ms, "plain_ms": statistics.median(plain_times), "bound_ms": bound, "bound_by": by,
                "net_inserts": inserts, "rows_inserting": rows_in}

    cases = distinct_timing_cases(gen, dev)
    timings = {label: timed(state, tile, wide) for label, state, tile, wide in cases}
    fill, steady, fresh, steady_wide, fill_wide = (timings[label] for label, *_ in cases)
    # context only: a sort of the [R, k + B] packed hashes, not the same function
    packed = torch.randint(-(2**62), 2**62, (DR, DK + DB), device=dev, generator=gen)
    sort_ms = event_ms(lambda _: torch.sort(packed, dim=1), batch=10)
    del cases, packed
    card = card_line()
    builds = {"int32": dkern.kernel_info(DK, False), "int64": dkern.kernel_info(DK, True)}
    for label, t in timings.items():
        log(f"[15 distinct timings] {card} | {label}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), net inserts {t['net_inserts']} over "
            f"{t['rows_inserting']} rows; build {build_text(builds['int64' if 'int64' in label else 'int32'])}")
    log(f"[15 distinct timings] {card} | context, not the same function: torch.sort of [{DR}, {DK + DB}] "
        f"int64 {sort_ms:.4f} ms")
    log(f"[15 distinct timings] {card} | engine: int32 {rates['int32']['device_fed']:.6e} / "
        f"{rates['int32']['host_fed']:.6e} elem/s, int64 {rates['int64']['device_fed']:.6e} / "
        f"{rates['int64']['host_fed']:.6e} elem/s (fed from the device / the host)")
    return {
        "name": "distinct_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/distinct.cu",
        "replaces": "reservoir_tpu/ops/distinct_pallas.py:129",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": steady["ms"],
        "plain_ms": steady["plain_ms"],
        "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a deduplicating bottom-k merge",
        "sort_context_ms": sort_ms,
        "steady_zipf_tile": steady,
        "fill_tile": fill,
        "steady_fresh_tile": fresh,
        "steady_zipf_tile_int64": steady_wide,
        "fill_tile_int64": fill_wide,
        "build": builds,
        "engine_elem_per_s": rates,
    }


def word_blocks(gen, d: int, b: int, w: int, dtype, dev) -> list:
    """d ``[b, w]`` blocks of random 32-bit words of ``dtype``, with -0.0 and
    NaN payloads planted."""
    blocks = []
    for _ in range(d):
        t = torch.randint(-(2**31), 2**31 - 1, (b, w), dtype=torch.int32, device=dev, generator=gen)
        t[0, 0] = -(2**31)              # -0.0
        t[b // 2, w // 2] = 0x7FC00001  # quiet NaN with a payload
        t[-1, -1] = 0x7F800001          # signalling NaN
        blocks.append(t.view(dtype))
    return blocks


def words_err(got, want) -> float:
    """Largest difference between two nests of tensors, word for word as
    integers; 0 when bit-identical."""
    err = 0.0
    for g_rank, w_rank in zip(got, want):
        for g, w in zip(g_rank, w_rank):
            if g.shape != w.shape or g.dtype != w.dtype:
                return float("inf")
            err = max(err, float((bits(g).long() - bits(w).long()).abs().max().item()))
    return err


def merge_phases(gen, dev) -> dict:
    """Phases 16-19, the merge path; returns its ``kernels`` entry."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.convert import distinct_state_to_numpy, state_parts
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.parallel import merge as pmerge
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    # 16. the all-gather kernel vs its plain version
    worst_err = 0.0

    def held(got, want, what: str) -> None:
        nonlocal worst_err
        err = words_err(got, want)
        worst_err = max(worst_err, err)
        if err != 0.0:
            fail(f"all-gather kernel != plain version ({what})")

    def gather_cases(ranks_of, where: str) -> None:
        gen.manual_seed(61)
        cases = 0
        for d in (2, 3, 4, 8):
            comm = mkern.RingCommunicator(ranks_of(d))
            before = mkern.launches
            calls = 0
            for b in (1, 5, 64, 4096):
                for w in (1, 8, 129):
                    for dtype in (torch.int32, torch.uint32, torch.float32):
                        for _ in range(2):  # back to back on one communicator
                            blocks = [blk.to(rank) for blk, rank in
                                      zip(word_blocks(gen, d, b, w, dtype, dev), comm.ranks)]
                            got = mkern.ring_all_gather(blocks, comm)
                            want = mkern.ring_all_gather_plain(blocks, comm)
                            if any(g.shape != (d, b, w) for g in got):
                                fail(f"ring_all_gather gave a wrong shape (d {d}, b {b}, W {w})")
                            held([got], [want], f"{where}, d {d}, b {b}, W {w}, {dtype}")
                            calls += 1
            # mixed leaves of one part state: float rows, int counts, uint salts
            rank_leaves = [
                (word_blocks(gen, 1, 7, 5, torch.float32, dev)[0].to(rank),
                 torch.randint(0, 99, (7,), dtype=torch.int32, device=dev, generator=gen).to(rank),
                 word_blocks(gen, 1, 7, 4, torch.uint32, dev)[0].to(rank))
                for rank in comm.ranks
            ]
            held(mkern.gather_parts(rank_leaves, comm), mkern.gather_parts_plain(rank_leaves, comm),
                 f"{where}, gather_parts, d {d}")
            calls += 1
            torch.cuda.synchronize()
            comm.check()
            per_call = len({r.index for r in comm.ranks})
            if mkern.launches - before != calls * per_call:
                fail(f"{calls} all-gathers over {per_call} cards counted {mkern.launches - before} launches")
            cases += calls
        log(f"[16 all-gather vs plain] {where}: d 2/3/4/8 x b 1/5/64/4096 x W 1/8/129 x int32/uint32/"
            f"float32, twice each on one communicator, and gather_parts on mixed leaves: {cases} calls, "
            "every rank's copy bit-identical")

    gather_cases(lambda d: [dev] * d, "ranks on one card")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        gather_cases(lambda d: [torch.device("cuda", i % n_cards) for i in range(d)],
                     f"ranks over {n_cards} cards")
    else:
        log("[16 all-gather vs plain] this machine has one card: every rank above is on it; the "
            "path with ranks on distinct cards (peer access over NVLink) was not run")
    # the main path's shape: 4 ranks of uniform state
    D = 4
    gen.manual_seed(67)
    full_leaves = [(random_tile(gen, K, torch.int32, dev),
                    torch.randint(0, 2**31 - 1, (R,), dtype=torch.int32, device=dev, generator=gen))
                   for _ in range(D)]
    full_comm = mkern.RingCommunicator([dev] * D)
    held(mkern.gather_parts(full_leaves, full_comm), mkern.gather_parts_plain(full_leaves, full_comm),
         "the main path's shape")
    full_comm.check()
    log(f"[16 all-gather vs plain] gather_parts at the main path's shape ({D} ranks of [{R}, {K}] "
        f"samples and [{R}] counts): every rank's copy bit-identical")

    # 17. the merge tree on the card == the same on the CPU
    k17 = 16
    rng = np.random.default_rng(71)
    for n_parts in (2, 3, 5, 8):
        uniform_parts = []
        for p in range(n_parts):
            n = int(rng.integers(1, k17)) if p % 2 else int(rng.integers(k17, 4 * k17))
            uniform_parts.append((rng.integers(0, 1 << 30, min(n, k17)).astype(np.int32), n))
        by_mode = {"uniform": uniform_parts}
        for mode in ("weighted", "distinct"):
            cfg = rtt.SamplerConfig(max_sample_size=k17, num_reservoirs=n_parts, tile_size=64,
                                    weighted=mode == "weighted", distinct=mode == "distinct")
            eng = rtt.ReservoirEngine(cfg, key=2, device="cpu")
            tile = rng.integers(0, 60, (n_parts, 64)).astype(np.int32)
            valid = rng.integers(1, 65, n_parts).astype(np.int32)  # some rows stay short of k
            if mode == "weighted":
                eng.sample(tile, valid, weights=rng.uniform(0.0, 2.0, (n_parts, 64)).astype(np.float32))
            else:
                eng.sample(tile, valid)
            parts = state_parts(eng.state)
            if mode == "distinct":  # shards of one logical stream share salts
                parts = [part[:5] + (parts[0][5],) for part in parts]
            by_mode[mode] = parts
        for mode, parts in by_mode.items():
            want = pmerge.merge_samples_device(parts, 9, max_sample_size=k17, mode=mode, impl="host")
            got = pmerge.merge_samples_device(parts, 9, max_sample_size=k17, mode=mode, impl="cuda",
                                              devices=[dev] * 4)
            for g, w in zip(got, want):
                # arrays word for word (NaN-safe), totals and sizes as ints
                g, w = np.atleast_1d(g), np.atleast_1d(w)
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    fail(f"merge tree on the card != on the CPU ({mode}, {n_parts} parts)")
    log("[17 merge tree card vs CPU] merge_samples_device, uniform/weighted/distinct x 2/3/5/8 parts "
        "with partial fills: 4 ranks on the card equal the host tree")
    shards, rows17 = 5, 256
    gen.manual_seed(73)
    u_s = [torch.randint(0, 2**31 - 1, (rows17, k17), dtype=torch.int32, device=dev, generator=gen)
           for _ in range(shards)]
    u_c = [torch.randint(0, 3 * k17, (rows17,), dtype=torch.int32, device=dev, generator=gen)
           for _ in range(shards)]
    w_states, d_states = [], []
    for s in range(shards):
        elems = torch.randint(0, 200, (rows17, 64), dtype=torch.int32, device=dev, generator=gen)
        weights = torch.rand((rows17, 64), device=dev, generator=gen)
        valid = torch.randint(1, 65, (rows17,), dtype=torch.int32, device=dev, generator=gen)
        w_states.append(wkern.update_cuda(wplain.init(key_from_seed(s), rows17, k17, device=dev),
                                          elems, weights, valid))
        d_states.append(dkern.update_cuda(dplain.init(key_from_seed(0), rows17, k17, device=dev),
                                          elems, valid))

    def on_cpu(leaves):
        return [[t.cpu() for t in leaf] for leaf in leaves]

    w_leaves = [[st.samples for st in w_states], [st.lkeys for st in w_states],
                [st.count for st in w_states]]
    d_leaves = [[getattr(st, f) for st in d_states]
                for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts")]
    for mode, fn, leaves in (
        ("uniform", lambda lv: pmerge.uniform_stream_merger(lv[0], lv[1], 11), [u_s, u_c]),
        ("weighted", lambda lv: pmerge.weighted_stream_merger(*lv), w_leaves),
        ("distinct", lambda lv: pmerge.distinct_stream_merger(*lv), d_leaves),
    ):
        got = fn(leaves)
        want = fn(on_cpu(leaves))
        if words_err([[g.cpu() for g in got]], [want]) != 0.0:
            fail(f"{mode}_stream_merger on the card != on the CPU ({shards} shards of {rows17} rows)")
    log(f"[17 merge tree card vs CPU] the three stream mergers over {shards} shards of {rows17} rows: "
        "the card's rows equal the CPU's")
    del u_s, u_c, w_states, d_states, w_leaves, d_leaves

    # 18. the merge path at full width
    def hold_path_gather(stacked, what: str) -> None:
        """The all-gather as a merger launches it, on the shards' own leaves
        (``stacked[i][r]`` is leaf i of rank r): every rank's copy of the
        kernel's result against the plain version's, bit for bit.  This
        comparison's launch is not the path's: the count is put back."""
        counted = mkern.launches
        rank_leaves = [tuple(leaf[r].contiguous() for leaf in stacked) for r in range(len(stacked[0]))]
        comm = mkern.RingCommunicator([dev] * len(rank_leaves))
        got = mkern.gather_parts(rank_leaves, comm)
        comm.check()
        if mkern.launches != counted + 1:
            fail(f"gather_parts counted {mkern.launches - counted} launches for one call ({what})")
        held(got, mkern.gather_parts_plain(rank_leaves, comm), what)
        mkern.launches = counted

    for mod in (kern, wkern, dkern, mkern):
        mod.launches = 0
    # uniform: four shards of unequal streams; an element is its position in
    # the union stream of its row
    lengths = [1000, 2 * B, 3 * B, 4 * B]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    N = int(offsets[-1])
    cols = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    zero_rows = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    engines = []
    t0 = time.perf_counter()
    for s, length in enumerate(lengths):
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B),
                                  key=100 + s, reusable=True)
        for start in range(0, length, B):
            width = min(B, length - start)
            tile = (zero_rows + int(offsets[s]) + start + cols).contiguous()
            eng.sample(tile, None if width == B else np.full((R,), width, np.int32))
        engines.append(eng)
    states = [eng.state for eng in engines]
    torch.cuda.synchronize()
    t_feed = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_samples, m_count = pmerge.uniform_stream_merger(
        [st.samples for st in states], [st.count for st in states], 5)
    torch.cuda.synchronize()
    t_merge_uniform = time.perf_counter() - t0
    tiles_fed = sum(-(-length // B) for length in lengths)
    if kern.launches != tiles_fed or mkern.launches != 1:
        fail(f"the uniform merge path launched algl_update {kern.launches} times for {tiles_fed} tiles "
             f"and merge_ring_gather {mkern.launches} times for one merge")
    pos = m_samples.cpu().numpy()
    count = m_count.cpu().numpy()
    if count.dtype != np.uint32 or not (count == N).all():
        fail(f"a merged count is not the union stream's length {N}")
    if pos.min() < 0 or pos.max() >= N:
        fail("a merged sample lies outside the union stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a merged row holds one position twice")
    ks = ks_one_sample_uniform(pos.ravel(), N)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of the merged positions is not below {KS_GATE}")
    shares = []
    for s, length in enumerate(lengths):
        share = float(((pos >= offsets[s]) & (pos < offsets[s + 1])).mean())
        p = length / N
        sigma = (p * (1 - p) / pos.size) ** 0.5
        if abs(share - p) > 5 * sigma:
            fail(f"shard {s} holds {share:.6f} of the merged samples, its stream share is {p:.6f} "
                 f"(5 sigma = {5 * sigma:.6f})")
        shares.append(f"{share:.6f} of {p:.6f}")
    log(f"[18 merge path] uniform: 4 shards of {lengths} elements a row, {kern.launches} tile launches and "
        f"{mkern.launches} gather launch; every merged size {K}, every count {N}, KS {ks:.6f} < {KS_GATE}, "
        f"shard shares {', '.join(shares)} (each within 5 sigma); fed in {t_feed:.3f} s, merged in "
        f"{t_merge_uniform:.3f} s")
    uniform_launches = mkern.launches
    hold_path_gather([[st.samples for st in states], [st.count for st in states]],
                     "the uniform merger's shards")
    del engines, states, m_samples, m_count, pos, srt

    # distinct: four shards with shared salts == one engine over the whole stream
    gen.manual_seed(79)
    tiles = [zipf_keys(gen, DR, DB, torch.int32, dev) for _ in range(10)]
    dcfg = rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB, distinct=True,
                             element_dtype="int32")
    whole = rtt.ReservoirEngine(dcfg, key=0, reusable=True)
    for tile in tiles:
        whole.sample(tile)
    shard_states = []
    nxt = 0
    for n_tiles in (1, 2, 3, 4):
        eng = rtt.ReservoirEngine(dcfg, key=0, reusable=True)
        for tile in tiles[nxt:nxt + n_tiles]:
            eng.sample(tile)
        nxt += n_tiles
        shard_states.append(eng.state)
    d_stacked = [[getattr(st, f) for st in shard_states]
                 for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts")]
    t0 = time.perf_counter()
    merged = pmerge.distinct_stream_merger(*d_stacked)
    torch.cuda.synchronize()
    t_merge_distinct = time.perf_counter() - t0
    if dkern.launches != 20 or mkern.launches != uniform_launches + 1:
        fail(f"the distinct merge path launched distinct_update {dkern.launches} times for 20 tiles and "
             f"merge_ring_gather {mkern.launches - uniform_launches} times for one merge")
    hold_path_gather(d_stacked, "the distinct merger's shards")
    want = whole.state
    for name, got in zip(("values", "hash_hi", "hash_lo", "size", "count"), merged):
        if not torch.equal(bits(got), bits(getattr(want, name))):
            fail(f"the merge of four distinct shards differs from one engine over the stream in {name}")
    salts = distinct_state_to_numpy(want)["salts"]
    # the oracle over rows 0..ROWS_CPU-1 (phase 14 holds the engine to it on
    # every row, and every merged row equals that engine's above)
    ok, msg, _, _ = distinct_oracle([t[:ROWS_CPU].cpu().numpy() for t in tiles], salts[:ROWS_CPU],
                                    merged[0][:ROWS_CPU].cpu().numpy(), merged[3][:ROWS_CPU].cpu().numpy())
    if not ok:
        fail(f"merged distinct shards: {msg}")
    log(f"[18 merge path] distinct: 4 shards of 1/2/3/4 Zipf tiles with shared salts, merged in "
        f"{t_merge_distinct:.3f} s: equal entry for entry to one engine over all 10 tiles, and on rows "
        f"0..{ROWS_CPU - 1} to the exact oracle; sizes {int(merged[3].min())}..{int(merged[3].max())}")
    del tiles, whole, shard_states, d_stacked, merged, want

    # weighted: element = position in the union stream, weight = position % 3
    wlengths = [WB, 2 * WB, 3 * WB, 4 * WB]
    woffsets = np.concatenate([[0], np.cumsum(wlengths)])
    wcols = torch.arange(WB, dtype=torch.int32, device=dev)[None, :]
    wzero = torch.zeros((WR, 1), dtype=torch.int32, device=dev)
    w_states = []
    for s, length in enumerate(wlengths):
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB,
                                                    weighted=True), key=200 + s, reusable=True)
        for start in range(0, length, WB):
            tile = (wzero + int(woffsets[s]) + start + wcols).contiguous()
            eng.sample(tile, weights=(tile % 3).float())
        w_states.append(eng.state)
    w_stacked = [[st.samples for st in w_states], [st.lkeys for st in w_states],
                 [st.count for st in w_states]]
    t0 = time.perf_counter()
    w_samples, w_lkeys, w_count = pmerge.weighted_stream_merger(*w_stacked)
    torch.cuda.synchronize()
    t_merge_weighted = time.perf_counter() - t0
    if wkern.launches != 10 or mkern.launches != uniform_launches + 2:
        fail(f"the weighted merge path launched weighted_update {wkern.launches} times for 10 tiles and "
             f"merge_ring_gather {mkern.launches - uniform_launches - 1} times for one merge")
    main_launches = mkern.launches
    hold_path_gather(w_stacked, "the weighted merger's shards")
    wpos = w_samples.cpu().numpy()
    if not bool((w_lkeys > float("-inf")).all().item()) or not bool((w_count == int(woffsets[-1])).all().item()):
        fail("a merged weighted reservoir is not full, or its count is not the union stream's length")
    if (wpos % 3 == 0).any():
        fail(f"{int((wpos % 3 == 0).sum())} zero-weight elements are in the merged weighted sample")
    share2 = float((wpos % 3 == 2).mean())
    if abs(share2 - 2.0 / 3.0) > 0.005:
        fail(f"merged weight-2 share {share2:.6f} is not within 0.005 of 2/3")
    log(f"[18 merge path] weighted: 4 shards of 1/2/3/4 tiles, merged in {t_merge_weighted:.3f} s: every "
        f"reservoir full, no zero-weight sample, weight-2 share {share2:.6f} (2/3 +- 0.005); "
        f"{main_launches} gather launches for the three mergers")
    log(f"[18 merge path] the all-gather at each merger's launch shape, on its four shards' own leaves "
        f"(uniform [{R}, {K}] + [{R}]; distinct 3 x [{DR}, {DK}] + 2 x [{DR}] + [{DR}, 4]; weighted "
        f"2 x [{WR}, {WK}] + [{WR}]): every rank's copy bit-identical to the plain version's")
    del w_states, w_stacked, w_samples, w_lkeys, w_count

    # 19. timings at the uniform merge's shape
    def gather_bound_ms(d: int, words: int) -> float:
        """Every input word read once, every output word written once."""
        return 1e3 * (d + d * d) * words * 4 / PEAK_BYTES

    words = R * K + R
    gather_ms = event_ms(lambda _: mkern.gather_parts(full_leaves, full_comm), batch=10)
    full_comm.check()
    plain_ms = event_ms(lambda _: mkern.gather_parts_plain(full_leaves, full_comm), batch=10)
    packed = [torch.cat([s, c[:, None]], 1) for s, c in full_leaves]
    library_ms = event_ms(lambda _: [torch.stack(packed) for _ in range(D)], batch=10)
    bound = gather_bound_ms(D, words)
    del packed

    def host_ms(fn, runs: int = 3) -> float:
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    (sa, ca), (sb, cb) = full_leaves[0], full_leaves[1]
    ca, cb = ca % (4 * K), cb % (4 * K)  # counts around k: every row draws
    # one run: a second of host-launched tensor code, which a median of three
    # would not steady
    pair_uniform_ms = host_ms(lambda: plain.merge_samples(sa, ca, sb, cb, key_from_seed(1).to(dev)), runs=1)
    lk = [-torch.rand((WR, WK), device=dev, generator=gen) for _ in range(2)]
    ws = [torch.randint(0, 2**31 - 1, (WR, WK), dtype=torch.int32, device=dev, generator=gen) for _ in range(2)]
    wc = torch.full((WR,), 4 * WK, dtype=torch.int32, device=dev)
    pair_weighted_ms = host_ms(lambda: wplain.merge_parts(ws[0], lk[0], wc, ws[1], lk[1], wc))
    dstates = []
    for _ in range(2):
        st = dplain.init(key_from_seed(0), DR, DK, device=dev)
        dstates.append(dkern.update_cuda(st, zipf_keys(gen, DR, DB, torch.int32, dev)))
    pair_distinct_ms = host_ms(lambda: dplain.merge(dstates[0], dstates[1]))
    del full_leaves, lk, ws, dstates
    card = card_line()
    log(f"[19 merge timings] {card} | all-gather of {D} ranks x ([{R}, {K}] + [{R}]) words "
        f"({4 * words / 1e6:.1f} MB a rank in, {4 * D * words / 1e6:.1f} MB a rank out): kernel "
        f"{gather_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.stack of the packed blocks once a rank "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    log(f"[19 merge timings] {card} | one batched pairwise merge: uniform [{R}, {K}] {pair_uniform_ms:.1f} ms, "
        f"weighted [{WR}, {WK}] {pair_weighted_ms:.2f} ms, distinct [{DR}, {DK}] {pair_distinct_ms:.2f} ms; "
        f"whole mergers over 4 shards: uniform {1e3 * t_merge_uniform:.1f} ms, distinct "
        f"{1e3 * t_merge_distinct:.1f} ms, weighted {1e3 * t_merge_weighted:.1f} ms (first calls)")
    return {
        "name": "merge_ring_gather",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/merge_ring.cu",
        "replaces": "reservoir_tpu/ops/merge_pallas.py:59",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": gather_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_note": f"torch.stack of the {D} packed [{R}, {K + 1}] blocks, once a rank, on one card",
        "cards": n_cards,
        "pairwise_merge_ms": {"uniform": pair_uniform_ms, "weighted": pair_weighted_ms,
                              "distinct": pair_distinct_ms},
        "stream_merger_ms": {"uniform": 1e3 * t_merge_uniform, "distinct": 1e3 * t_merge_distinct,
                             "weighted": 1e3 * t_merge_weighted},
    }


def flush_plan(streams: torch.Tensor, rank: torch.Tensor, rows: int, width: int) -> list:
    """Where the bridge must flush a feed of pair ``streams`` whose ranks in
    their rows are ``rank``: the staging takes pairs in order and stops at
    the first whose row already holds ``width`` since the last flush.
    Returns each flush's per-row base (elements of the row flushed before
    it); the last flush is the remainder, at ``flush()``."""
    bases = [torch.zeros(rows, dtype=torch.int64, device=streams.device)]
    start = 0
    while True:
        base = bases[-1]
        full = (rank[start:] - base[streams[start:].long()]) >= width
        if not bool(full.any()):
            return bases
        stop = start + int(torch.argmax(full.to(torch.uint8)))
        bases.append(base + torch.bincount(streams[start:stop], minlength=rows))
        start = stop


def copies_overlapping_demux(trace_path: str) -> list:
    """From a ``torch.profiler`` Chrome trace: for each tile copy to the
    card (1 ms or more), in order, the share of its time during a demux
    range; empty when the trace holds no device copies."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = lambda keep: [(e["ts"], e["ts"] + e["dur"]) for e in events  # noqa: E731
                          if e.get("ph") == "X" and "dur" in e and keep(e)]
    copies = spans(lambda e: e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
                   and e["dur"] >= 1000)
    demux = spans(lambda e: e.get("name") == "reservoir_bridge_demux" and e.get("cat") != "gpu_user_annotation")
    return [sum(max(0.0, min(b, d1) - max(a, d0)) for d0, d1 in demux) / (b - a)
            for a, b in sorted(copies)]


def bridge_phases(gen, dev, here: str, engine_eps: dict) -> dict:
    """Phases 20-23, the stream bridge; returns the ``bridge`` line."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import native
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.stream.bridge import _FlushJournal
    from reservoir_tpu_torch.utils.tracing import profile_capture

    work = os.path.join(here, "build", "chip_smoke")  # gitignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 20. the host staging library
    t0 = time.perf_counter()
    staging = native.NativeStaging(R, B, np.int32)
    if not staging.available():
        fail("the native staging library is not in use")
    threads = staging.threads()
    del staging
    log(f"[20 bridge build] g++ staging library built and loaded in {time.perf_counter() - t0:.2f} s; "
        f"os.cpu_count() {os.cpu_count()}, demux threads {threads}")

    # 21. the bridge at full width: random pairs, pipelined and serial
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B)
    N = 3 * R * B
    gen.manual_seed(31)
    streams_d = torch.randint(0, R, (N,), generator=gen, device=dev, dtype=torch.int32)
    elems_d = torch.randint(-(2**31), 2**31 - 1, (N,), generator=gen, device=dev, dtype=torch.int32)
    streams_h = streams_d.cpu().numpy()
    elems_h = elems_d.cpu().numpy()
    # each row's own stream, in order: [R, L] with the row counts
    order = torch.sort(streams_d, stable=True).indices
    sorted_s = streams_d[order].long()
    counts = torch.bincount(streams_d, minlength=R)
    rank_sorted = torch.arange(N, device=dev) - (torch.cumsum(counts, 0) - counts)[sorted_s]
    L = int(counts.max())
    rows_m = torch.zeros((R, L), dtype=torch.int32, device=dev)
    rows_m[sorted_s, rank_sorted] = elems_d[order]
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    del order, sorted_s, rank_sorted, elems_d
    bases = flush_plan(streams_d, rank, R, B)
    del rank, streams_d
    states = {}
    for pipelined in (True, False):
        bridge = rtt.DeviceStreamBridge(cfg, key=0, pipelined=pipelined)
        torch.cuda.synchronize()
        kern.launches = 0
        bridge.push_interleaved(streams_h, elems_h)
        bridge.flush()
        bridge.drain_barrier()
        launches = kern.launches
        if pipelined:
            bridge_launches = launches
        if bridge.metrics.flushes != len(bases) or launches != len(bases):
            fail(f"the bridge (pipelined {pipelined}) made {bridge.metrics.flushes} flushes and "
                 f"{launches} launches where the staging contract puts {len(bases)}")
        if bridge.metrics.flushed_elements != N:
            fail(f"the bridge flushed {bridge.metrics.flushed_elements} of {N} elements")
        states[pipelined] = clone(bridge.engine._state)
        del bridge
        gc.collect()
    if not same(states[True], states[False]):
        fail("the pipelined bridge's state != the serial bridge's")
    engine = rtt.ReservoirEngine(cfg, key=0)
    start_cpu = clone(engine._state, ROWS_CPU, "cpu")
    s0 = clone(engine._state)
    W2 = 1536
    for c0 in range(0, L, W2):
        width = min(W2, L - c0)
        valid = torch.clamp(counts - c0, 0, width).to(torch.int32)
        engine.sample(rows_m[:, c0 : c0 + width].contiguous(), valid=valid.cpu().numpy())
    torch.cuda.synchronize()
    if not same(engine._state, states[True]):
        fail(f"the bridge's state != the card engine fed the same row streams in tiles of {W2}")
    del engine
    st = start_cpu
    rows_cpu, counts_cpu = rows_m[:ROWS_CPU].cpu(), counts[:ROWS_CPU].cpu()
    for c0 in range(0, L, B):
        width = min(B, L - c0)
        st = plain.update(st, rows_cpu[:, c0 : c0 + width].contiguous(),
                          torch.clamp(counts_cpu - c0, 0, width).to(torch.int32))
    if not same(st, clone(states[True], ROWS_CPU, "cpu")):
        fail(f"the bridge's rows 0..{ROWS_CPU - 1} != the plain version on the CPU")
    log(f"[21 bridge vs engine] {N} random pairs, R {R}, k {K}, B {B}: {len(bases)} ragged flushes "
        f"where the staging contract puts them, {bridge_launches} launches; pipelined == serial == "
        f"card engine in tiles of {W2} == plain version on rows 0..{ROWS_CPU - 1}, bit for bit")

    # algl_update on the second flush's ragged tile, and on the same tile full
    def flush_tile(j):
        hi = bases[j + 1] if j + 1 < len(bases) else counts
        idx = torch.clamp(bases[j][:, None] + torch.arange(B, device=dev)[None, :], max=L - 1)
        return torch.gather(rows_m, 1, idx).contiguous(), (hi - bases[j]).to(torch.int32)

    if len(bases) < 2:
        fail("the random feed made a single flush")
    t1, v1 = flush_tile(0)
    s1 = kern.update_cuda(clone(s0), t1, v1)
    t2, v2 = flush_tile(1)
    fill2 = int(v1.min()) < K
    upd = kern.update_cuda if fill2 else kern.update_steady_cuda
    ragged_ms = event_ms(lambda s: upd(s, t2, v2), setup=lambda: clone(s1), batch=10)
    full_ms = event_ms(lambda s: upd(s, t2), setup=lambda: clone(s1), batch=10)
    _, ragged_accepts = plain.update_accepts(clone(s1), t2, v2, fill=fill2)
    ragged_bound, ragged_by = bound_ms(ragged_accepts, 0)
    ragged = {"ms": ragged_ms, "full_tile_ms": full_ms, "bound_ms": ragged_bound, "bound_by": ragged_by,
              "accepts": ragged_accepts, "elements": int(v2.sum()), "fill_kernel": fill2,
              "count_before": [int(v1.min()), int(v1.max())]}
    del rows_m, t1, t2, s0, s1, states
    card = card_line()
    log(f"[21 bridge vs engine] {card} | algl_update on flush 2's ragged tile ({int(v2.sum())} of {R * B} "
        f"elements, counts {int(v1.min())}..{int(v1.max())} before): {ragged_ms:.4f} ms, the same tile full "
        f"{full_ms:.4f} ms, bound {ragged_bound:.4f} ms ({ragged_by}), accepts {ragged_accepts}")

    # the weighted and distinct bridges: the card engine fed the journaled
    # flushes reaches the bridge's state
    def journaled(name, cfg_x, streams, elems, weights, counter):
        ckdir = os.path.join(work, name)
        bridge = rtt.DeviceStreamBridge(cfg_x, key=0, checkpoint_dir=ckdir, checkpoint_every=1 << 30)
        before = counter.launches
        bridge.push_interleaved(streams, elems, weights=weights)
        bridge.flush()
        bridge.drain_barrier()
        flushes, launches = bridge.metrics.flushes, counter.launches - before
        state = clone(bridge.engine._state)
        del bridge
        gc.collect()
        engine = rtt.ReservoirEngine(cfg_x, key=0)
        replayed = 0
        for _, tile, valid, wtile, _ in _FlushJournal.replay(
            os.path.join(ckdir, "journal.bin"), cfg_x.num_reservoirs, cfg_x.tile_size,
            np.dtype(cfg_x.element_dtype), cfg_x.weighted,
        ):
            engine.sample(tile, valid=valid, weights=wtile)
            replayed += 1
        torch.cuda.synchronize()
        shutil.rmtree(ckdir)
        if replayed != flushes or launches != flushes or flushes < 2:
            fail(f"{name}: {flushes} flushes, {launches} launches, {replayed} journaled")
        if not same(engine._state, state):
            fail(f"the {name} bridge's state != the card engine fed its journaled flushes")
        return flushes

    n_w = 2 * WR * WB
    w_streams = torch.randint(0, WR, (n_w,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
    w_elems = torch.randint(-(2**31), 2**31 - 1, (n_w,), generator=gen, device=dev,
                            dtype=torch.int32).cpu().numpy()
    w_weights = weight_tile(gen, 1, n_w, "zeros", dev)[0].cpu().numpy()
    wcfg = rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB, weighted=True)
    w_flushes = journaled("weighted", wcfg, w_streams, w_elems, w_weights, wkern)
    del w_streams, w_elems, w_weights
    d_flushes = {}
    for dtype in (torch.int32, torch.int64):
        n_d = 3 * DR * DB
        d_streams = torch.randint(0, DR, (n_d,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
        d_keys = zipf_keys(gen, 1, n_d, dtype, dev)[0].cpu().numpy()
        name = str(dtype).replace("torch.", "")
        dcfg = rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB, distinct=True,
                                 element_dtype=name)
        d_flushes[name] = journaled(f"distinct {name}", dcfg, d_streams, d_keys, None, dkern)
    scfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=1, tile_size=B)
    one = torch.randint(-(2**31), 2**31 - 1, (5 * B + 77,), generator=gen, device=dev,
                        dtype=torch.int32).cpu().numpy()
    sampler = rtt.DeviceSampler(scfg, key=0)
    sampler.sample_all(one)
    ref = rtt.ReservoirEngine(scfg, key=0)
    ref.sample_stream(one[None, :])
    if not np.array_equal(sampler.result(), ref.result()[0]):
        fail("DeviceSampler != the engine on the same stream")
    log(f"[21 bridge vs engine] weighted bridge ({w_flushes} flushes of [{WR}, {WB}]), distinct bridges "
        f"int32 ({d_flushes['int32']}) and int64 ({d_flushes['int64']}) of [{DR}, {DB}]: each == the card "
        f"engine fed its journaled flushes; DeviceSampler (R 1, B {B}, k {K}) == the engine")

    # 22. timings of three feeds at full width
    gen.manual_seed(37)
    lock = torch.randint(-(2**31), 2**31 - 1, (3, B, R), generator=gen, device=dev, dtype=torch.int32)
    lock_streams = np.tile(np.arange(R, dtype=np.int32), B)
    lock_chunks = [lock[t].reshape(-1).cpu().numpy() for t in range(3)]
    host_tiles = [lock[t].T.contiguous().cpu().numpy() for t in range(3)]
    del lock

    def interleaved(bridge):
        bridge.push_interleaved(streams_h, elems_h)

    def lockstep(bridge):
        for chunk in lock_chunks:
            bridge.push_interleaved(lock_streams, chunk)

    def tiles(bridge):
        for tile in host_tiles:
            bridge.push_tile(tile)

    def window(bridge, feed) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed(bridge)
        bridge.flush()
        bridge.drain_barrier()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    feeds = {}
    overlap = []
    for name, feed, n in (("interleaved", interleaved, N), ("lockstep", lockstep, 3 * R * B),
                          ("push_tile", tiles, 3 * R * B)):
        bridge = rtt.DeviceStreamBridge(cfg, key=0)
        window(bridge, feed)  # warm
        m = bridge.metrics
        for f in ("demux_s", "drain_s", "dispatch_s", "copy_s", "reserve_s"):
            setattr(m, f, 0.0)
        m.flushes = m.elements = m.flushed_elements = 0
        dt = window(bridge, feed)
        feeds[name] = {
            "elem_per_s": n / dt, "seconds": dt, "flushes": m.flushes, "demux_s": m.demux_s,
            "take_s": m.drain_s, "copy_ms": 1e3 * m.copy_s / max(1, m.flushes), "dispatch_s": m.dispatch_s,
            "reserve_s": m.reserve_s,
        }
        if name == "lockstep":
            # one more pass in a profiler window: do the copies overlap
            # the demux of the next tile?
            try:
                with profile_capture(os.path.join(work, "profile")):
                    window(bridge, feed)
                overlap = copies_overlapping_demux(os.path.join(work, "profile", "trace.json"))
            except RuntimeError as e:
                log(f"[22 bridge timings] the profiler failed ({e}); overlap not measured")
        del bridge
        gc.collect()
    copy_ms = feeds["lockstep"]["copy_ms"]
    wire_eps = R * B / (copy_ms / 1e3) if copy_ms > 0 else None
    card = card_line()
    for name, f in feeds.items():
        log(f"[22 bridge timings] {card} | {name}: {f['elem_per_s']:.6e} elem/s ({f['seconds']:.3f} s, "
            f"{f['flushes']} flushes); demux {f['demux_s']:.3f} s, take {f['take_s']:.4f} s, copy "
            f"{f['copy_ms']:.2f} ms a flush, dispatch {f['dispatch_s']:.3f} s, waiting in reserve "
            f"{f['reserve_s']:.3f} s")
    log(f"[22 bridge timings] {card} | engine fed from the device {engine_eps['device_fed']:.6e}, from the "
        f"host {engine_eps['host_fed']:.6e} elem/s (phase 7); the wire's ceiling {4 * R * B} bytes / "
        f"{copy_ms:.2f} ms = {wire_eps or 0:.6e} elem/s; demux threads {threads} of {os.cpu_count()} cores; "
        + (f"profile: {len(overlap)} tile copies, each's share of its time during a demux range "
           + ", ".join(f"{share:.3f}" for share in overlap) + " (the last flush has no next tile)"
           if overlap else "profile: no device copies in the trace (overlap not measured)"))
    del lock_chunks, host_tiles, lock_streams, streams_h, elems_h

    # 23. recovery on the card
    rr, rb = RR, RB
    rcfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=rr, tile_size=rb)
    n_r = 8 * rr * rb
    r_streams = torch.randint(0, rr, (n_r,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
    r_elems = torch.randint(-(2**31), 2**31 - 1, (n_r,), generator=gen, device=dev,
                            dtype=torch.int32).cpu().numpy()
    whole = rtt.DeviceStreamBridge(rcfg, key=0)
    whole.push_interleaved(r_streams, r_elems)
    want = whole.complete()
    del whole
    ckdir = os.path.join(work, "recovery")
    dropped = rtt.DeviceStreamBridge(rcfg, key=0, checkpoint_dir=ckdir, checkpoint_every=2)
    dropped.push_interleaved(r_streams[: n_r // 2], r_elems[: n_r // 2])
    dropped.drain_barrier()
    seq, durable, checkpoints = dropped.flushed_seq, dropped.metrics.flushed_elements, dropped.metrics.checkpoints
    del dropped  # the crash: no complete(), the staged remainder is lost
    gc.collect()
    t0 = time.perf_counter()
    recovered = rtt.DeviceStreamBridge.recover(ckdir)
    recover_s = time.perf_counter() - t0
    if recovered.flushed_seq != seq or recovered.metrics.flushed_elements != durable:
        fail(f"recover() came back at flush {recovered.flushed_seq} ({recovered.metrics.flushed_elements} "
             f"elements), the drop was at {seq} ({durable})")
    # resume from the durable watermark: the flushes took a prefix of the pairs
    recovered.push_interleaved(r_streams[durable:], r_elems[durable:])
    got = recovered.complete()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("the recovered bridge's samples != the uninterrupted run's")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[23 bridge recovery] R {rr}, B {rb}, checkpoint_every 2: dropped after flush {seq} "
        f"({checkpoints} checkpoints, {durable} of {n_r // 2} pushed elements durable); recover() on the "
        f"card in {recover_s:.2f} s, then the rest of the stream: samples == the uninterrupted run")
    return {
        "card": card,
        "config": {"R": R, "k": K, "B": B, "element_dtype": "int32", "pairs": N},
        "cpu_count": os.cpu_count(),
        "demux_threads": threads,
        "launches": bridge_launches,
        "flushes": len(bases),
        "feeds": feeds,
        "engine_elem_per_s": engine_eps,
        "wire_elem_per_s": wire_eps,
        "copy_time_share_during_demux": overlap,
        "ragged_flush": ragged,
        "weighted_flushes": w_flushes,
        "distinct_flushes": d_flushes,
        "recovery": {"flushes_before_drop": seq, "checkpoints": checkpoints, "recover_s": recover_s},
    }


if __name__ == "__main__":
    main()
