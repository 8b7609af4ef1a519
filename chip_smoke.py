"""Smoke test of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's two paths on ``"cuda"`` — the uniform engine,
``ReservoirEngine(SamplerConfig(k=128, R=65536, tile_size=2048), key=0)``,
and the weighted engine, ``ReservoirEngine(SamplerConfig(k=64, R=16384,
tile_size=1024, weighted=True), key=0)`` — and holds each CUDA kernel
against its plain torch version.  Phases, each of which fails the run with
a non-zero exit:

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
   plain version and the bound, the engine's
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
   steady tile (from count 7 B) beside the plain version and the bound, and
   the steady tile again with every weight 0 (the scan without acceptances).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
# read) and per acceptance (one 32-byte sector gathered, one written)
STATE_BYTES_PER_ROW = 28
BYTES_PER_ACCEPT = 64
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
SECTOR_BYTES = 32


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
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
}


def same(a, b) -> bool:
    words, floats = FIELDS[type(a).__name__]
    return all(bool(torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))) for f in words + floats)


def max_abs_err(a, b) -> float:
    """Largest difference over the compared fields, as values (int fields
    and sample words as int64, float fields as float64); 0 when
    bit-identical."""
    words, floats = FIELDS[type(a).__name__]
    err = 0.0
    for f in words:
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
    return type(state)(*(t[sl].clone().to(device or t.device) for t in state))


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


def bound_ms(accepts: int, fill_elems: int) -> tuple:
    nbytes = R * STATE_BYTES_PER_ROW + accepts * BYTES_PER_ACCEPT + 8 * fill_elems
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
    from reservoir_tpu_torch.ops import fmath
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
    gen.manual_seed(23)
    s0 = plain.init(key_from_seed(0), R, K, device=dev)
    fill_tile = random_tile(gen, B, torch.int32, dev)
    fill_ms = event_ms(lambda s: kern.update_cuda(s, fill_tile), setup=lambda: clone(s0), batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = plain.update_accepts(clone(s0), fill_tile, fill=True)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fill_bound, fill_by = bound_ms(fill_accepts, R * K)
    state = clone(s0)
    kern.update_cuda(state, fill_tile)
    del ref, fill_tile
    for _ in range(6):  # steady tiles 2..7: count reaches 7 * B
        kern.update_steady_cuda(state, random_tile(gen, B, torch.int32, dev))
    steady_tile = random_tile(gen, B, torch.int32, dev)
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
    del steady_tile, state
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
    log(f"[7 timings] {card} | fill tile (count 0 -> {B}): kernel {fill_ms:.4f} ms, plain "
        f"{fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts {fill_accepts}")
    log(f"[7 timings] {card} | steady tile (count {7 * B} -> {8 * B}): kernel {steady_ms:.4f} ms, "
        f"plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms ({steady_by}), "
        f"accepts {steady_accepts}")
    log(f"[7 timings] {card} | engine: {dev_eps:.6e} elem/s fed from the device, "
        f"{host_eps:.6e} elem/s fed from the host")
    log(f"[7 timings] {card} | host tile of {4 * R * B} bytes: snapshot into pinned memory "
        f"{snapshot_ms:.2f} ms, copy to the card {h2d_ms:.2f} ms "
        f"({4 * R * B / h2d_ms / 1e6:.2f} GB/s); engine fed 4 more host tiles after a warm-up: "
        f"{warm_host_eps:.6e} elem/s")

    weighted = weighted_phases(gen, dev)

    card = card_line()
    log(card)
    log(json.dumps({"kernels": [{
        "name": "algl_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algorithm_l.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l_pallas.py:110",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": steady_ms,
        "plain_ms": steady_plain_ms,
        "bound_ms": steady_bound,
        "bound_by": steady_by,
        "library_ms": None,
        "fill_tile": {"ms": fill_ms, "plain_ms": fill_plain_ms, "bound_ms": fill_bound,
                      "bound_by": fill_by, "accepts": fill_accepts},
        "steady_accepts": steady_accepts,
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
        "host_tile_ms": {"snapshot": snapshot_ms, "h2d": h2d_ms},
        "warm_host_fed_elem_per_s": warm_host_eps,
    }, weighted]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


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
    def bench_tile(t):
        elems = (t * WB + torch.arange(WB, dtype=torch.int32, device=dev))[None, :].expand(WR, WB)
        elems = elems.contiguous()
        return elems, bench_weights(elems)

    s0 = wplain.init(key_from_seed(0), WR, WK, device=dev)
    fill_e, fill_w = bench_tile(0)
    fill_ms = event_ms(lambda s: wkern.update_cuda(s, fill_e, fill_w), setup=lambda: clone(s0),
                       batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = wplain.update_accepts(clone(s0), fill_e, fill_w)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fills = int((ref.lkeys > float("-inf")).sum().item())
    fill_bound, fill_by = weighted_bound_ms(fill_accepts, fills, WR * WB)
    state = wkern.update_cuda(clone(s0), fill_e, fill_w)
    del ref, fill_e, fill_w
    for t in range(1, 7):  # tiles 1..6: count reaches 7 * B
        wkern.update_cuda(state, *bench_tile(t))
    steady_e, steady_w = bench_tile(7)
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
    zero_w = torch.zeros_like(steady_w)
    scan_ms = event_ms(lambda s: wkern.update_cuda(s, steady_e, zero_w), setup=lambda: clone(state),
                       batch=10)
    del state, steady_e, steady_w, zero_w
    card = card_line()
    log(f"[11 weighted timings] {card} | fill tile (count 0 -> {WB}): kernel {fill_ms:.4f} ms, "
        f"plain {fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts "
        f"{fill_accepts}, fills {fills}")
    log(f"[11 weighted timings] {card} | steady tile (count {7 * WB} -> {8 * WB}): kernel "
        f"{steady_ms:.4f} ms, plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms "
        f"({steady_by}), accepts {steady_accepts}; the same tile with zero weights (no "
        f"acceptance) {scan_ms:.4f} ms")
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
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
    }


if __name__ == "__main__":
    main()
