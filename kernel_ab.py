"""Time two builds of the port's kernels in turns on one card.

    python3 kernel_ab.py --old DIR [--unchecked] [--out FILE]

``DIR`` holds another version of ``reservoir_tpu_torch/csrc`` (for example
the parent commit's, from ``git archive``, or a variant of this one, with
the headers its sources include).  Each of ``algorithm_l.cu``,
``distinct.cu``, ``weighted.cu``, ``algl_merge.cu`` and ``merge_ring.cu``
that it holds must keep the C entry points of its wrapper (``algl_update``
and ``algl_update_gated``, ``distinct_update``, ``weighted_update``,
``algl_merge_draws`` and ``algl_merge_draws_wide``, ``merge_ring_gather``
and its helpers) with their arguments, and only those kernels are timed (a
variant directory holds just the file it edits).  The script
builds those files of both versions with the port's own nvcc flags (plus
``-Xptxas -v``) into ``reservoir_tpu_torch/_build/ab/``, all at once,
loads each build through its wrapper (``_library(path)`` of
``ops/algorithm_l_cuda.py``, ``ops/distinct_cuda.py`` and
``ops/weighted_cuda.py``, ``_merge_library(path)`` of
``ops/algorithm_l_cuda.py``), and then, at ``chip_smoke.py``'s shapes and
on its tiles, times old and new in turns (old, new, new, old) with
``chip_smoke.event_ms``:

- ``algl_update`` (R = 65,536, k = 128, B = 2,048) on phase 7's tiles
  (``chip_smoke.uniform_timing_cases``): the fill tile from count 0 and the
  steady tiles from count 7 B and 24 B;
- ``algl_update_gated`` (the same shape, gate tile 64) on phase 24's int32
  candidate tiles (``chip_smoke.gated_timing_cases``): the steady state
  (count 4 B) and the deep one (count 24 B), where an older build has it;
- ``distinct_update`` (R = 4,096, k = 256, B = 1,024) on phase 15's tiles
  (``chip_smoke.distinct_timing_cases``): Zipf tiles from empty and after 8
  Zipf tiles, int32 and int64, and fresh random keys after 8 (int32), each
  also given with ``valid`` = B (keep-max, or the default in a build
  without it); the new build's keep-max and pre-hashed kernels at each rows
  a block on their steady tiles; and
  ``distinct_update_hashed`` on phase 40's (``chip_smoke.prehashed_timing_cases``:
  a steady Zipf tile and one from empty under a user hash), where the old
  build has it;
- ``weighted_update`` (R = 16,384, k = 64, B = 1,024) on phase 11's tiles
  (``chip_smoke.weighted_timing_cases``): the fill tile from empty, the
  steady tile from count 7 B, and that tile with every weight 0;
- ``algl_merge_draws`` on phase 19's uniform pair
  (``chip_smoke.merge_timing_case``, R = 65,536, k = 128), and, where the
  old build has it, ``algl_merge_draws_wide`` on that pair's counts as
  WIDE words and on phase 38's counts past 2^32;
- ``merge_ring_gather`` at phase 19's shape (4 ranks of the card, each
  ``[65536, 128]`` and ``[65536]`` words) and at phase 43's (8 ranks, each
  ``[8192, 128]``, ``[8192]`` and ``[8192]``), each build's output equal to
  ``gather_parts_plain``'s, timed four ways in turns
  (``chip_smoke.gather_times``): the bare launch (the kernel's own time),
  the wrapper call back to back, one wrapper call between the events, and
  the host's time a wrapper call.

Each tile is first run once by both builds, and their results must be
bit-identical, unless ``--unchecked`` says that the old build is a
diagnosis variant that computes something else (a one-edit copy with the
gathers or the writes taken out, say), which is then only timed.  Each
build's registers, spills and static shared memory (``-Xptxas -v``) are
printed, with each kernel's instructions by the pipe their opcodes issue
to (``cuobjdump -sass``: the kernel's, and its largest loop's), and for the
checkout's build its ``kernel_info`` at the launch shape (shared memory and
resident warps an SM), with the card's name and power limit and each
tile's bound (``chip_smoke``'s bound functions, the merge kernels' with
the remainders ``chip_smoke.remainder_ops`` counts); the whole goes to
``--out`` as JSON.  It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("algorithm_l", "distinct", "weighted", "algl_merge", "merge_ring")
#: the kernels of each source whose SASS is counted
SASS_KERNELS = {"algorithm_l": ("update_kernel", "gated_kernel"), "distinct": ("update_kernel", "hashed_kernel"),
                "weighted": ("update_kernel",), "algl_merge": ("draws_kernel",),
                "merge_ring": ("gather_kernel",)}


def build(dirs: dict, out_dir: str, names=KERNELS) -> dict:
    """Compile the sources ``names`` (``KERNELS`` by default) of each
    ``{tag: csrc directory}``, all in parallel; returns ``{tag: {name:
    (library path, ptxas lines)}}``."""
    from reservoir_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, csrc in dirs.items():
        for name in names:
            lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                   os.path.join(csrc, f"{name}.cu")]
            procs[tag, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                 text=True), lib)
    built = {tag: {} for tag in dirs}
    for (tag, name), (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[tag]}/{name}.cu:\n{out}")
        built[tag][name] = (lib, [ln.strip() for ln in out.splitlines()
                                  if "entry function" in ln or "registers" in ln or "spill" in ln])
    return built


# SASS opcodes by the pipe that issues them (the rest count as "other")
PIPES = {
    "integer": ("LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "PRMT", "FSETP", "FSEL", "FMNMX",
                "VIADD", "IABS", "POPC", "FLO", "BMSK", "PLOP3"),
    "fma": ("IMAD", "FFMA", "FADD", "FMUL", "HFMA2"),
    "convert/special": ("I2F", "I2FP", "F2I", "FRND", "MUFU", "FCHK"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDGSTS", "LDC", "ULDC", "LDGDEPBAR",
               "DEPBAR", "CCTL", "UBLKPF"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC", "VOTE", "BAR", "NOP"),
}


def sass_counts(lib: str, kernel: str = "update_kernel") -> dict:
    """``cuobjdump -sass`` of a build: the instructions of the first
    function whose name holds ``kernel``, and of its largest loop (the span
    of its longest backward branch), each by the pipe of ``PIPES``."""
    from reservoir_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    ops, addr_of, inside = [], {}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            if inside:
                break
            inside = kernel in ln
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4})\*/\s+(.*?);", ln)
        if inside and m:
            addr_of[int(m.group(1), 16)] = len(ops)
            ops.append(m.group(2).split())
    loops = []
    for i, words in enumerate(ops):
        op = words[1] if words[0].startswith("@") else words[0]
        if op.startswith("BRA") and words[-1].startswith("0x") and int(words[-1], 16) in addr_of:
            start = addr_of[int(words[-1], 16)]
            if start < i:
                loops.append((i - start + 1, start, i))

    def by_pipe(chunk):
        counts = {pipe: 0 for pipe in PIPES} | {"other": 0}
        for words in chunk:
            op = (words[1] if words[0].startswith("@") else words[0]).split(".")[0]
            counts[next((p for p, names in PIPES.items() if op in names), "other")] += 1
        return counts

    size, start, end = max(loops, default=(0, 0, -1))
    return {"instructions": len(ops), "by_pipe": by_pipe(ops),
            "largest_loop": {"instructions": size, "by_pipe": by_pipe(ops[start:end + 1])}}


def gather_leaves(gen, dev, d: int, rows: int, widths: tuple, seed: int) -> list:
    """d ranks' leaves for a timed all-gather: a ``[rows, w]`` block of
    random int32 words for each width ``w`` of ``widths`` (``None`` for a
    ``[rows]`` leaf), made from ``seed``."""
    gen.manual_seed(seed)
    return [tuple(torch.randint(0, 2**31 - 1, (rows,) if w is None else (rows, w), dtype=torch.int32,
                                device=dev, generator=gen) for w in widths)
            for _ in range(d)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory with the old csrc sources")
    ap.add_argument("--unchecked", action="store_true",
                    help="the old build is a variant that computes something else: time it, do not compare")
    ap.add_argument("--out", default=os.path.join(HERE, "reservoir_tpu_torch", "_build", "ab", "kernel_ab.json"),
                    help="where the JSON of times and builds goes")
    args = ap.parse_args()
    names = tuple(n for n in KERNELS if os.path.isfile(os.path.join(args.old, f"{n}.cu")))
    if not names:
        sys.exit(f"{args.old} holds none of " + ", ".join(f"{n}.cu" for n in KERNELS))
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from reservoir_tpu_torch.ops import algorithm_l as uplain
    from reservoir_tpu_torch.ops.rng import key_from_seed, split_keys
    from reservoir_tpu_torch.ops import algorithm_l_cuda as ukern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    card = cs.card_line()
    dev = torch.device("cuda")
    cs.REMAINDER_OPS.update(cs.remainder_ops(os.path.join(HERE, "reservoir_tpu_torch", "_build", "ab")))
    built = build({"old": args.old, "new": os.path.join(HERE, "reservoir_tpu_torch", "csrc")},
                  os.path.join(HERE, "reservoir_tpu_torch", "_build", "ab"), names)
    loaders = {"algorithm_l": ukern._library, "distinct": dkern._library, "weighted": wkern._library,
               "algl_merge": ukern._merge_library, "merge_ring": mkern._library}

    def use(which: str, name: str) -> None:
        """Make ``which`` build the one the wrapper of ``name`` launches."""
        loaders[name](built[which][name][0])

    for name in names:
        use("new", name)
    info = {"algorithm_l": lambda: {"algorithm_l": ukern.kernel_info(),
                                    "algorithm_l_gated": ukern.gated_kernel_info()},
            "algl_merge": lambda: {"algl_merge": ukern.merge_kernel_info(),
                                   "algl_merge_wide": ukern.merge_kernel_info(wide=True)},
            "merge_ring": lambda: {"merge_ring": mkern.kernel_info()},
            "distinct": lambda: {"distinct": dkern.kernel_info(cs.DK, False),
                                 "distinct_wide": dkern.kernel_info(cs.DK, True),
                                 "distinct_prehashed": dkern.kernel_info(cs.DK, False, rule=dkern.HASHED),
                                 "distinct_prehashed_wide": dkern.kernel_info(cs.DK, True, rule=dkern.HASHED),
                                 "distinct_keepmax": dkern.kernel_info(cs.DK, False, rule=dkern.KEEPMAX),
                                 "distinct_keepmax_wide": dkern.kernel_info(cs.DK, True, rule=dkern.KEEPMAX)},
            "weighted": lambda: {"weighted": wkern.kernel_info(cs.WK)}}
    results = {"card": card, "old": args.old, "unchecked": args.unchecked, "tiles": [],
               "ptxas": {which: {n: lines for n, (_, lines) in b.items()} for which, b in built.items()},
               "kernel_info_new": {n: i for name in names for n, i in info[name]().items()}}
    print(f"[ab] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for which, lines_of in results["ptxas"].items():
        for n, lines in lines_of.items():
            for ln in lines:
                print(f"[ab ptxas] {which} {n}: {ln}", flush=True)
    for n, info in results["kernel_info_new"].items():
        print(f"[ab build] new {n}: {cs.build_text(info)}", flush=True)
    results["sass"] = {which: {f"{n} {kernel}": sass_counts(lib, kernel) for n, (lib, _) in b.items()
                               for kernel in SASS_KERNELS[n]}
                       for which, b in built.items()}
    for which, counts_of in results["sass"].items():
        for n, c in counts_of.items():
            print(f"[ab sass] {which} {n}: {c['instructions']} instructions ({c['by_pipe']}), largest loop "
                  f"{c['largest_loop']['instructions']} ({c['largest_loop']['by_pipe']})", flush=True)

    def ab(name: str, label: str, state, step, bound: tuple, extra: dict, setup=None) -> None:
        """Check old and new agree on this tile, then time them in turns:
        old, new, new, old.  ``step`` takes ``setup()`` (by default a clone
        of ``state``)."""
        setup = setup or (lambda: cs.clone(state))
        got = {}
        for which in ("old", "new"):
            use(which, name)
            got[which] = step(setup())
        torch.cuda.synchronize()
        if not args.unchecked and not cs.same(got["old"], got["new"]):
            sys.exit(f"FAIL: old and new {name} differ on the {label}")
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use(which, name)
            times[which].append(cs.event_ms(step, setup=setup, batch=10))
        use("new", name)
        results["tiles"].append({"kernel": name, "tile": label, "old_ms": times["old"], "new_ms": times["new"],
                                 "bound_ms": bound[0], "bound_by": bound[1], **extra})
        print(f"[ab] {card} | {name} {label}: old {times['old'][0]:.4f} / {times['old'][1]:.4f} ms, new "
              f"{times['new'][0]:.4f} / {times['new'][1]:.4f} ms (old, new, new, old), bound "
              f"{bound[0]:.4f} ms ({bound[1]})", flush=True)

    gen = torch.Generator(device=dev)
    # algl_update on phase 7's tiles
    for label, state, tile, fill in cs.uniform_timing_cases(gen, dev) if "algorithm_l" in names else ():
        _, accepts = uplain.update_accepts(cs.clone(state), tile, fill=fill)
        step = ukern.update_cuda if fill else ukern.update_steady_cuda
        ab("algorithm_l", label, state, lambda s, t=tile, f=step: f(s, t),
           cs.bound_ms(accepts, cs.R * cs.K if fill else 0), {"accepts": accepts})

    # algl_update_gated on phase 24's candidate tiles, where both builds have it
    gated = "algorithm_l" in names and all(
        hasattr(ctypes.CDLL(built[w]["algorithm_l"][0]), "algl_update_gated") for w in built)
    for label, state, (gtile, nvalid, advance), fills, accepts in cs.gated_timing_cases(gen, dev) if gated else ():
        ab("algorithm_l", f"gated {label}", state,
           lambda s, g=gtile, n=nvalid, a=advance: ukern.update_gated_cuda(s, g, n, a),
           cs.gated_bound_ms(fills, accepts, cs.R), {"fills": fills, "accepts": accepts,
                                                     "candidates": int(nvalid.sum())})

    # algl_merge_draws on phase 19's uniform pair
    if "algl_merge" in names:
        sa, ca, sb, cb, keys = cs.merge_timing_case(gen, dev)
        j_a, draws = uplain.merge_scan(ca, cb, keys, cs.K)
        steps = cs.merge_steps(ca, cb, cs.K)
        ab("algl_merge", f"pair [{cs.R}, {cs.K}]", None, lambda _: ukern.merge_draws_cuda(ca, cb, keys, cs.K),
           cs.merge_bound_ms(steps, draws, cs.R, cs.K), {"scan_steps": steps, "words_drawn": draws},
           setup=lambda: None)
        del sa, sb, j_a
        # algl_merge_draws_wide, where the old build has it: phase 19's
        # counts as WIDE words, and phase 38's counts past 2^32
        if all(hasattr(ctypes.CDLL(built[w]["algl_merge"][0]), "algl_merge_draws_wide") for w in built):
            wca, wcb = (cs.wide_planes(c.cpu().numpy().astype(np.uint64), dev) for c in (ca, cb))
            pa_h, pb_h = cs.wide_merge_counts(np.random.default_rng(38))
            pca, pcb = cs.wide_planes(pa_h, dev), cs.wide_planes(pb_h, dev)
            pkeys = split_keys(key_from_seed(38, device=dev), cs.R)
            for label, (a, b, kk) in (("phase 19's counts as WIDE words", (wca, wcb, keys)),
                                      ("counts past 2^32 (phase 38)", (pca, pcb, pkeys))):
                draws = uplain.merge_scan(a, b, kk, cs.K)[1]
                ab("algl_merge", f"wide pair [{cs.R}, {cs.K}], {label}", None,
                   lambda _, a=a, b=b, kk=kk: ukern.merge_draws_cuda(a, b, kk, cs.K),
                   cs.merge_bound_ms(cs.wide_merge_steps(a, b), draws, cs.R, cs.K, row_bytes=28, wide=True),
                   {"words_drawn": draws}, setup=lambda: None)

    # merge_ring_gather at phase 19's shape (4 ranks) and phase 43's (8)
    for d, rows, widths, seed in ((4, cs.R, (cs.K, None), 67), (8, cs.R // 8, (cs.K, None, None), 43)):
        if "merge_ring" not in names:
            break
        leaves = gather_leaves(gen, dev, d, rows, widths, seed)
        words = sum(t.numel() for t in leaves[0])
        label = f"{d} ranks of the card x {words} words"
        comms, got = {}, {}
        for which in ("old", "new"):
            use(which, "merge_ring")
            comms[which] = mkern.RingCommunicator([dev] * d)
            got[which] = mkern.gather_parts(leaves, comms[which])
            torch.cuda.synchronize()
            comms[which].check()
        want = mkern.gather_parts_plain(leaves, comms["new"])
        if not args.unchecked and cs.words_err(got["old"], want) != 0.0:
            sys.exit(f"FAIL: the old merge_ring_gather != gather_parts_plain at {label}")
        if cs.words_err(got["new"], want) != 0.0:
            sys.exit(f"FAIL: the new merge_ring_gather != gather_parts_plain at {label}")
        del got, want
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use(which, "merge_ring")
            times[which].append(cs.gather_times(leaves, comms[which]))
        use("new", "merge_ring")
        bound = 1e3 * (d + d * d) * words * 4 / cs.PEAK_BYTES
        results["tiles"].append({"kernel": "merge_ring", "tile": label, "bound_ms": bound, "bound_by": "bytes",
                                 "old_ms": [t["launch_ms"] for t in times["old"]],
                                 "new_ms": [t["launch_ms"] for t in times["new"]],
                                 "ms_note": "the bare launch", "old": times["old"], "new": times["new"]})
        for what in ("launch_ms", "call_ms", "call_1_ms", "host_ms"):
            o, n = [t[what] for t in times["old"]], [t[what] for t in times["new"]]
            print(f"[ab] {card} | merge_ring {label}, {what[:-3]}: old {o[0]:.4f} / {o[1]:.4f} ms, new "
                  f"{n[0]:.4f} / {n[1]:.4f} ms (old, new, new, old), bound {bound:.4f} ms (bytes)", flush=True)
        del leaves, comms

    def given_valid(s, t, v):
        """A tile given with ``valid`` (as every flush passes it): keep-max
        where the build has it, else the default, which such a tile ran
        before keep-max."""
        keep = hasattr(dkern._library(), "distinct_update_keepmax")
        return dkern.launch(s, t, None, v, None, dkern.KEEPMAX if keep else dkern.DEFAULT)

    # distinct_update on phase 15's tiles, each also given with valid = B
    for label, state, tile, wide in cs.distinct_timing_cases(gen, dev) if "distinct" in names else ():
        ref = dplain.update(state, tile)
        inserts, rows_in = cs.net_inserts(state, ref)
        bound = cs.distinct_bound_ms(tile.numel(), wide, inserts, rows_in)
        ab("distinct", label, state, lambda s, t=tile: dkern.update_cuda(s, t), bound,
           {"net_inserts": inserts, "rows_inserting": rows_in})
        full = torch.full((tile.shape[0],), tile.shape[1], dtype=torch.int32, device=dev)
        ab("distinct", f"{label}, valid = B", state, lambda s, t=tile, v=full: given_valid(s, t, v), bound,
           {"net_inserts": inserts, "rows_inserting": rows_in})

    # the pre-hashed kernel on phase 40's tiles, where both builds have it
    prehashed = "distinct" in names and all(
        hasattr(ctypes.CDLL(built[w]["distinct"][0]), "distinct_update_hashed") for w in built)
    for label, state, _, tile, hashes in cs.prehashed_timing_cases(gen, dev) if prehashed else ():
        ref = dplain.update_prehashed(state, tile, hashes)
        inserts, rows_in = cs.net_inserts_by_key(state, ref)
        ab("distinct", f"pre-hashed {label}", state,
           lambda s, t=tile, h=hashes: dkern.update_prehashed_cuda(s, t, h),
           cs.distinct_bound_ms(tile.numel(), False, inserts, rows_in, prehashed=True),
           {"net_inserts": inserts, "rows_inserting": rows_in})

    # the new build's keep-max (valid = B) and pre-hashed kernels at each
    # rows a block on the steady tiles, in turns (block_sweep.py records the
    # default's geometry only, which the engine applies to all three)
    if "distinct" in names:
        from reservoir_tpu_torch.ops.blocking import BLOCK_CHOICES

        _, steady, tile, _ = cs.distinct_timing_cases(gen, dev)[1]
        full = torch.full((tile.shape[0],), tile.shape[1], dtype=torch.int32, device=dev)
        _, pre_s, _, pre_tile, hashes = cs.prehashed_timing_cases(gen, dev)[0]
        cases = {"keep-max": (steady, tile, None, full, dkern.KEEPMAX),
                 "pre-hashed": (pre_s, pre_tile, hashes, None, dkern.HASHED)}
        results["rows_a_block"] = {}
        for rule_name, (st, t, h, v, rule) in cases.items():
            times = {b: [] for b in BLOCK_CHOICES["distinct"]}
            for turn in range(4):
                for b in (list(times) if turn % 2 == 0 else list(times)[::-1]):
                    times[b].append(cs.event_ms(lambda s, b=b: dkern.launch(s, t, h, v, b, rule),
                                                setup=lambda: cs.clone(st), batch=10))
            results["rows_a_block"][rule_name] = times
            print(f"[ab] {card} | distinct {rule_name} steady tile, rows a block: " + "; ".join(
                f"{b}: {', '.join(f'{x:.4f}' for x in ms)} ms" for b, ms in times.items()) + " (in turns)",
                flush=True)

    # weighted_update on phase 11's tiles
    for label, state, elems, weights in cs.weighted_timing_cases(dev) if "weighted" in names else ():
        _, accepts = wplain.update_accepts(cs.clone(state), elems, weights)
        fills = 0
        if "empty" in label:
            ref = wplain.update(cs.clone(state), elems, weights)
            fills = int((ref.lkeys > float("-inf")).sum().item())
        ab("weighted", label, state, lambda s, e=elems, w=weights: wkern.update_cuda(s, e, w),
           cs.weighted_bound_ms(accepts, fills, cs.WR * cs.WB), {"accepts": accepts, "fills": fills})

    results["median_old_over_new"] = {
        f"{r['kernel']} {r['tile']}": statistics.median(r["old_ms"]) / statistics.median(r["new_ms"])
        for r in results["tiles"]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"[ab] wrote {args.out}", flush=True)
    print(json.dumps({"ok": True, "tiles": len(results["tiles"])}))


if __name__ == "__main__":
    main()
