"""Time two builds of the distinct and weighted kernels in turns on one card.

    python3 kernel_ab.py --old DIR [--out FILE]

``DIR`` holds another version of ``reservoir_tpu_torch/csrc`` (for example
the parent commit's, from ``git archive``, or a variant of this one); its
``distinct.cu`` and ``weighted.cu`` must keep the C entry points
``distinct_update`` and ``weighted_update`` with their arguments.  The
script builds those two files of both versions with the port's own nvcc
flags (plus ``-Xptxas -v``) into ``reservoir_tpu_torch/_build/ab/``, all at
once, loads each build through its wrapper (``_library(path)`` of
``ops/distinct_cuda.py`` and ``ops/weighted_cuda.py``), and then, at
``chip_smoke.py``'s shapes and on its tiles, times old and new in turns
(old, new, new, old) with ``chip_smoke.event_ms``:

- ``distinct_update`` (R = 4,096, k = 256, B = 1,024) on phase 15's tiles
  (``chip_smoke.distinct_timing_cases``): Zipf tiles from empty and after 8
  Zipf tiles, int32 and int64, and fresh random keys after 8 (int32);
- ``weighted_update`` (R = 16,384, k = 64, B = 1,024) on phase 11's tiles
  (``chip_smoke.weighted_timing_cases``): the fill tile from empty, the
  steady tile from count 7 B, and that tile with every weight 0.

Each tile is first run once by both builds, and their states must be
bit-identical.  Each build's registers, spills and static shared memory
(``-Xptxas -v``) are printed, and for the checkout's build its
``kernel_info`` at the launch shape (shared memory and resident warps an
SM), with the card's name and power limit and each tile's bound
(``chip_smoke``'s bound functions); the whole goes to ``--out`` as JSON.
It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("distinct", "weighted")


def build(dirs: dict, out_dir: str) -> dict:
    """Compile ``distinct.cu`` and ``weighted.cu`` of each ``{tag: csrc
    directory}``, all in parallel; returns ``{tag: {name: (library path,
    ptxas lines)}}``."""
    from reservoir_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, csrc in dirs.items():
        for name in KERNELS:
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
                                  if "update_kernel" in ln or "registers" in ln or "spill" in ln])
    return built


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory with the old csrc sources")
    ap.add_argument("--out", default=os.path.join(HERE, "reservoir_tpu_torch", "_build", "ab", "kernel_ab.json"),
                    help="where the JSON of times and builds goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    card = cs.card_line()
    dev = torch.device("cuda")
    built = build({"old": args.old, "new": os.path.join(HERE, "reservoir_tpu_torch", "csrc")},
                  os.path.join(HERE, "reservoir_tpu_torch", "_build", "ab"))
    modules = {"distinct": dkern, "weighted": wkern}

    def use(which: str, name: str) -> None:
        """Make ``which`` build the one the wrapper of ``name`` launches."""
        modules[name]._library(built[which][name][0])

    for name in KERNELS:
        use("new", name)
    results = {"card": card, "tiles": [],
               "ptxas": {which: {n: lines for n, (_, lines) in b.items()} for which, b in built.items()},
               "kernel_info_new": {"distinct": dkern.kernel_info(cs.DK, False),
                                   "distinct_wide": dkern.kernel_info(cs.DK, True),
                                   "weighted": wkern.kernel_info(cs.WK)}}
    print(f"[ab] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for which, lines_of in results["ptxas"].items():
        for n, lines in lines_of.items():
            for ln in lines:
                print(f"[ab ptxas] {which} {n}: {ln}", flush=True)
    for n, info in results["kernel_info_new"].items():
        print(f"[ab build] new {n}: {cs.build_text(info)}", flush=True)

    def ab(name: str, label: str, state, step, bound: tuple, extra: dict) -> None:
        """Check old and new agree on this tile, then time them in turns:
        old, new, new, old."""
        got = {}
        for which in ("old", "new"):
            use(which, name)
            got[which] = step(cs.clone(state))
        torch.cuda.synchronize()
        if not cs.same(got["old"], got["new"]):
            sys.exit(f"FAIL: old and new {name} differ on the {label}")
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use(which, name)
            times[which].append(cs.event_ms(step, setup=lambda: cs.clone(state), batch=10))
        use("new", name)
        results["tiles"].append({"kernel": name, "tile": label, "old_ms": times["old"], "new_ms": times["new"],
                                 "bound_ms": bound[0], "bound_by": bound[1], **extra})
        print(f"[ab] {card} | {name} {label}: old {times['old'][0]:.4f} / {times['old'][1]:.4f} ms, new "
              f"{times['new'][0]:.4f} / {times['new'][1]:.4f} ms (old, new, new, old), bound "
              f"{bound[0]:.4f} ms ({bound[1]})", flush=True)

    # distinct_update on phase 15's tiles
    gen = torch.Generator(device=dev)
    for label, state, tile, wide in cs.distinct_timing_cases(gen, dev):
        ref = dplain.update(state, tile)
        inserts, rows_in = cs.net_inserts(state, ref)
        bound = cs.distinct_bound_ms(tile.numel(), wide, inserts, rows_in)
        ab("distinct", label, state, lambda s, t=tile: dkern.update_cuda(s, t), bound,
           {"net_inserts": inserts, "rows_inserting": rows_in})

    # weighted_update on phase 11's tiles
    for label, state, elems, weights in cs.weighted_timing_cases(dev):
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
