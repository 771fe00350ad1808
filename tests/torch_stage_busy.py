"""Stage split and device busy time per stage of the port's main path, on
the card, for any tree of the repository.

    python tests/torch_stage_busy.py [tree] [--cc-chunks 2,4,8] [--cases A,P64]

``tree`` is a checkout of the repository (default: this one), e.g. an
earlier commit unpacked with ``git archive`` into ``build/``; its
``quatro_tpu_torch`` package is imported and its kernels are built, while
the measuring code is this checkout's ``chip_smoke.py``. Prints the
card's name and power limit, then one JSON line per case:

* ``A``: ``register_scan_pair`` on chip_smoke.py's path A pair and
  configuration (the tilted seed-11 HDL-64E pair, ground alignment and
  ICP), after two warm-up calls;
* ``P64``: bench.py's 8 pairs cycled to B = 64 as one call under its
  configuration, after a warm-up call.

Each line holds the call's host wall ms (median of 3), every stage's ms
(CUDA events) and device busy ms (torch.profiler in one more call, the
device events between marker fills at the stage ends), every stage's
device time and device launches by kernel (the largest first), each
stage's device ms and launch count, with the labelling's kernels', the
overlap's kernels' and the port's own kernels' in the projection, in
Patchwork, in the cliques, in ICP, in matching and in the vote
(``quatro::``) sums, the device's busy
total and idle share, the peak memory and the labelling loop's counters
(rounds, flag reads, replays; empty where the labelling is one kernel
launch) of the timed call. With ``--cc-chunks`` both cases run once for
each labelling chunk (``projection.CC_CHUNK``, the rounds between two
flag reads of a tree whose labelling is a device loop on the card; a
later tree keeps its chunk in ``ops/labels.py`` for the CPU's route
alone), in the order given. ``--cases A`` runs path A alone. To compare
two trees, run both in one command on one card: parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stage_busy: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--cc-chunks", default=None,
                    help="comma-separated labelling chunks (default: the "
                    "tree's CC_CHUNK)")
    ap.add_argument("--cases", default="A,P64",
                    help="comma-separated cases to run, of A and P64")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import quatro_tpu_torch
    from quatro_tpu_torch import _build
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.preprocessing import projection
    from quatro_tpu_torch.utils import loops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {tree}; package {quatro_tpu_torch.__file__}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()

    names = args.cases.split(",")
    dev = torch.device("cuda")
    cases = {}
    if "A" in names:
        pairs, _, cfgs = cs.full_width_case()
        cases["A"] = (tuple(p.to(dev) for p in pairs["tilted"]), cfgs["A"])
    if "P64" in names:
        scans, cfg_p = cs.bench_case()
        cases["P64"] = (tuple(
            cs.pair_batch([scans[i % len(scans)][k] for i in range(64)], dev)
            for k in (0, 1)), cfg_p)
    chunks = ([int(c) for c in args.cc_chunks.split(",")]
              if args.cc_chunks else [getattr(projection, "CC_CHUNK", None)])
    for chunk, (name, (pair, cfg)) in ((c, case) for c in chunks
                                       for case in cases.items()):
        if chunk is not None:       # a tree with no chunk on the card
            projection.CC_CHUNK = chunk
        for _ in range(2):
            register_scan_pair(*pair, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            register_scan_pair(*pair, cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        timer = cs.StageTimer()
        loops.reset_loops()
        register_scan_pair(*pair, cfg, timer=timer)
        labelling = dict(loops.LOOPS.get("label_components", {}))
        stages = timer.split_ms()
        by_kernel = {}
        busy = cs.stage_device_busy(lambda timer: register_scan_pair(
            *pair, cfg, timer=timer), by_kernel=by_kernel)
        split = {st: sorted(([cs.short_kernel_name(k), n, round(ms, 4)]
                             for k, (n, ms) in kernels.items()),
                            key=lambda r: -r[2])
                 for st, kernels in by_kernel.items()}
        wall = sorted(walls)[1]
        total = None if busy is None else sum(busy.values())
        print(json.dumps({
            "case": name, "tree": str(tree), "cc_chunk": chunk,
            "labelling_loop": labelling, "wall_ms": round(wall, 3),
            "labelling_device_ms": round(sum(
                r[2] for r in split.get("projection", [])
                if "label_sweep" in r[0]), 4),
            "overlap_device_ms": round(sum(
                r[2] for r in split.get("arbitration", [])
                if "overlap_" in r[0]), 4),
            "projection_own_kernels_ms": round(sum(
                r[2] for r in split.get("projection", [])
                if "quatro::" in r[0]), 4),
            "patchwork_own_kernels_ms": round(sum(
                r[2] for r in split.get("patchwork", [])
                if "quatro::" in r[0]), 4),
            "cliques_own_kernels_ms": round(sum(
                r[2] for r in split.get("cliques", [])
                if "quatro::" in r[0]), 4),
            "icp_own_kernels_ms": round(sum(
                r[2] for r in split.get("icp", [])
                if "quatro::" in r[0]), 4),
            "matching_own_kernels_ms": round(sum(
                r[2] for r in split.get("matching", [])
                if "quatro::" in r[0]), 4),
            "vote_own_kernels_ms": round(sum(
                r[2] for r in split.get("vote", [])
                if "quatro::" in r[0]), 4),
            "stage_device_ms": {st: round(sum(r[2] for r in rows), 4)
                                for st, rows in split.items()},
            "stage_launches": {st: sum(r[1] for r in rows)
                               for st, rows in split.items()},
            "kernels": {st: rows[:12] for st, rows in split.items()},
            "walls_ms": [round(w, 3) for w in walls],
            "stages": {k: {"ms": round(v, 3), "device_busy_ms":
                           None if busy is None else busy.get(k)}
                       for k, v in stages.items()},
            "device_busy_ms": None if total is None else round(total, 3),
            "idle_share": None if total is None else round(
                1.0 - total / wall, 4),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30,
                              3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
