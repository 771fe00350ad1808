"""Time B6 (1-NN) and B12 (table lookup) on the card.

    python tests/torch_nn_table_timing.py [tree]

Imports ``quatro_tpu_torch`` from ``tree`` (default: this checkout), so
that two trees can be timed in turns on one card, each in its own process
(for example the parent commit unpacked by ``git archive`` into a
git-ignored directory: parent, this tree, this tree, parent). Builds the
two kernels from that tree's sources, then on inputs made from fixed seeds:

* B6 on (1, 8192, 33) descriptors in [0, 12) at path B's occupancy: the
  valid rows packed at the front as the voxel grid leaves them (2429 of
  the first 2600 source rows, 2172 of the first 2330 target rows, the
  invalid ones scattered among them); then every row valid (8192 x 8192,
  no limit cuts anything) and no valid source row (every block exits: the
  cost of the grid alone);
* B12 at the Patchwork shapes (B 2, N 131072, a 512 x 5 table, ids in
  [-8, 520), so some out of range), and at N 131071 (rows of the output
  start at every 4-byte offset, and the last thread's points are ragged).

Each call is checked bit for bit against the plain version on CPU
copies. It prints the card's name and power limit, then per case the
wrapper's call time (CUDA events over 200 calls) and the device time per
call (torch.profiler over 50 calls: every device event the call runs, at
its mean time, times its launches per call), and the share of it that the
port's own kernel takes ("kernel_ms"; B6's wrapper also runs the norms,
the float masks, the limits and the fill of empty rows). Last, the
one-element ``fill_``, the smallest kernel torch launches.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TREE = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else \
    Path(__file__).resolve().parent.parent
sys.path.insert(0, str(TREE))

from quatro_tpu_torch import _build  # noqa: E402
from quatro_tpu_torch.ops import frontend as tf  # noqa: E402
from quatro_tpu_torch.ops import segment  # noqa: E402

CALLS = 200
PROFILED = 50
V = 8192


def call_ms(fn):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(CALLS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / CALLS


def device_ms(fn):
    """(device ms per call, the port's kernels' share of it, {event:
    launches per call})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    hits = [(e.key, e.self_device_time_total / e.count,
             -(-e.count // PROFILED)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
    return (sum(t * k for _, t, k in hits) / 1e3,
            sum(t * k for name, t, k in hits if "quatro::" in name) / 1e3,
            {name.split("(")[0][-48:]: k for name, _, k in hits})


def case(name, fn, check=None):
    got = fn()
    if check is not None and not check(got):
        raise SystemExit(f"{name}: differs from the plain version")
    dev, kernel, launches = device_ms(fn)
    print(json.dumps({"case": name, "call_ms": round(call_ms(fn), 6),
                      "device_ms": round(dev, 6), "kernel_ms": round(kernel, 6),
                      "launches": launches}), flush=True)


def packed_mask(rng, region, valid):
    """(V,) bool: ``valid`` True entries among the first ``region``, the
    last of them True (so the limit is ``region``)."""
    m = np.zeros(V, bool)
    on = rng.choice(region - 1, valid - 1, replace=False)
    m[on] = True
    m[region - 1] = True
    return m


def nn_cases(dev):
    rng = np.random.default_rng(6)
    da = rng.uniform(0, 12, (1, V, 33)).astype(np.float32)
    db = rng.uniform(0, 12, (1, V, 33)).astype(np.float32)
    a, b = (torch.from_numpy(x).to(dev) for x in (da, db))
    path_b = (packed_mask(rng, 2600, 2429), packed_mask(rng, 2330, 2172))
    full = (np.ones(V, bool), np.ones(V, bool))
    empty = (np.zeros(V, bool), path_b[1])
    for label, (ma, mb) in (("path B occupancy", path_b),
                            ("every row valid", full),
                            ("no valid source row", empty)):
        ma_t, mb_t = (torch.from_numpy(m)[None].to(dev) for m in (ma, mb))
        ri, rd = tf.nearest_neighbors_plain(
            a.cpu(), b.cpu(), ma_t.float().cpu(), mb_t.float().cpu(),
            (a * a).sum(-1).cpu(), (b * b).sum(-1).cpu())
        empty_rows = ~ma_t.cpu() | (rd >= tf.FLT_MAX)
        ri, rd = torch.where(empty_rows, 0, ri), torch.where(empty_rows,
                                                             tf.FLT_MAX, rd)

        def same(got):
            return torch.equal(got[0].cpu(), ri) and torch.equal(
                got[1].cpu(), rd)
        case(f"nearest_neighbors {label} ({int(ma.sum())} x "
             f"{int(mb.sum())} valid)",
             lambda: tf.nearest_neighbors(a, b, ma_t, mb_t), same)


def table_cases(dev):
    rng = np.random.default_rng(12)
    for n in (131072, 131071):
        ids = torch.from_numpy(rng.integers(-8, 520, (2, n)).astype(
            np.int32)).to(dev)
        tab = torch.from_numpy(rng.normal(0, 1, (2, 512, 5)).astype(
            np.float32)).to(dev)
        ref = segment.table_lookup_plain(ids.cpu(), tab.cpu())
        case(f"table_lookup B 2 N {n} 512 x 5",
             lambda: segment.table_lookup(ids, tab),
             lambda got: torch.equal(got.cpu(), ref))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], "| tree", TREE, flush=True)
    info = _build.build(["nn1", "table_lookup"], force=True)
    for name, rec in info.items():
        print(name, rec["ptxas"].replace("\n", " | "), flush=True)
    dev = torch.device("cuda")
    nn_cases(dev)
    table_cases(dev)
    one_float = torch.zeros(1, device=dev)
    case("floor: one-element fill_", lambda: one_float.fill_(1.0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
