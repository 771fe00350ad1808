"""Time B1 (consistency graph) and B2 (segment sums) on the card.

    python tests/torch_segment_graph_timing.py [tree]

Imports ``quatro_tpu_torch`` from ``tree`` (default: this checkout), so
that two trees can be timed in turns on one card, each in its own process
(for example the parent commit unpacked by ``git archive`` into a
git-ignored directory: parent, this tree, this tree, parent). Builds the
two kernels from that tree's sources, then on inputs made from fixed seeds:

* B1 on 1024 synthetic correspondences (``make_correspondences``, 300
  inliers) and on their first 1000 (rows that start inside a 16-byte
  piece of the output);
* B2 at the vote's shape, on the vote's own entries for those
  correspondences (64 anchors x 1024, K 3, 256 bins), at the same shape
  with every entry in one bin (each chunk's run is all of it), and at the
  pose graph's J^T apply (the two ends of 19 edges of a 12-pose loop, K 4,
  12 poses).

Each call is checked bit for bit against the plain version on CPU copies.
It prints the card's name and power limit, then per case the wrapper's
call time (CUDA events over 200 calls) and the device time per call
(torch.profiler over 50 calls: every device event the call runs, at its
mean time, times its launches per call; the profiler misses the first
event of a profiled run). The launches per call are printed too. Last,
the floor both kernels sit near: the same two times for a one-element
``fill_``, the smallest kernel torch launches.
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
from quatro_tpu_torch.io.synthetic import make_correspondences  # noqa: E402
from quatro_tpu_torch.ops import kernels, segment  # noqa: E402
from quatro_tpu_torch.solver import vote  # noqa: E402

CALLS = 200
PROFILED = 50


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
    """(device ms per call, {event: launches per call})."""
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
            {name.split("(")[0]: k for name, _, k in hits})


def case(name, fn, plain=None, cpu_args=()):
    got = fn()
    if plain is not None and not torch.equal(got.cpu(), plain(*cpu_args)):
        raise SystemExit(f"{name}: differs from the plain version")
    dev, launches = device_ms(fn)
    print(json.dumps({"case": name, "call_ms": round(call_ms(fn), 6),
                      "device_ms": round(dev, 6), "launches": launches}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], "| tree", TREE, flush=True)
    _build.build(["consistency_graph", "segment_sums"], force=True)
    dev = torch.device("cuda")
    src, tgt, _, _ = make_correspondences(seed=0, n_inliers=300,
                                          n_outliers=724)
    src, tgt = (torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (src, tgt))
    beta = 2.0 * 0.3
    for n in (1024, 1000):
        s, t = src[:n].contiguous(), tgt[:n].contiguous()
        case(f"consistency_graph N {n}",
             lambda: kernels.consistency_graph(s, t, beta),
             kernels.consistency_graph_plain, (s.cpu(), t.cpu(), beta))

    mask = torch.ones(1024, dtype=torch.bool, device=dev)
    adj = kernels.consistency_graph(src, tgt, beta) & ~torch.eye(
        1024, dtype=torch.bool, device=dev)
    ids, vals = vote.yaw_vote_entries(src, tgt, mask, adj)
    one = torch.full_like(ids, 77)
    rng = np.random.default_rng(12)
    ei = np.int32(list(range(11)) + [0, 1, 2, 3, 5, 6, 7, 8])
    ej = np.int32(list(range(1, 12)) + [11, 10, 9, 8, 11, 10, 9, 11])
    pg_ids = torch.from_numpy(np.concatenate([ei, ej])).to(dev)
    pg_vals = torch.from_numpy(rng.normal(0, 1, (4, 38)).astype(
        np.float32)).to(dev)

    def plain(i, v, p):
        return segment.segment_sums_plain(i, v, p, segment.SEG_CHUNK)

    for name, i, v, p in (("segment_sums vote", ids, vals, 256),
                          ("segment_sums one bin", one, vals, 256),
                          ("segment_sums pose graph", pg_ids, pg_vals, 12)):
        case(f"{name} N {i.shape[0]} K {v.shape[0]} p_pad {p}",
             lambda: segment.segment_sums(i, v, p), plain,
             (i.cpu(), v.cpu(), p))
    one_float = torch.zeros(1, device=dev)
    case("floor: one-element fill_", lambda: one_float.fill_(1.0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
