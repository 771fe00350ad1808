"""Time B9's chunk on the card.

    python tests/torch_fit_chunk_timing.py [rounds]

csrc/fit_iteration_moments.cu sums chunks of ``chunk`` points, an argument
of its launcher (ops/segment.py passes FIT_CHUNK; the order of the sums,
and so the bits, follow it). This script takes the three plane-fit calls
of the main path (the seed-11 HDL-64E pair tilted as chip_smoke.py's path
A, Patchwork under ``recommended(max_voxels=8192)``), launches the kernel
that ``_build.py`` builds at each chunk (512, 1024, 2048), checks that
each gives the plain version's bits at that chunk on every call, and times
the launch's three kernels (the limit pre-pass, the partial sums and the
chunk sum) by their device time from torch.profiler over 50 launches (a
host-clock or CUDA-event time of back-to-back launches would measure the
ctypes call), chunk by chunk in turns, forwards then backwards, for
``rounds`` rounds (default 3). It prints the card's name and power limit
and the mean device ms per launch of each chunk and call.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from quatro_tpu_torch import _build  # noqa: E402
from quatro_tpu_torch.ops import segment  # noqa: E402

REPS = 50
CHUNKS = (512, 1024, 2048)


def launcher(ids, chan, tab, p_pad, p_cnt, exact, chunk):
    fn = _build.load("fit_iteration_moments")
    bsz, _, n = chan.shape
    out = torch.empty((bsz, p_pad, 10), device=chan.device)
    lim = torch.empty((bsz,), dtype=torch.int32, device=chan.device)
    partial = torch.empty((bsz, -(-n // chunk), p_pad, 10),
                          device=chan.device)
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in (
        ids, chan, tab, bsz, n, p_pad, p_cnt, int(exact), chunk, lim,
        partial, out)]

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return out
    return run


def main(rounds: int = 3) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    pairs, _, cfgs = chip_smoke.full_width_case()
    calls = chip_smoke.capture_preprocessing(pairs["tilted"], cfgs["A"])
    fits = calls["fit_iteration_moments"]
    keys = [(chunk, k) for chunk in CHUNKS for k in range(len(fits))]
    runs = {}
    for chunk, k in keys:
        (ids, chan, tab, p_pad, p_cnt), kw = fits[k]
        mom = segment.fit_moment_channels(ids.cpu(), chan.cpu(), tab.cpu(),
                                          p_cnt, kw["exact"])
        ref = torch.stack([segment.segment_sums_plain(ids[b].cpu(), mom[b],
                                                      p_pad, chunk)
                           for b in range(ids.shape[0])])
        runs[chunk, k] = launcher(ids, chan, tab, p_pad, p_cnt, kw["exact"],
                                  chunk)
        if not torch.equal(runs[chunk, k]().cpu(), ref):
            raise AssertionError(f"chunk {chunk}, call {k}: differs from "
                                 "the plain version")
    times = {key: [] for key in keys}
    for _ in range(rounds):
        for key in keys + keys[::-1]:
            times[key].append(chip_smoke.device_ms_per_call(
                runs[key], "quatro::", REPS,
                main=("quatro::fit_partials_kernel", 1)))
    for (chunk, k), ms in sorted(times.items()):
        ms = [t for t in ms if t is not None]   # None: not measured
        if not ms:
            print(f"chunk {chunk}, call {k}: not measured; {card}")
            continue
        print(f"chunk {chunk}, call {k}: {sum(ms) / len(ms):.6f} ms per "
              f"launch (min {min(ms):.6f}, max {max(ms):.6f}, {len(ms)} x "
              f"{REPS} launches); {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
