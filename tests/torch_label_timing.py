"""Device time of the labelling kernel on the main path's images, by
sweep kind, for any tree of the repository.

    python tests/torch_label_timing.py [tree]

``tree`` is a checkout whose ``ops/labels.label_sweeps`` is the one-launch
labelling (default: this one), e.g. a copy unpacked under ``build/``; its
package is imported and its kernels are built, while the inputs come from
this checkout's ``chip_smoke.py``: path A's labelling call (the tilted
seed-11 HDL-64E pair, recorded by ``capture_preprocessing``) and path P's
B = 64 call (recorded from ``register_scan_pair`` on bench.py's 8 pairs
cycled to 64: 128 images). Prints the card's name and power limit, then one JSON
line per case with the layout, each image's rounds and the ms per call
(CUDA events, 20 calls after a warm-up) of: the whole labelling; one round
(max_iters 1) of the whole schedule; one round of each kind of sweep
alone (the diagonal walks, the dr = 0 row scans, the dc = 0 column
walks, with their own masks). Compare two trees only within one command
on one card, in the order parent, change, change, parent.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_label_timing: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import quatro_tpu_torch
    from quatro_tpu_torch import _build
    from quatro_tpu_torch.ops.labels import label_layout, label_sweeps
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.preprocessing import projection
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {tree}; package {quatro_tpu_torch.__file__}",
          flush=True)
    _build.build()
    dev = torch.device("cuda")

    pairs, _, cfgs = cs.full_width_case()
    calls = cs.capture_preprocessing(pairs["tilted"], cfgs["A"])
    cases = {"A": calls["label_sweeps"][0][0]}
    scans, cfg_p = cs.bench_case()
    big = [cs.pair_batch([scans[i % len(scans)][k] for i in range(64)], dev)
           for k in (0, 1)]
    with cs.recorded(projection, "label_sweeps", []) as recs:
        register_scan_pair(*big, cfg_p)
    cases["P64"] = recs[0][0]
    del recs, big

    for name, args in cases.items():
        labels, valid, masks, sweeps, max_iters, npix = args[:6]
        kinds = {"diagonal": [k for k, (dr, dc, _) in enumerate(sweeps)
                              if dr and dc],
                 "rows": [k for k, (dr, _, _) in enumerate(sweeps) if not dr],
                 "columns": [k for k, (dr, dc, _) in enumerate(sweeps)
                             if dr and not dc]}
        runs = {"whole": (masks, sweeps, max_iters),
                "one_round": (masks, sweeps, 1)}
        for kind, ks in kinds.items():
            if ks:
                runs[f"one_round_{kind}"] = ([masks[k] for k in ks],
                                             [sweeps[k] for k in ks], 1)
        out = {"case": name, "tree": str(tree),
               "shape": list(labels.shape),
               "layout": label_layout(*labels.shape),
               "rounds": label_sweeps(*args[:6])[1].tolist()}
        for run, (m, s, it) in runs.items():
            out[f"{run}_ms"] = round(cs.cuda_ms(
                lambda: label_sweeps(labels, valid, m, s, it, npix)), 4)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
