"""Each warp's walk in B4 and B5 on the main path's voxels.

    python tests/torch_fpfh_walks.py

csrc/spfh.cu and csrc/fpfh.cu give one warp to each 32-row tile, and the
warp walks the column tiles that ``tiles_in_radius`` keeps against it, so
a warp's time is its own walk and the heaviest warp sets the kernel's.
This script registers chip_smoke.py's path A pair on the card (the
seed-11 HDL-64E pair, tilted, under ``recommended(max_voxels=8192)``),
takes its voxels and the front end's pair mask (valid voxels with a
valid normal) and prints, per cloud, over the live row tiles: the column
tiles each walks, the columns that some of its 32 rows have within the
FPFH radius, and its in-radius pairs (mean and max of each), beside the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from quatro_tpu_torch.ops import frontend as fe  # noqa: E402
from quatro_tpu_torch.pipeline import register_scan_pair  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    pairs, _, cfgs = chip_smoke.full_width_case()
    cfg = cfgs["A"]
    res = register_scan_pair(*pairs["tilted"], cfg)
    pts = torch.stack([res.src_voxels.points,
                       res.tgt_voxels.points]).contiguous()
    mask = torch.stack([res.src_voxels.mask, res.tgt_voxels.mask])
    rf = cfg.fpfh.fpfh_radius
    normals = fe.frontend_normals(pts, mask, cfg.fpfh.normal_radius)
    pmask = (mask & normals.valid).cpu()
    pts = pts.cpu()
    bb = fe.tile_bounds(pts, pmask.float())
    passing = fe.tiles_in_radius(bb, bb, rf)
    r2 = fe._r2(rf, pts)
    for b, limit in enumerate(fe.active_limit(pmask).tolist()):
        n = -(-limit // fe.PAIR_TILE)
        walks = passing[b, :n, :n].sum(1).double()
        cols, pairs_in = [], []
        for rt in range(n):
            tile = slice(rt * fe.PAIR_TILE, (rt + 1) * fe.PAIR_TILE)
            _, d2 = fe._pair_geometry(pts[b, tile], pts[b])
            near = (pmask[b, tile, None] & pmask[b, None, :] & (d2 <= r2)
                    & (d2 > 1e-12))
            cols.append(int(near.any(0).sum()))
            pairs_in.append(int(near.sum()))
        cols_t = torch.tensor(cols, dtype=torch.float64)
        pairs_t = torch.tensor(pairs_in, dtype=torch.float64)
        print(f"cloud {b}: {n} live row tiles at {rf} m; column tiles "
              f"walked mean {float(walks.mean()):.2f} max "
              f"{int(walks.max())}; columns with a row in radius mean "
              f"{float(cols_t.mean()):.1f} max {int(cols_t.max())}; "
              f"in-radius pairs mean {float(pairs_t.mean()):.1f} max "
              f"{int(pairs_t.max())}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
