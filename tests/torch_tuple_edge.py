"""Show where the matcher's tuple test sits against its threshold.

    python tests/torch_tuple_edge.py [cuda|cpu|jax]

Registers chip_smoke.py's untilted seed-11 HDL-64E pair (131072 points per
scan) under path B's configuration and under ``recommended(max_voxels=
8192)``, and prints per configuration the matcher's candidates, the tuple
test's survivors, ``tuple_min_keep`` and the correspondences kept. The
matcher keeps the survivors when there are at least ``tuple_min_keep`` of
them, and all candidates otherwise, so a survivor count next to the
threshold decides between two very different correspondence sets.

``cuda`` (the default) runs the port on the card, where the front end is
the kernels; ``cpu`` runs the port on the CPU and ``jax`` the JAX package
on the CPU, both through the dense front end, which is what either
package takes on the CPU. To compare two trees, run the script from each
checkout.

``jax`` then asks where the survivor count moves, under path B's
configuration on the JAX package's segmented clouds (the port's are the
same bits): both packages' voxel grids, each through both packages' dense
front end and matcher; and the JAX package's own count when every
coordinate of the segmented clouds is moved by -1, 0 or +1 ulp at random
(seeds 0-5), the spread that rounding alone gives.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def run_port(device: str):
    import torch

    from quatro_tpu_torch.ops import matching
    from quatro_tpu_torch.pipeline import register_scan_pair

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    seen = []
    keep = matching.tuple_test_keep

    def recorder(*args, **kwargs):
        out = keep(*args, **kwargs)
        seen.append((int(args[2].sum()), int(out.sum())))
        return out

    matching.tuple_test_keep = recorder
    pairs, _, cfgs = chip_smoke.full_width_case()
    where = (torch.cuda.get_device_name(0) if device == "cuda" else
             f"the CPU, {torch.get_num_threads()} torch threads")
    for name in ("B", "recommended"):
        seen.clear()
        res = register_scan_pair(*pairs["raw"], cfgs[name], device=device)
        yield (f"port, {name}", seen[0], cfgs[name].fpfh.tuple_min_keep,
               int(res.correspondences.mask.sum()), where)


def run_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from quatro_tpu.config import FPFHConfig, PipelineConfig
    from quatro_tpu.io.synthetic import make_scan_pair
    from quatro_tpu.ops import matching
    from quatro_tpu.pipeline import register_scan_pair
    from quatro_tpu.types import PointBatch

    seen = []
    keep = matching.tuple_test_keep

    def recorder(cs, ct, cand_pos, ncorr, **kwargs):
        out = keep(cs, ct, cand_pos, ncorr, **kwargs)
        jax.debug.callback(lambda a, b: seen.append((int(a), int(b))),
                           jnp.sum(cand_pos), jnp.sum(out))
        return out

    matching.tuple_test_keep = recorder
    src, tgt, _ = make_scan_pair(**chip_smoke.PIPELINE_PAIR)
    pair = (PointBatch.from_numpy(src, capacity=chip_smoke.RAW_CAPACITY),
            PointBatch.from_numpy(tgt, capacity=chip_smoke.RAW_CAPACITY))
    cfgs = {"B": PipelineConfig(max_voxels=8192,
                                fpfh=FPFHConfig(crosscheck_min_matches=0)),
            "recommended": PipelineConfig.recommended(max_voxels=8192)}
    for name, cfg in cfgs.items():
        seen.clear()
        res = register_scan_pair(*pair, cfg)
        yield (f"JAX package, {name}", seen[0], cfg.fpfh.tuple_min_keep,
               int(np.asarray(res.correspondences.mask).sum()), "the CPU")
    yield from _jax_attribution(pair, cfgs["B"], seen)


def _jax_attribution(pair, cfg, seen):
    """The survivor count of each (voxel grid, front end and matcher)
    pairing of the two packages, and the JAX package's under one-ulp
    nudges of its input; ``seen`` records the JAX package's tuple tests."""
    import jax
    import jax.numpy as jnp
    import torch

    from quatro_tpu.ops import dense_features as jdf
    from quatro_tpu.ops import matching as jm
    from quatro_tpu.ops import voxel as jvox
    from quatro_tpu.pipeline import preprocess, register_features
    from quatro_tpu.types import PointBatch
    from quatro_tpu_torch.ops import dense_features as tdf
    from quatro_tpu_torch.ops import matching as tm
    from quatro_tpu_torch.ops import voxel as tvox

    f = cfg.fpfh
    match_kw = dict(capacity=f.max_correspondences,
                    use_crosscheck=f.use_crosscheck,
                    crosscheck_min_matches=f.crosscheck_min_matches,
                    use_tuple_test=f.use_tuple_test,
                    tuple_scale=f.tuple_scale,
                    trials_per_corr=f.tuple_trials_per_corr,
                    tuple_min_keep=f.tuple_min_keep, seed=f.tuple_seed)
    clouds = [(np.asarray(b.points), np.asarray(
        jax.jit(preprocess, static_argnames=("config",))(
            b.points, b.mask, cfg)[0])) for b in pair]

    @jax.jit
    def jax_match(vox, vmask):
        def feats(p, m):
            nrm = jdf.dense_normals(p, m, f.normal_radius)
            return (jdf.dense_fpfh(p, nrm.normals, nrm.valid, m,
                                   f.fpfh_radius), m & nrm.valid)
        desc, dmask = jax.vmap(feats)(vox, vmask)
        return jm.match_features(vox[0], vox[1], desc[0], desc[1], dmask[0],
                                 dmask[1], **match_kw).mask

    port_seen = []
    keep = tm.tuple_test_keep

    def recorder(*args, **kwargs):
        out = keep(*args, **kwargs)
        port_seen.append((int(args[2].sum()), int(out.sum())))
        return out

    tm.tuple_test_keep = recorder

    def port_match(vox, vmask):
        nrm = tdf.dense_normals(vox, vmask, f.normal_radius)
        desc = tdf.dense_fpfh(vox, nrm.normals, nrm.valid, vmask,
                              f.fpfh_radius)
        dmask = vmask & nrm.valid
        return tm.match_features(vox[0], vox[1], desc[0], desc[1], dmask[0],
                                 dmask[1], **match_kw, device="cpu").mask

    grids = {}
    for name in ("JAX package", "port"):
        vox = []
        for pts, seg in clouds:
            if name == "port":
                v = tvox.voxel_downsample(
                    torch.from_numpy(pts.copy()), torch.from_numpy(seg.copy()),
                    cfg.voxel_size, cfg.max_voxels,
                    active_cap=cfg.max_segment_points)
            else:
                v = jax.jit(jvox.voxel_downsample, static_argnames=(
                    "voxel_size", "capacity", "active_cap"))(
                    jnp.asarray(pts), jnp.asarray(seg), cfg.voxel_size,
                    cfg.max_voxels, active_cap=cfg.max_segment_points)
            vox.append(tuple(np.asarray(t) for t in v))
        grids[name] = (np.stack([v[0] for v in vox]),
                       np.stack([v[1] for v in vox]))
    same = [int((grids["JAX package"][0][b] != grids["port"][0][b]).any(
        1).sum()) for b in range(2)]
    where = (f"the CPU; the voxel grids' masks equal: "
             f"{np.array_equal(grids['JAX package'][1], grids['port'][1])}, "
             f"voxels whose centroid differs: {same}")
    for grid, (vox, vmask) in grids.items():
        seen.clear()
        kept = int(np.asarray(jax_match(jnp.asarray(vox),
                                        jnp.asarray(vmask))).sum())
        yield (f"B, {grid} voxels, JAX package front end and matcher",
               seen[0], f.tuple_min_keep, kept, where)
        port_seen.clear()
        kept = int(port_match(torch.from_numpy(vox),
                              torch.from_numpy(vmask)).sum())
        yield (f"B, {grid} voxels, port front end and matcher",
               port_seen[0], f.tuple_min_keep, kept, where)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        nudged = []
        for pts, seg in clouds:
            step = rng.integers(-1, 2, pts.shape)
            p = np.where(step > 0, np.nextafter(pts, np.float32(np.inf)),
                         np.where(step < 0, np.nextafter(
                             pts, np.float32(-np.inf)), pts))
            nudged.append(PointBatch(jnp.asarray(p.astype(np.float32)),
                                     jnp.asarray(seg)))
        seen.clear()
        res = register_features(*nudged, cfg)
        yield (f"B, JAX package, segmented clouds nudged by one ulp (seed "
               f"{seed})", seen[0], f.tuple_min_keep,
               int(np.asarray(res.correspondences.mask).sum()), "the CPU")


def main(mode: str = "cuda") -> int:
    runs = run_jax() if mode == "jax" else run_port(mode)
    for name, (cand, survivors), min_keep, kept, where in runs:
        print(f"{name}: {cand} candidates, {survivors} tuple-test "
              f"survivors, tuple_min_keep {min_keep}, {kept} "
              f"correspondences kept; {where}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
