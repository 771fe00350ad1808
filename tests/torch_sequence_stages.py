"""Stage by stage, where the port's loop rounds apart from the JAX package.

    PYTHONPATH=. python tests/torch_sequence_stages.py [frames] [--chain]
        [--jax-ground] [--jax-normals] [--jax-fpfh]

Runs the loop of ``tests/test_torch_sequence.py::test_run_sequence_bands``
(``make_synthetic_sequence(num_poses=12, seed=1, radius=6.0)`` at VLP-16
scale, 32768 raw points, ``max_voxels=2048``, 512 correspondences; edges
(k, k + 1) and the (0, 11) closure) through both packages on the CPU,
frame by frame. Every stage of the port gets the JAX package's outputs of
the stages before it, so a stage's count is its own rounding and not an
earlier one's. The JAX package's stages are each compiled with
``jax.jit``; the script also checks that its chain of stages gives the
descriptors of its own whole-frame compiled extraction. The stages:

1. Patchwork ground mask (``estimate_ground``), with two of its parts
   apart: the plane fits' moment sums (the port's ``fit_iteration_moments``
   on the JAX package's ids, channels and tables of each fit) and the
   covariances (the port's ``plane_covariance`` on the JAX package's
   sums, and beside it the count for ``centered_covariance``'s single
   rounding), each against what the JAX package's compiled
   estimate_ground computed (recorded from inside it);
2. range image and segments (``segment_cloud`` on the non-ground mask);
3. leveling (``frame_leveling``, only where the configuration turns it on);
4. voxel grid (``voxel_downsample``);
5. normals (``dense_normals``: the front end either package takes on the
   CPU at these sizes), with the covariances that each package's
   dense_normals hands its eigen solve apart (recorded from inside both)
   and, as a yardstick, the entries in which the JAX package's own
   normals differ between its ``extract_features`` compile and its
   ``dense_normals`` compile;
6. SPFH and FPFH (``dense_fpfh``);
7. matches (``match_features``);
8. the solved edge pose and its gate (``register_correspondences``, the
   inlier count and the overlap of ``run_sequence``).

It prints, per frame or edge, the count of entries that are not bit-equal
in each output, and at the end the first stage with any. ``frames`` cuts
the loop to its first frames (default all 12). ``--chain`` also runs both
packages' own ``run_sequence`` and prints the edges kept and the ATE
before and after the closure. ``--jax-ground`` hands the port's chain
the JAX package's Patchwork ground and non-ground masks in place of its
own (everything after Patchwork stays the port's), which tells whether an
edge the two chains gate apart turns on the ground mask or on a later
stage. ``--jax-normals`` and ``--jax-fpfh`` hand the chain the JAX
package's normals, or its descriptors, each computed by the JAX
package's compiled dense stage on the port's own inputs to that stage
(voxels; voxels and normals). With ``--chain`` every registered edge's
validity, inlier count and overlap are printed, as the edge gate reads
them. Not part of the test suite: all 12 frames take ~4 minutes on the
CPU, ~1 more with ``--chain``; ``2 --chain`` runs edge (0, 1) alone.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RAW = 32768
NUM_POSES = 12
EDGE_KW = dict(min_edge_inliers=2, min_edge_overlap=0.35)


def differ(a, b) -> int:
    """Entries of a and b that are not the same bits (NaN equal to NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    if a.dtype.kind == "f":
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        same &= np.signbit(a) == np.signbit(b)
        return int((~same).sum())
    return int((a != b).sum())


def main(frames: int, chain: bool, jax_ground: bool, jax_normals: bool,
         jax_fpfh: bool) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import quatro_tpu.config as jcfg
    import quatro_tpu.ops.dense_features as jdf
    import quatro_tpu.ops.segment_matmul as jsm
    import quatro_tpu.preprocessing.patchwork as jpw
    from quatro_tpu import sequence as jseq
    from quatro_tpu.odometry import OdometryRunner as JaxRunner
    from quatro_tpu.pipeline import extract_features as j_extract
    from quatro_tpu.ops.dense_features import dense_fpfh as j_fpfh
    from quatro_tpu.ops.matching import match_features as j_match
    from quatro_tpu.ops.voxel import voxel_downsample as j_voxel
    from quatro_tpu.preprocessing.projection import segment_cloud as j_segment
    from quatro_tpu.solver.ground import frame_leveling as j_level
    from quatro_tpu.solver.quatro import register_correspondences as j_solve
    from quatro_tpu.solver.verify import alignment_overlap as j_overlap

    import quatro_tpu_torch as qt
    import quatro_tpu_torch.ops.normals as tnm
    from quatro_tpu_torch import sequence
    from quatro_tpu_torch.ops.czm import plane_covariance
    from quatro_tpu_torch.ops.dense_features import dense_fpfh, dense_normals
    from quatro_tpu_torch.ops.segment import fit_iteration_moments
    from quatro_tpu_torch.ops.matching import match_features
    from quatro_tpu_torch.ops.voxel import voxel_downsample
    from quatro_tpu_torch.preprocessing.patchwork import estimate_ground
    from quatro_tpu_torch.preprocessing.projection import segment_cloud
    from quatro_tpu_torch.solver.ground import frame_leveling
    from quatro_tpu_torch.solver.quatro import register_correspondences
    from quatro_tpu_torch.solver.verify import alignment_overlap

    jc = jcfg.PipelineConfig(lidar=jcfg.LidarConfig.preset("VLP-16"),
                             max_voxels=2048,
                             fpfh=jcfg.FPFHConfig(max_correspondences=512))
    tc = qt.config_from_dict(dataclasses.asdict(jc))
    f = jc.fpfh
    scans, gt = sequence.make_synthetic_sequence(
        num_poses=NUM_POSES, seed=1, radius=6.0, config=tc, raw_capacity=RAW)
    scans = scans[:frames]

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype))

    def n(x):
        return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x)
                          else x)

    # what the JAX package's compiled code hands its plane fits' and
    # normals' eigen solves, and its plane fits' sums with their inputs,
    # recorded from inside it (so these compiles are its own, below)
    seen = {"fit": [], "eig": []}

    def record(key, *arrays):
        jax.debug.callback(lambda *a: seen[key].append(
            [np.asarray(x) for x in a]), *arrays)

    def eig_spy(orig):
        def spy(*cov):
            record("eig", *cov)
            return orig(*cov)
        return spy
    jpw.smallest_eigenpair_sym3 = eig_spy(jpw.smallest_eigenpair_sym3)
    jdf.smallest_eigenpair_sym3 = eig_spy(jdf.smallest_eigenpair_sym3)
    fit_orig = jsm.fit_iteration_moments

    def fit_spy(ids, chan, tab, p_pad, p_cnt, exact=True):
        out = fit_orig(ids, chan, tab, p_pad, p_cnt, exact=exact)
        record("fit", ids, chan, tab, out)
        return out
    jsm.fit_iteration_moments = fit_spy
    port_eig = []
    tnm_eig = tnm.smallest_eigenpair_sym3

    def port_spy(*cov):
        port_eig.append([x.numpy() for x in cov])
        return tnm_eig(*cov)
    tnm.smallest_eigenpair_sym3 = port_spy

    def fresh(fn, *static):
        """A compile of the JAX function of its own, so that the records
        are traced into it."""
        return jax.jit(fn.__wrapped__, static_argnames=static)

    j_ground = fresh(jpw.estimate_ground, "cfg")
    jit_ground = jax.jit(lambda p, m: j_ground(p, m, jc.patchwork))
    jit_segment = jax.jit(lambda p, m: j_segment(
        p, m, jc.lidar, jc.projection, ground_mode="Patchwork",
        max_points=jc.max_nonground_points).valid_segments)
    jit_level = jax.jit(lambda p, m: j_level(p, m, jc.ground_alignment))
    jit_voxel = jax.jit(lambda p, m: j_voxel(
        p, m, jc.voxel_size, jc.max_voxels, active_cap=jc.max_segment_points))
    j_normals = fresh(jdf.dense_normals, "radius", "tile")
    jit_normals = jax.jit(lambda p, m: j_normals(p, m, f.normal_radius))
    jit_extract_normals = jax.jit(
        lambda p, m: j_extract(p, m, jc)[3].normals)
    jit_fpfh = jax.jit(lambda p, nr, nv, m: j_fpfh(p, nr, nv, m,
                                                    f.fpfh_radius))
    match_kw = dict(capacity=f.max_correspondences,
                    use_crosscheck=f.use_crosscheck,
                    crosscheck_min_matches=f.crosscheck_min_matches,
                    use_tuple_test=f.use_tuple_test,
                    tuple_scale=f.tuple_scale,
                    trials_per_corr=f.tuple_trials_per_corr,
                    seed=f.tuple_seed, tuple_min_keep=f.tuple_min_keep)
    jit_match = jax.jit(lambda *a: j_match(*a, **match_kw))
    jit_solve = jax.jit(lambda s, d, m: j_solve(s, d, m, jc.solver))
    radius_ov = 2.0 * jc.voxel_size
    jit_overlap = jax.jit(lambda *a: j_overlap(*a, radius=radius_ov))
    whole = jax.jit(JaxRunner(jc)._extract_impl)

    counts: dict = {}

    def report(stage: str, where: str, **outs) -> None:
        line = ", ".join(f"{k} {v}" for k, v in outs.items())
        print(f"  {stage:<22} {where:<10} {line}", flush=True)
        counts.setdefault(stage, 0)
        counts[stage] += sum(outs.values())

    feats = []
    for k, s in enumerate(scans):
        pts_np, msk_np = n(s.points), n(s.mask)
        jp, jm = jnp.asarray(pts_np), jnp.asarray(msk_np)
        tp, tm = t(pts_np), t(msk_np)
        print(f"frame {k}: {int(msk_np.sum())} points", flush=True)

        seen["fit"].clear()
        seen["eig"].clear()
        jg = jit_ground(jp, jm)
        jax.effects_barrier()
        p_cnt = tc.patchwork.num_patches
        sums = cov = cov_once = 0
        fits = len(seen["fit"])
        for i, ((ids, chan, tab, js), jcov) in enumerate(zip(seen["fit"],
                                                             seen["eig"])):
            ts = fit_iteration_moments(t(ids)[None], t(chan)[None],
                                       t(tab)[None], js.shape[0], p_cnt,
                                       exact=i + 1 == fits)[0]
            sums += differ(js, n(ts))
            _, tcov = plane_covariance(t(js[:p_cnt]).T)
            _, once = tnm.centered_covariance(t(js[:p_cnt]).T)
            cov += sum(differ(a, n(b)) for a, b in zip(jcov, tcov))
            cov_once += sum(differ(a, n(b)) for a, b in zip(jcov, once))
        report("patchwork: sums", f"frame {k}", sums=sums)
        report("patchwork: covariance", f"frame {k}", covariance=cov)
        print(f"  (rounded once, as ops/normals.py::centered_covariance: "
              f"{cov_once} entries differ)", flush=True)
        tg = estimate_ground(tp, tm, tc.patchwork)
        report("patchwork", f"frame {k}",
               ground=differ(jg.ground, n(tg.ground)),
               nonground=differ(jg.nonground, n(tg.nonground)),
               normals=differ(jg.patch_normal, n(tg.patch_normal)))
        nong = np.asarray(jg.nonground)

        jseg = np.asarray(jit_segment(jp, jnp.asarray(nong)))
        tseg = n(segment_cloud(tp, t(nong), tc.lidar, tc.projection,
                               ground_mode="Patchwork",
                               max_points=tc.max_nonground_points)
                 .valid_segments)
        report("range image/segments", f"frame {k}",
               segments=differ(jseg, tseg))

        pts_l = pts_np
        if jc.ground_alignment.enabled:
            gmask = np.asarray(jg.ground) & msk_np
            jl = jit_level(jp, jnp.asarray(gmask))
            tl = frame_leveling(tp, t(gmask), tc.ground_alignment)
            report("leveling", f"frame {k}", level=differ(jl[0], n(tl[0])),
                   height=differ(jl[1], n(tl[1])), ok=differ(jl[2], n(tl[2])))
            lev = np.asarray(jl[0])
            pts_l = np.asarray(jnp.asarray(pts_np) @ jnp.asarray(lev).T)

        jv, jvm = jit_voxel(jnp.asarray(pts_l), jnp.asarray(jseg))
        tv, tvm = voxel_downsample(t(pts_l), t(jseg), tc.voxel_size,
                                   tc.max_voxels,
                                   active_cap=tc.max_segment_points)
        report("voxel grid", f"frame {k}", points=differ(jv, n(tv)),
               mask=differ(jvm, n(tvm)))
        jv_np, jvm_np = np.asarray(jv), np.asarray(jvm)

        seen["eig"].clear()
        port_eig.clear()
        jn = jit_normals(jv, jvm)
        jax.effects_barrier()
        tn = dense_normals(t(jv_np)[None], t(jvm_np)[None], f.normal_radius)
        report("normals: covariance", f"frame {k}", covariance=sum(
            differ(a, b.reshape(a.shape))
            for a, b in zip(seen["eig"][0], port_eig[0])))
        report("normals", f"frame {k}",
               normals=differ(jn.normals, n(tn.normals)[0]),
               valid=differ(jn.valid, n(tn.valid)[0]))
        own = differ(jit_extract_normals(jnp.asarray(pts_l),
                                         jnp.asarray(jseg)), jn.normals)
        print(f"  (the JAX package's normals from its extract_features "
              f"compile: {own} entries differ from its dense_normals "
              "compile)", flush=True)

        jd = jit_fpfh(jv, jn.normals, jn.valid, jvm)
        td = dense_fpfh(t(jv_np)[None], t(np.asarray(jn.normals))[None],
                        t(np.asarray(jn.valid))[None], t(jvm_np)[None],
                        f.fpfh_radius)
        report("SPFH/FPFH", f"frame {k}", descriptors=differ(jd, n(td)[0]))

        wf = whole(jp, jm)
        if differ(wf.voxels, jv) or differ(wf.descriptors, jd):
            print(f"  (the JAX package's whole-frame extraction differs from "
                  f"its chain of stages: voxels {differ(wf.voxels, jv)}, "
                  f"descriptors {differ(wf.descriptors, jd)})", flush=True)
        feats.append((jv_np, jvm_np, np.asarray(jd),
                      jvm_np & np.asarray(jn.valid)))

    plan = [(k, k + 1) for k in range(len(feats) - 1)]
    if len(feats) == NUM_POSES:
        plan.append((0, NUM_POSES - 1))
    for i, j in plan:
        # edge (i, j): src = frame j, tgt = frame i, as run_sequence
        sv, sm, sd, sdm = feats[j]
        gv, gm, gd, gdm = feats[i]
        jcorr = jit_match(*(jnp.asarray(a) for a in (sv, gv, sd, gd, sdm,
                                                      gdm)))
        tcorr = match_features(*(t(a) for a in (sv, gv, sd, gd, sdm, gdm)),
                               device="cpu", **match_kw)
        where = f"edge {i}-{j}"
        report("matches", where, src=differ(jcorr.src_xyz, n(tcorr.src_xyz)),
               tgt=differ(jcorr.tgt_xyz, n(tcorr.tgt_xyz)),
               mask=differ(jcorr.mask, n(tcorr.mask)))

        cs, ct, cm = (np.asarray(a) for a in (jcorr.src_xyz, jcorr.tgt_xyz,
                                              jcorr.mask))
        jsol = jit_solve(jnp.asarray(cs), jnp.asarray(ct), jnp.asarray(cm))
        tsol = register_correspondences(t(cs), t(ct), t(cm), tc.solver,
                                        device="cpu")
        jov = jit_overlap(*(jnp.asarray(a) for a in (sv, sm, gv, gm)),
                          jsol.rotation, jsol.translation)
        tov = alignment_overlap(*(t(a) for a in (sv, sm, gv, gm)),
                                tsol.rotation, tsol.translation,
                                radius=radius_ov)

        def gate(sol, ov):
            cnt = int(np.asarray(n(sol.final_inlier_mask)).sum())
            return (bool(n(sol.valid)) and cnt >= EDGE_KW["min_edge_inliers"]
                    and float(n(ov)) >= EDGE_KW["min_edge_overlap"]), cnt
        jok, jcnt = gate(jsol, jov)
        tok, tcnt = gate(tsol, tov)
        report("edge pose/gate", where,
               rotation=differ(jsol.rotation, n(tsol.rotation)),
               translation=differ(jsol.translation, n(tsol.translation)),
               inliers=differ(jsol.final_inlier_mask,
                              n(tsol.final_inlier_mask)),
               overlap=differ(jov, n(tov)), gate=int(jok != tok))
        print(f"  {'':<22} {'':<10} gate JAX {jok} ({jcnt} inliers, "
              f"overlap {float(jov):.4f}), port {tok} ({tcnt}, "
              f"{float(n(tov)):.4f})", flush=True)

    order = ["patchwork: sums", "patchwork: covariance", "patchwork",
             "range image/segments", "leveling", "voxel grid",
             "normals: covariance", "normals", "SPFH/FPFH", "matches",
             "edge pose/gate"]
    print("\ndiffering entries per stage:", flush=True)
    for st in order:
        if st in counts:
            print(f"  {st:<22} {counts[st]}")
    first = next((st for st in order if counts.get(st)), None)
    print(f"first stage that rounds apart: {first or 'none'}")

    if chain and jax_ground:
        import quatro_tpu_torch.pipeline as tpl
        port_ground = tpl.estimate_ground

        def swapped(points, mask, cfg):
            res = port_ground(points, mask, cfg)
            clouds = zip(points.reshape(-1, *points.shape[-2:]),
                         mask.reshape(-1, mask.shape[-1]))
            jgs = [jit_ground(jnp.asarray(n(p)), jnp.asarray(n(m)))
                   for p, m in clouds]
            return res._replace(
                ground=torch.stack([t(g.ground) for g in jgs]).reshape(
                    mask.shape),
                nonground=torch.stack([t(g.nonground) for g in jgs]).reshape(
                    mask.shape))
        tpl.estimate_ground = swapped
        print("the port's chain runs on the JAX package's ground masks",
              flush=True)
    if chain and (jax_normals or jax_fpfh):
        import quatro_tpu_torch.ops.dense_features as tdf
        from quatro_tpu_torch.ops.normals import Normals

        def clouds(points, mask):
            return zip(points.reshape(-1, *points.shape[-2:]),
                       mask.reshape(-1, mask.shape[-1]))

        def jax_dense_normals(points, mask, radius):
            outs = [jit_normals(jnp.asarray(n(p)), jnp.asarray(n(m)))
                    for p, m in clouds(points, mask)]
            valid = torch.stack([t(o.valid) for o in outs]).reshape(
                mask.shape)
            normals = torch.stack([t(o.normals) for o in outs]).reshape(
                points.shape)
            curv = torch.stack([t(o.curvature) for o in outs]).reshape(
                mask.shape)
            # the JAX package leaves rows of < 3 neighbours NaN, the port 0
            return Normals(torch.where(valid[..., None], normals, 0.0),
                           torch.where(valid, curv, 0.0), valid)

        def jax_dense_fpfh(points, normals, normal_valid, mask, radius):
            outs = [jit_fpfh(*(jnp.asarray(n(a)) for a in args))
                    for args in zip(
                        points.reshape(-1, *points.shape[-2:]),
                        normals.reshape(-1, *normals.shape[-2:]),
                        normal_valid.reshape(-1, mask.shape[-1]),
                        mask.reshape(-1, mask.shape[-1]))]
            return torch.stack([t(o) for o in outs]).reshape(
                *mask.shape, -1)
        if jax_normals:
            tdf.dense_normals = jax_dense_normals
        if jax_fpfh:
            tdf.dense_fpfh = jax_dense_fpfh
        print("the port's chain runs on the JAX package's "
              + " and ".join(w for w, on in (("normals", jax_normals),
                                             ("descriptors", jax_fpfh))
                             if on)
              + " (each computed on the port's own inputs to that stage)",
              flush=True)
    if chain:
        # each edge's inliers and overlap, as the edge gate reads them
        from quatro_tpu_torch.odometry import OdometryRunner
        gate_in = []
        register_pairs = OdometryRunner.register_pairs

        def recording(self, src, tgt):
            sols, overlaps = register_pairs(self, src, tgt)
            gate_in.extend(zip(n(sols.valid).tolist(),
                               n(sols.final_inlier_mask.sum(-1)).tolist(),
                               n(overlaps).tolist()))
            return sols, overlaps
        OdometryRunner.register_pairs = recording
        res = sequence.run_sequence(scans, tc, gt_poses=gt[:frames],
                                    loop_radius=5.0,
                                    batch_size=4, device="cpu")
        OdometryRunner.register_pairs = register_pairs
        for (i, j), (valid, cnt, ov) in zip(
                zip(res.edges_i.tolist(), res.edges_j.tolist()), gate_in):
            print(f"port edge ({i}, {j}): valid {valid}, {cnt} inliers, "
                  f"overlap {ov:.4f}", flush=True)
        jscans, jgt = jseq.make_synthetic_sequence(
            num_poses=NUM_POSES, seed=1, radius=6.0, config=jc,
            raw_capacity=RAW)
        jres = jseq.run_sequence(jscans[:frames], jc, gt_poses=jgt[:frames],
                                 loop_radius=5.0, batch_size=4)
        for name, r in (("JAX package", jres), ("port", res)):
            kept = [(int(i), int(j)) for i, j, ok in
                    zip(r.edges_i, r.edges_j, r.edge_mask) if ok]
            print(f"{name}: {r.edges_valid} of {r.edges_total} edges valid "
                  f"{kept}; ATE {r.ate_before:.6f} m before the closure, "
                  f"{r.ate_after:.6f} m after", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else NUM_POSES, "--chain" in sys.argv,
         "--jax-ground" in sys.argv, "--jax-normals" in sys.argv,
         "--jax-fpfh" in sys.argv)
