"""One rank of the port's two-process gloo test (tests/test_torch_parallel.py).

Usage: python tests/torch_mp_worker.py <rank> <world_size> <store_path>

The ranks form one gloo group through a file store (no TCP port, so test
workers never race for one). Every rank builds the same 8 correspondence
pairs of tests/test_parallel.py's 8-pose ring and feeds its
``local_batch_slice`` rows to ``make_loop_closing_step``. Each rank checks,
against the single-process call on all 8 pairs that it also runs:
- its rows: masks, ``valid`` and counts exactly, poses within 1e-5 rad /
  1e-4 m (the pair axis's row band);
- the all-reduced poses within POSE_TOL of the one-rank solve (the J^T sums
  add the ranks' partial sums in another order), and the same bits on a
  second run;
- the collective profile: registration none, loop closing exactly
  gn_iters x (cg_iters + 1) all-reduces;
- a rank with no local edges (and one holding only masked edges) takes part
  in every all-reduce: the solve ends, on both ranks, with the one-rank
  solve's poses (the other rank adds zeros);
- ``local_batch_slice``'s ValueError on a batch that does not divide;
- ``eval.evaluate_scaling`` at counts 1 and 2: the count of 1 on a group
  of rank 0 alone (rank 1 skips it), every rank returning rank 0's dict.
Prints "rank <r>: OK <json of the measured gaps and the scaling dict>"
and exits 0.
"""

import json
import os
import sys

GN, CG = 6, 24
POSE_TOL = 1e-4       # m and rad: two ranks' all-reduced solve against one


def ring():
    """tests/test_parallel.py:101-138's 8-pose ring: correspondences whose
    registration is edge k -> (k+1) % 8, and poses0 = ground truth + N(0,
    0.1) with pose 0 exact."""
    import numpy as np
    from quatro_tpu_torch.io.synthetic import make_correspondences

    m = 8
    rng = np.random.default_rng(7)
    gt = np.zeros((m, 4), np.float32)
    for k in range(1, m):
        gt[k, 3] = gt[k - 1, 3] + np.deg2rad(20.0)
        gt[k, :2] = gt[k - 1, :2] + [1.5, 0.5]
    src, tgt, ei, ej = [], [], [], []
    for k in range(m):
        j = (k + 1) % m
        c, s = np.cos(gt[k, 3]), np.sin(gt[k, 3])
        dt = gt[j, :3] - gt[k, :3]
        local_t = np.array([c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
                            dt[2]])
        s_pts, t_pts, _, _ = make_correspondences(
            seed=100 + k, n_inliers=50, n_outliers=100,
            yaw_deg=np.rad2deg(gt[j, 3] - gt[k, 3]),
            translation=tuple(local_t))
        src.append(s_pts)
        tgt.append(t_pts)
        ei.append(k)
        ej.append(j)
    init = gt + rng.normal(0, 0.1, gt.shape).astype(np.float32)
    init[0] = gt[0]
    return (np.stack(src).astype(np.float32), np.stack(tgt).astype(np.float32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32), init, gt)


def main() -> int:
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import numpy as np
    import torch
    import torch.distributed as dist

    from quatro_tpu_torch.eval import evaluate_scaling
    from quatro_tpu_torch.parallel import (make_loop_closing_step,
                                           optimize_pose_graph,
                                           sharded_register_batch)
    from quatro_tpu_torch.parallel.diagnostics import collective_profile
    from quatro_tpu_torch.parallel.distributed import (global_pairs_mesh,
                                                       initialize_multihost,
                                                       local_batch_slice)
    from quatro_tpu_torch.parallel.mesh import PairsMesh
    from quatro_tpu_torch.parallel.posegraph import PoseGraphEdges

    torch.set_num_threads(1)
    initialize_multihost(f"file://{store}", num_processes=world,
                         process_id=rank, backend="gloo")
    try:
        mesh = global_pairs_mesh(devices="cpu")
        assert (mesh.size, mesh.rank) == (world, rank), mesh
        src, tgt, ei, ej, init, gt = ring()
        b = src.shape[0]
        sl = local_batch_slice(b)
        assert sl == slice(rank * b // world, (rank + 1) * b // world), sl
        try:
            local_batch_slice(b + 1)
        except ValueError:
            pass
        else:
            raise AssertionError("local_batch_slice took a remainder")
        mask = np.ones(src.shape[:2], bool)
        rows = [torch.from_numpy(a) for a in (src, tgt, mask, ei, ej)]
        local = [a[sl] for a in rows]
        poses0 = torch.from_numpy(init)

        # the single-process call on every pair
        one = PairsMesh(None, 1, 0, torch.device("cpu"))
        ref_poses, ref_sols = make_loop_closing_step(
            one, b, gn_iters=GN, cg_iters=CG)(*rows, poses0)

        step = make_loop_closing_step(mesh, b, gn_iters=GN, cg_iters=CG)
        out = []
        prof = collective_profile(lambda: out.append(step(*local, poses0)))
        poses, sols = out[0]
        assert dict(prof) == {"all-reduce": GN * (CG + 1)}, prof
        reg = collective_profile(sharded_register_batch(mesh), *local[:3])
        assert not reg, reg
        again, _ = step(*local, poses0)
        assert torch.equal(again, poses), "two runs differ"

        for name in ("valid", "max_clique_mask", "final_inlier_mask",
                     "num_rotation_inliers", "gnc_iterations"):
            assert torch.equal(getattr(sols, name),
                               getattr(ref_sols, name)[sl]), name
        rot = float((sols.rotation - ref_sols.rotation[sl]).abs().max())
        trans = float((sols.translation
                       - ref_sols.translation[sl]).abs().max())
        assert rot <= 1e-5 and trans <= 1e-4, (rot, trans)
        pose_gap = float((poses - ref_poses).abs().max())
        assert pose_gap <= POSE_TOL, pose_gap
        err = np.linalg.norm(poses[:, :3].numpy() - gt[:, :3], axis=1)
        assert err.max() < 0.25, err

        # rank 0 holds every edge; rank 1 none, then all of them masked
        t_meas = ref_sols.translation
        yaw = torch.atan2(ref_sols.rotation[:, 1, 0],
                          ref_sols.rotation[:, 0, 0])
        weight = torch.clamp_min(
            ref_sols.final_inlier_mask.sum(-1).to(torch.float32), 1.0)
        edges = PoseGraphEdges(rows[3], rows[4], t_meas, yaw, weight,
                               ref_sols.valid)
        lone = optimize_pose_graph(poses0, edges, b, GN, CG)
        assert torch.equal(lone, ref_poses), "tail differs from the step"
        for empty in ("none", "masked"):
            mine = edges
            if rank != 0:
                mine = (PoseGraphEdges(*(x[:0] for x in edges))
                        if empty == "none" else
                        edges._replace(mask=torch.zeros_like(edges.mask)))
            got = optimize_pose_graph(poses0, mine, b, GN, CG,
                                      psum_axis=mesh)
            assert torch.equal(got, ref_poses), empty
        scaling = evaluate_scaling(batch_per_device=1, device_counts=[1, 2],
                                   n_corr=64, iters=1, device="cpu")
        assert set(scaling) == {1, 2}, scaling
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: OK " + json.dumps({
        "rows": [sl.start, sl.stop], "pose_gap": pose_gap,
        "row_rotation_gap": rot, "row_translation_gap": trans,
        "scaling": scaling}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
