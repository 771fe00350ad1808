"""The 8-frame seed-5 loop of tests/test_torch_sequence.py on the CPU at
several torch thread counts: which edges the port keeps, and the ATE.

    PYTHONPATH=. python tests/torch_threads_loop.py 1 2 6

Each thread count runs in a process of its own (torch's thread pool is set
before any work). The loop is ``make_synthetic_sequence(num_poses=8,
seed=5, radius=6.0)`` at VLP-16 scale (32768 raw points) under the
sequence tests' configuration, through ``run_sequence`` with the arguments
of ``test_run_sequence_checkpoint_resume`` (loop radius 5 m, batches of 2
edges). Not part of the test suite: one run takes ~15-25 s per thread
count.
"""

import subprocess
import sys


def run(threads: int) -> None:
    import torch
    torch.set_num_threads(threads)
    from quatro_tpu_torch import sequence
    from quatro_tpu_torch.config import FPFHConfig, LidarConfig, PipelineConfig

    cfg = PipelineConfig(lidar=LidarConfig.preset("VLP-16"), max_voxels=2048,
                         fpfh=FPFHConfig(max_correspondences=512))
    scans, gt = sequence.make_synthetic_sequence(
        num_poses=8, seed=5, radius=6.0, config=cfg, raw_capacity=32768)
    res = sequence.run_sequence(scans, cfg, gt_poses=gt, loop_radius=5.0,
                                checkpoint_every=2, batch_size=2,
                                device="cpu")
    kept = [(int(i), int(j)) for i, j, ok in zip(res.edges_i, res.edges_j,
                                                  res.edge_mask) if ok]
    print(f"threads {threads}: {res.edges_valid} of {res.edges_total} edges "
          f"kept {kept}; ATE {res.ate_before:.6f} m before the closure, "
          f"{res.ate_after:.6f} m after", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run(int(sys.argv[2]))
    else:
        for t in sys.argv[1:] or ["1", "6"]:
            subprocess.run([sys.executable, __file__, "--one", t], check=True)
