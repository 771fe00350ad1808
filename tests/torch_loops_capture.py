"""Which operations of the solver's and the pose graph's loops a CUDA graph
captures on the card.

    python tests/torch_loops_capture.py            # every case, one process each
    python tests/torch_loops_capture.py <case>     # one case

Each case warms its operations up on a side stream, captures them in a
``torch.cuda.CUDAGraph`` (thread-local capture mode, as ``utils/loops.py``
captures), replays the graph and compares its outputs with an uncaptured
run on the same inputs bit for bit. A case that cannot be captured prints
the error; nothing falls back. Cases:

* ``svd``: ``torch.linalg.svd`` and ``det`` on (48, 3, 3), the polish's
  shape (48 rows): the SVD checks its result on the host, which a
  capture refuses (the case exits 0 when it is refused, 1 if captured);
* ``so3``: ``solver/rotation.svd_rot3d`` at the polish's shape (48 rows of
  512 correspondences), which uses neither (one launch of the Kabsch
  kernel, built first): it captures;
* ``yaw``: ``yaw_procrustes`` and the TLS weight update;
* ``clique``: a batched counting matmul, a stable sort, argmax, one_hot,
  scatter and gather at the clique loops' shapes;
* ``segment_sums``: B2 through its ctypes wrapper at the pose graph's
  shape (builds the kernel first);
* ``nccl``: an in-place ``all_reduce`` on a one-rank NCCL group (a file
  store under ``build/``), the pose graph's ``psum_axis``;
* ``profiler``: whether ``torch.profiler`` records the kernels of a graph
  replay;
* ``profiler_after_graphs``: how many of 10 plain launches the profiler
  records before any graph, while the device loops' graphs are kept,
  after a profiled run of replays, and after ``loops.clear_graphs()``;
* ``host_scalar``: a body that builds a device tensor from a Python float
  (``torch.tensor(v, device=...)``, a copy from the host): whether the
  capture refuses it, or captures it and replays the value of the
  capture after the float has changed. Either way a loop body must take
  such a tensor, built once outside the loop, through its ``consts``;
  the case fails only if a replay picked up the new value.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CASES = ("yaw", "clique", "segment_sums", "profiler",
         "profiler_after_graphs", "svd", "so3", "nccl", "host_scalar")


def capture(fn, *args):
    """(graph outputs after one replay, uncaptured outputs) of fn(*args)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(*args)
        finally:
            g.capture_end()
    g.replay()
    torch.cuda.synchronize()
    return g, out, fn(*args)


def report(name, fn, *args):
    try:
        _, got, ref = capture(fn, *args)
    except Exception as e:                       # report, then fail
        print(f"{name}: NOT captured: {type(e).__name__}: {e}"[:400],
              flush=True)
        return 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"{name}: captured, replay equal to the uncaptured run: {same}",
          flush=True)
    return 0 if same else 1


def case(name: str) -> int:
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    if name == "svd":
        h = torch.randn(48, 3, 3, generator=gen).to(dev)

        def body(h):
            u, _, vt = torch.linalg.svd(h)
            return vt.transpose(-1, -2) @ u.transpose(-1, -2), \
                torch.linalg.det(u)
        rc = report("torch.linalg.svd + det (48, 3, 3)", body, h)
        return 0 if rc else 1                    # refusing it is expected
    if name == "so3":
        from quatro_tpu_torch.solver.rotation import svd_rot3d
        src = torch.randn(48, 512, 3, generator=gen).to(dev)
        dst = torch.randn(48, 512, 3, generator=gen).to(dev)
        w = torch.rand(48, 512, generator=gen).to(dev)
        return report("svd_rot3d (48, 512)", svd_rot3d, src, dst, w)
    if name == "yaw":
        from quatro_tpu_torch.solver.rotation import yaw_procrustes
        src = torch.randn(48, 512, 2, generator=gen).to(dev)
        dst = torch.randn(48, 512, 2, generator=gen).to(dev)
        w = torch.rand(48, 512, generator=gen).to(dev)

        def body(s, d, w):
            th = yaw_procrustes(s, d, w)
            return th, torch.where(w > 0.5, th[:, None] * w, 0.0)
        return report("yaw body (48, 512)", body, src, dst, w)
    if name == "clique":
        adj = (torch.rand(1, 1024, 1024, generator=gen) < 0.1).to(dev)
        adj = adj | adj.transpose(-1, -2)
        cand = (torch.rand(1, 128, 1024, generator=gen) < 0.2).float().to(dev)

        def body(adj, cand):
            deg = (cand @ adj.float()) * cand
            pick = torch.argmax(deg, -1)
            oh = torch.nn.functional.one_hot(pick, 1024).float()
            idx = torch.sort(deg, dim=-1, descending=True,
                             stable=True).indices
            rows = adj.gather(-2, idx[:, :8, :1].expand(1, 8, 1024))
            return deg, oh.scatter(-1, pick[..., None], 2.0), rows
        return report("clique ops (1, 128, 1024)", body, adj, cand)
    if name == "segment_sums":
        from quatro_tpu_torch import _build
        from quatro_tpu_torch.ops.launch import LAUNCHES
        from quatro_tpu_torch.ops.segment import segment_sums
        _build.build(["segment_sums"])
        ids = torch.randint(0, 12, (38,), generator=gen,
                            dtype=torch.int32).to(dev)
        vals = torch.randn(4, 38, generator=gen).to(dev)
        before = LAUNCHES["segment_sums"]
        rc = report("segment_sums (38,) -> (12, 4)",
                    lambda i, v: segment_sums(i, v, 12), ids, vals)
        print("segment_sums launches counted:", LAUNCHES["segment_sums"]
              - before, "(2 warm-up + 1 capture + 1 reference)")
        return rc
    if name == "profiler":
        x = torch.randn(4096, device=dev)
        g, _, _ = capture(lambda x: (x * 2 + 1).sin(), x)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                g.replay()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"profiler: {len(kern)} device events over 5 replays of a "
              f"2-kernel graph: {sorted({e.name for e in kern})}"[:400],
              flush=True)
        return 0
    if name == "profiler_after_graphs":
        from quatro_tpu_torch.solver import rotation
        from quatro_tpu_torch.utils import loops
        y = torch.ones(1 << 20, device=dev)

        def seen():
            y.mul_(1.0001)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    y.mul_(1.0001)
                torch.cuda.synchronize()
            return sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "Mul" in e.key)

        from quatro_tpu_torch import _build
        from quatro_tpu_torch.parallel.posegraph import (PoseGraphEdges,
                                                         optimize_pose_graph)
        _build.build(["segment_sums"])
        src = torch.randn(6, 256, 2, generator=gen).to(dev)
        counts = {"no graph yet": [seen() for _ in range(3)]}
        for _ in range(2):                   # capture, then replay
            rotation.gnc_rotation_2d(src, src.flip(-1), src[..., 0] > -9,
                                     0.1)
        counts["a GNC graph kept"] = [seen() for _ in range(3)]
        m = 12
        ei = torch.arange(m, dtype=torch.int32, device=dev)
        edges = PoseGraphEdges(ei, (ei + 1) % m,
                               torch.randn(m, 3, generator=gen).to(dev),
                               torch.randn(m, generator=gen).to(dev),
                               torch.ones(m, device=dev),
                               torch.ones(m, dtype=torch.bool, device=dev))
        p0 = torch.randn(m, 4, generator=gen).to(dev)
        for cg in (40, 41, 42, 43):          # four ~2500-launch graphs
            optimize_pose_graph(p0, edges, m, gn_iters=10, cg_iters=cg)
        counts["five graphs kept"] = [seen() for _ in range(3)]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            optimize_pose_graph(p0, edges, m, gn_iters=10, cg_iters=40)
            torch.cuda.synchronize()
        counts["after profiling replays"] = [seen() for _ in range(3)]
        loops.clear_graphs()
        torch.cuda.synchronize()
        counts["graphs cleared"] = [seen() for _ in range(3)]
        print(f"profiler_after_graphs: elementwise events seen of 10 "
              f"calls: {counts}; loops {dict(loops.LOOPS)}", flush=True)
        return 0
    if name == "host_scalar":
        x = torch.randn(4096, generator=gen).to(dev)
        scale = [2.0]

        def body(x):
            return x * torch.tensor(scale[0], device=dev)
        try:
            g, out, _ = capture(body, x)
        except Exception as e:                   # the capture refused it
            print(f"host_scalar: NOT captured: {type(e).__name__}: {e}"[:400],
                  flush=True)
            return 0
        scale[0] = 3.0
        g.replay()
        torch.cuda.synchronize()
        stale = torch.equal(out, x * 2.0)
        fresh = torch.equal(out, x * 3.0)
        print("host_scalar: captured; with the float changed from 2.0 to "
              "3.0 a replay gives "
              + ("the value of the capture, 2.0 (stale)" if stale else
                 "the new value, 3.0" if fresh else "neither value"),
              flush=True)
        return 1 if fresh else 0
    if name == "nccl":
        import torch.distributed as dist
        os.makedirs(ROOT / "build", exist_ok=True)
        store = tempfile.mktemp(prefix="nccl_store_", dir=ROOT / "build")
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            x = torch.randn(12, 4, generator=gen).to(dev)

            def body(x):
                y = x * 2.0
                dist.all_reduce(y, op=dist.ReduceOp.SUM)
                return y + 1.0
            return report("nccl all_reduce (12, 4), one rank", body, x)
        finally:
            dist.destroy_process_group()
    raise SystemExit(f"unknown case {name!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loops_capture: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return case(sys.argv[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    rc = 0
    for name in CASES:
        p = subprocess.run([sys.executable, __file__, name], timeout=300)
        print(f"[{name}: exit {p.returncode}]", flush=True)
        rc |= p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
