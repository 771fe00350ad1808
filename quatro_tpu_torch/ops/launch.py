"""What every kernel wrapper shares: input checks, the launch through
``_build``, and one dict of launch counts for all the port's kernels.

A wrapper adds one to its kernel's count in ``LAUNCHES`` where it launches
the kernel (CUDA tensors only), and nowhere else, so a run can show that
the main path went through the kernels; ``reset_launches`` sets every
count to 0.
"""

from __future__ import annotations

import torch

LAUNCHES = {"moment_sums": 0, "spfh": 0, "fpfh": 0, "nearest_neighbors": 0,
            "nearest_neighbors2": 0,
            "consistency_graph": 0, "segment_sums": 0, "cross_histogram": 0,
            "fit_iteration_moments": 0, "classify_points": 0,
            "image_lookup": 0, "table_lookup": 0, "exact_clique": 0,
            "kabsch": 0, "label_sweep": 0, "overlap_hits": 0,
            "range_image": 0, "edge_masks": 0, "component_stats": 0,
            "czm_points": 0, "seed_heights": 0, "plane_fit": 0,
            "kcore_search": 0, "grow_cliques": 0, "swap_cliques": 0,
            "distinct_cliques": 0, "radius_knn": 0, "neighbor_normals": 0,
            "icp_correspond": 0, "icp_update": 0, "match_candidates": 0,
            "tuple_compact": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def same_device(*ts):
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def launch(name: str, *args, stream: int | None = None) -> None:
    """Launch kernel ``name`` on ``stream`` (default: the current stream);
    tensors are passed as their device pointers."""
    from quatro_tpu_torch import _build
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    fn = _build.load(name)
    # ctypes passes arguments past its signature on unchecked
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{name}: {len(args)} arguments and the stream for "
                        f"a launcher of {len(fn.argtypes)} parameters")
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# Scratch of the kernels whose last block merges the others' partials (B2,
# B6), per (device, stream): int32 tickets that are 0 and that every kernel
# leaves at 0, and f32 words for the partials, grown when a call needs
# more and kept for the process (B2 at the vote's B = 64: 64 tickets and
# 12.6 MB, its pairs merged apart; B6 at path B: 2.1 MB). Kernels on one
# stream run one after the other, so they can share it; two on different
# streams could run at once and would corrupt each other's tickets and
# partials, so each stream has its own.
_SCRATCH: dict = {}


def stream_scratch(dev: torch.device, stream: int, tickets: int,
                   words: int):
    """[tickets (int32, zeros), partials (f32)] of at least the sizes asked
    for, on ``dev`` for ``stream``."""
    buf = _SCRATCH.get((dev.index, stream))
    if buf is None:
        buf = _SCRATCH[(dev.index, stream)] = [
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.float32, device=dev)]
    if buf[0].numel() < tickets:
        buf[0] = torch.zeros(tickets, dtype=torch.int32, device=dev)
    if buf[1].numel() < words:
        buf[1] = torch.empty(words, dtype=torch.float32, device=dev)
    return buf


def active_limit(mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32: one past the last True entry of each row of ``mask``
    (0 where there is none), as a reduction on the mask's device with
    nothing read back. The active limits of B3, B7 and B9
    (pallas_frontend.py::_active_limits, segment_matmul.py::_tile_limit,
    at point granularity); B3's and B9's kernels compute theirs in a
    pre-pass."""
    iota = torch.arange(1, mask.shape[1] + 1, dtype=torch.int32,
                        device=mask.device)
    return torch.where(mask, iota, 0).amax(1)
