"""The ('pairs',) mesh: scan-pair data parallelism over torch.distributed.

PyTorch counterpart of ``quatro_tpu/parallel/mesh.py``. Every stage of the
pipeline is per pair, so whole registrations shard across the ranks of a
process group with no communication; only the pose graph's J^T sums are
all-reduced (parallel/posegraph.py). The JAX mesh over devices becomes
torch.distributed's idiom: one process per card, and a process group whose
ranks are the axis. A mesh here is what one rank knows of it: the group,
its size, this rank and this rank's device.

Without a process group the mesh is one rank on one device. The port does
not drive several cards from one process: the pipeline is host-bound, so
one Python thread would serialise them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from quatro_tpu_torch.device import resolve_device

PAIRS_AXIS = "pairs"


@dataclass(frozen=True)
class PairsMesh:
    """One rank's view of the 1-D ('pairs',) mesh. ``group`` is None in a
    single process (no collective is issued); ``rank`` is -1 on a rank of
    the world that lies outside a smaller mesh's group."""

    group: Optional[object]    # torch.distributed.ProcessGroup or None
    size: int
    rank: int
    device: torch.device


@dataclass(frozen=True)
class RowBlock:
    """Block ``index`` of ``count`` equal contiguous blocks of a pair
    batch's rows: the rows one rank holds (count 1: every row)."""

    index: int
    count: int

    def rows(self, global_batch: int) -> slice:
        """The rows of a batch of ``global_batch`` pairs in this block.
        The batch must divide evenly: a silent remainder would assign
        pairs to no rank."""
        if global_batch % self.count != 0:
            raise ValueError(
                f"global_batch={global_batch} is not divisible by the "
                f"world size {self.count}; the remainder pairs would "
                "silently be assigned to no rank. Pad the batch "
                "(mask=False rows).")
        per = global_batch // self.count
        return slice(self.index * per, (self.index + 1) * per)


def _rank_device(devices) -> torch.device:
    """This rank's device: ``devices`` as given, else the card that
    ``initialize_multihost`` made current (resolve_device's policy)."""
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_pairs_mesh(n_devices: Optional[int] = None,
                    devices=None) -> PairsMesh:
    """1-D mesh over the 'pairs' axis: the ranks of the process group
    (``initialize_multihost``), or the first ``n_devices`` of them.

    ``devices`` is this rank's device (the JAX form takes the mesh's
    device list; here each process holds one): None means the card made
    current by ``initialize_multihost`` (RuntimeError without one), "cpu"
    for the CPU. Without a process group the mesh is one rank, and asking
    for more raises ValueError. Under a group of W ranks, n_devices < W
    makes a group of ranks 0..n_devices-1 (``torch.distributed.new_group``:
    every rank of the world must make the same call), and the others get
    a mesh with rank -1.
    """
    dev = _rank_device(devices)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group: call "
                "quatro_tpu_torch.parallel.distributed.initialize_multihost "
                "in each of the processes first (one per card); without "
                "it the mesh is one rank on one device")
        return PairsMesh(None, 1, 0, dev)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: "
                         "start more processes through initialize_multihost")
    rank = dist.get_rank()
    if n == world:
        return PairsMesh(dist.group.WORLD, n, rank, dev)
    group = dist.new_group(list(range(n)))
    return PairsMesh(group, n, rank if rank < n else -1, dev)


def pairs_sharding(mesh: PairsMesh) -> RowBlock:
    """Leading-axis batch sharding: the row block this rank holds."""
    if mesh.rank < 0:
        raise ValueError("this rank lies outside the mesh's group")
    return RowBlock(mesh.rank, mesh.size)


def replicated(mesh: PairsMesh) -> RowBlock:
    """Every row, on every rank."""
    return RowBlock(0, 1)


def axis_group(axis):
    """The process group behind a psum axis: a mesh's group, a process
    group as given, None for None (one process: nothing to reduce)."""
    return axis.group if isinstance(axis, PairsMesh) else axis


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """x summed over the ranks of ``axis`` (a PairsMesh or a process
    group), in place; x itself when there is no group. Every rank of the
    group must make the call, in the same order: a rank that skipped one
    would hang the others."""
    group = axis_group(axis)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
