"""Multi-process initialisation and the global mesh.

PyTorch counterpart of ``quatro_tpu/parallel/distributed.py``. Every
process runs the same program on one card; ``torch.distributed`` wires the
processes into one group, and the global ('pairs',) mesh spans its ranks.
The per-pair pipeline needs no communication, so the only traffic is the
pose graph's all-reduce of pose-vector-sized sums: NCCL between cards,
gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from quatro_tpu_torch.parallel.mesh import PairsMesh, RowBlock, make_pairs_mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join this process to the job's process group.

    With no arguments, torch's environment variables say where and who
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them); arguments override for manual launches, e.g.

        initialize_multihost("10.0.0.1:8476", num_processes=2,
                             process_id=int(os.environ["HOST_ID"]))

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prepended) or
    a torch init method URL as it is (``file:///path/store``).

    ``backend`` is the one addition to the JAX signature: None means the
    device's backend, NCCL when there is a card (each rank then takes card
    ``LOCAL_RANK``, or its rank modulo the cards of the host) and gloo on
    the CPU. Asking for gloo lets several ranks share one card, which NCCL
    refuses. A group that fails to form raises; nothing falls back to
    another backend.
    """
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    init_method = None
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())


def global_pairs_mesh(devices=None) -> PairsMesh:
    """1-D ('pairs',) mesh over every rank of the job (``devices`` as in
    ``make_pairs_mesh``: this rank's device)."""
    return make_pairs_mesh(devices=devices)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global pair batch this process feeds to the sharded
    functions: block ``get_rank()`` of ``get_world_size()`` (block 0 of 1
    without a process group).

    global_batch must divide evenly across the processes: a silent
    remainder would drop pairs from the job (pad the batch and mask the
    padding instead)."""
    if dist.is_initialized():
        return RowBlock(dist.get_rank(), dist.get_world_size()).rows(
            global_batch)
    return RowBlock(0, 1).rows(global_batch)
