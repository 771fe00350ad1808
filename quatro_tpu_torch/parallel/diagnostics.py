"""Communication profile of the sharded functions.

PyTorch counterpart of ``quatro_tpu/parallel/diagnostics.py``, which
compiles a sharded program and counts the collectives XLA put in it. The
contract it pins holds here too:

- ``sharded_register_batch``: no collective. Registration is
  embarrassingly parallel over the ('pairs',) axis.
- ``make_loop_closing_step`` and ``make_full_pipeline_step``: all-reduces
  only, of pose-vector size (the pose graph's J^T sums), never a gather of
  cloud-sized tensors.

PyTorch runs eagerly, so there is no compiled module to read: the profile
counts the collectives a call *issues*, by wrapping torch.distributed's
collective functions for the duration of the call. That is a count of
calls at run time, not of sites: the loop-closing step counts
gn_iters x (cg_iters + 1) all-reduces where XLA counts one in its loop
body. Without a process group nothing is issued (the all-reduce helper
does nothing), so the profile of either step is empty there: hold the
contract on a group of one rank or more. A device loop replayed as a CUDA
graph (utils/loops.py) issues its collectives without calling these
functions; it adds the ones its capture issued to every active profile at
each replay, and takes its capture's calls back out, so a call counts the
same collectives on either route.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch.distributed as dist
from torch.distributed import distributed_c10d

# torch.distributed function -> the JAX package's (HLO) collective name
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "broadcast": "collective-broadcast",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
}

ACTIVE: list = []       # the counters of the profiles running now


def collective_profile(fn, *args) -> Counter:
    """Run ``fn(*args)`` and count the collectives it issues, keyed by the
    JAX package's names ('all-reduce', ...). The counting wrappers replace
    the functions in ``torch.distributed`` (and ``distributed_c10d``, where
    they are defined) while the call runs, for every thread of the
    process, and the originals are put back after it, also when it raises.
    The JAX form's ``static_argnums`` has no counterpart: nothing is
    compiled, so no argument needs to be static."""
    counts: Counter = Counter()
    saved = []

    def counting(original, kind):
        @functools.wraps(original)
        def wrapper(*a, **kw):
            counts[kind] += 1
            return original(*a, **kw)
        return wrapper

    for name, kind in COLLECTIVES.items():
        original = getattr(distributed_c10d, name, None)
        if original is None:
            continue
        wrapper = counting(original, kind)
        for module in (dist, distributed_c10d):
            if getattr(module, name, None) is original:
                saved.append((module, name, original))
                setattr(module, name, wrapper)
    ACTIVE.append(counts)
    try:
        fn(*args)
    finally:
        # by identity: two profiles' counters may compare equal
        del ACTIVE[next(i for i, c in enumerate(ACTIVE) if c is counts)]
        for module, name, original in saved:
            setattr(module, name, original)
    return counts
