"""The exact clique search of one restricted graph on the host: the
independent oracle for the steps, masks and ``completed`` of
``quatro_tpu_torch.ops.kernels.exact_clique`` (tests/test_torch_exact_so3.py)
and the host route that chip_smoke.py times beside the kernel. It imports
neither JAX nor torch."""

import numpy as np


def host_dfs(sub, vvalid, best0, max_steps):
    """The search on one restriction as a walk over Python-int bitsets
    (bit i is restricted vertex i, the first candidate the lowest set
    bit), with a Python list as the frame stack: (best (cap,) bool,
    completed, steps)."""
    cap = len(vvalid)

    def bits(row):
        return sum(1 << i for i in range(cap) if row[i])

    nbr = [bits(r) for r in sub]
    best = bits(best0)
    best_size = best.bit_count()
    stack = [(bits(vvalid), 0)]                 # (candidates, clique)
    steps = 0
    while stack and steps < max_steps:
        p, c = stack.pop()
        csz, psz = c.bit_count(), p.bit_count()
        if csz > best_size:
            best, best_size = c, csz
        if csz + psz > best_size and psz > 0:
            vm = p & -p                         # the lowest vertex of P
            stack.append((p & ~vm, c))          # exclude it, explored later
            stack.append((p & nbr[vm.bit_length() - 1], c | vm))
        steps += 1
    out = np.array([(best >> i) & 1 for i in range(cap)], bool) & vvalid
    return out, not stack, steps
