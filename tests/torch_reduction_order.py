"""The order in which torch adds three f32 values in its reductions, on the
card and on the CPU: ``torch.linalg.vector_norm`` and ``.sum(-1)`` over a
last axis of 3 (the ground leveling's |n| and height before the leveling
was a kernel), against the orders written out.

    python tests/torch_reduction_order.py [cuda|cpu]

Prints, for (K, 3) inputs at several K and for (2, K, 3), how many of the
K results differ from each written order (0: that order). The leveling
(ops/ground.py, csrc/ground.cu) writes |n| as sqrt(fma(n_z, n_z, fma(n_y,
n_y, n_x n_x))) and the height as (a + b) + c, the CPU's orders; torch on
the card takes (a a + c c) + b b and (a + c) + b for K >= 2.
"""

import sys

import torch

from quatro_tpu_torch.utils import fused


def main(dev: str) -> int:
    if dev == "cuda" and not torch.cuda.is_available():
        print("torch_reduction_order: no CUDA device", file=sys.stderr)
        return 2
    if dev == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    torch.manual_seed(0)
    for k in (1, 2, 8, 128, 100000):
        x = torch.randn(k, 3, device=dev)
        x = x / x.norm(dim=-1, keepdim=True) * (
            1 + 1e-6 * torch.randn(k, 1, device=dev))
        vn = torch.linalg.vector_norm(x, dim=-1)
        a, b, c = x.unbind(-1)
        norms = {"fma(c,c,fma(b,b,a a))": fused.sqrt(
                     fused.fma(c, c, fused.fma(b, b, a * a))),
                 "(a a + b b) + c c": fused.sqrt((a * a + b * b) + c * c),
                 "a a + (b b + c c)": fused.sqrt(a * a + (b * b + c * c)),
                 "(a a + c c) + b b": fused.sqrt((a * a + c * c) + b * b)}
        print("vector_norm", k, {n: int((v != vn).sum())
                                 for n, v in norms.items()})
        y = torch.randn(k, 3, device=dev) * 10
        s = y.sum(-1)
        p, q, r = y.unbind(-1)
        sums = {"(a+b)+c": (p + q) + r, "a+(b+c)": p + (q + r),
                "(a+c)+b": (p + r) + q}
        print("sum", k, {n: int((v != s).sum()) for n, v in sums.items()})
        y3 = torch.randn(2, k, 3, device=dev)
        p, q, r = y3.unbind(-1)
        print("(2, K, 3)", k, {"sum (a+c)+b": int(
            (y3.sum(-1) != (p + r) + q).sum()),
            "sum (a+b)+c": int((y3.sum(-1) != (p + q) + r).sum())})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "cuda"))
