"""Device policy of the port's entry points.

Entry points take ``device=None``, which means the card: "cuda". Without a
card that raises; nothing carries on on the CPU unless the caller asks for
it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def to_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor of dtype on device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))      # a copy: inputs may be read-only
    return x.to(device=device, dtype=dtype).contiguous()
