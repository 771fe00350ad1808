"""Stage timing and traces.

PyTorch counterpart of ``quatro_tpu/utils/profiling.py``. The reference
times stages with std::chrono spans printed to stdout
(examples/run_global_registration.cpp:127,242,248-251). On the card a span
means something only if it waits for the device, so ``StageTimer.stage``
ends with ``torch.cuda.synchronize`` when given a CUDA device or tensor;
``trace`` records a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any, List, Tuple

import torch

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


def _sync(sync: Any) -> None:
    """Wait for the device of ``sync`` (a device, a device string or a
    tensor) when it is a CUDA device."""
    dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates (stage, seconds) spans, synchronised with the card."""

    def __init__(self):
        self.spans: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        """Time the block; with ``sync`` (a device or a tensor) the span
        ends once that device has finished its work."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.spans.append((name, time.perf_counter() - t0))

    def record(self, name: str, seconds: float):
        self.spans.append((name, seconds))

    def total(self) -> float:
        return sum(s for _, s in self.spans)

    def table(self) -> str:
        """Formatted like the reference's stage tables
        (run_global_registration.cpp:168-192)."""
        width = max([len(n) for n, _ in self.spans] + [10])
        lines = ["-" * (width + 16)]
        for name, sec in self.spans:
            lines.append(f"{name:<{width}} | {sec * 1e3:>9.2f} ms")
        lines.append("-" * (width + 16))
        lines.append(f"{'total':<{width}} | {self.total() * 1e3:>9.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = str(TRACE_DIR)):
    """Profile the block with torch.profiler (the CPU, and the card when
    there is one) and write a Chrome trace, ``trace.json`` in ``log_dir``
    (view it in chrome://tracing or Perfetto). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
