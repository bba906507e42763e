"""Tracing and timing hooks on torch.

Counterpart of ``phantom_vlb_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` (CPU, and CUDA
  where a card is) that writes a Chrome trace file into a directory (the
  JAX package writes an xplane trace with ``jax.profiler``);
- :class:`StepTimer`: per-stage wall-clock times with an exponential moving
  average, the same arithmetic; ``summary()`` in ms;
- :func:`device_memory_stats`: the caching allocator's bytes in use and
  their peak, and the card's memory, per CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

__all__ = ["trace", "StepTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the profiler (its ``key_averages()`` and
    events), then writes ``trace.<pid>.<ns>.json`` into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / f"trace.{os.getpid()}.{time.time_ns()}.json"))


class StepTimer:
    """Named-stage wall timer with exponential moving averages."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            n = self.count[name]
            self.avg[name] = dt if n == 0 else self.ema * self.avg[name] + (1 - self.ema) * dt
            self.count[name] = n + 1

    def summary(self) -> dict[str, float]:
        return {k: round(v * 1e3, 3) for k, v in self.avg.items()}  # ms


def device_memory_stats() -> list[dict]:
    """One record per CUDA device (none without a card): ``bytes_in_use``
    and ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) of the caching allocator, and
    ``bytes_limit``, the card's memory."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
