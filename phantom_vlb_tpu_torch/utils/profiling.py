"""Tracing hooks on torch.

Counterpart of ``phantom_vlb_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` (CPU, and CUDA
  where a card is) that writes a Chrome trace file into a directory (the
  JAX package writes an xplane trace with ``jax.profiler``);
- :func:`span`: a named range of the program's host work, recorded into
  :data:`SPANS` while a ``torch.profiler`` session is active and shown in
  its trace as a ``record_function`` range of the same name;
- :func:`count`: a named counter of the program's events, summed into
  :data:`COUNTS` while a ``torch.profiler`` session is active (the test
  :func:`span` makes);
- :func:`device_memory_stats`: the caching allocator's bytes in use and
  their peak, and the card's memory, per CUDA device.

The JAX package's ``StepTimer`` has no counterpart: a span's record gives a
stage's time, and the device's records beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from pathlib import Path

import torch

__all__ = ["trace", "span", "SpanRecord", "SpanRecorder", "SPANS", "count", "COUNTS", "device_memory_stats"]


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


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span. ``start_ns`` and ``end_ns`` are Unix-epoch ns, the
    clock of the profiler's events (host and device); ``parent`` is the
    ``index`` of the innermost span open on the same thread when this one
    opened (-1: a root), ``step`` the ``index`` of its root."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class _OpenSpans(threading.local):
    """The spans open on the calling thread, innermost last."""

    def __init__(self):
        self.stack: list[_Span] = []


class SpanRecorder:
    """The last 65536 closed spans, in the order they closed (a child
    before its parent); each thread nests its own spans."""

    def __init__(self):
        self.records: collections.deque[SpanRecord] = collections.deque(maxlen=1 << 16)
        self._index = itertools.count()
        self._open = _OpenSpans()


class _Span:
    __slots__ = ("recorder", "name", "range", "index", "start_ns", "parent", "step")

    def __init__(self, recorder: SpanRecorder, name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = self.recorder._open.stack
        self.index = next(self.recorder._index)
        self.parent, self.step = (stack[-1].index, stack[-1].step) if stack else (-1, self.index)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.recorder._open.stack.pop()
        self.recorder.records.append(
            SpanRecord(self.index, self.name, self.start_ns, end_ns, self.parent, self.step))
        self.range.__exit__(*exc)
        return False


SPANS = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over the program's work named ``name``: while a
    ``torch.profiler`` session is active (any activities, the device's
    alone too), a ``record_function`` range of that name and a
    :class:`SpanRecord` in :data:`SPANS`; otherwise nothing, at the cost of
    one test of the profiler's state."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(SPANS, name)


COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]`` while a ``torch.profiler`` session is
    active (as :func:`span` records); otherwise nothing, at the cost of one
    test of the profiler's state."""
    if torch.autograd._profiler_enabled():
        COUNTS[name] += n


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
