"""A ``torch.profiler`` trace reduced to what the per-layer metrics read.

:func:`reduce` takes the profiler's raw events (kernels, copies and sets on
the device; ops, ``record_function`` ranges and runtime calls on the host)
into a :class:`Trace`: each device operation with its group and when the
host op that launched it started, the traced window, the device's busy time (the union of
its operations' intervals) and its idle gaps, each named by the harness
span the host was in and the host op it was running when the device went
idle. Kernel groups follow the port's kernel names (``csrc/*.cu``): the
port's own kernels by name, library GEMMs (cuBLAS, CUTLASS, cuDNN's
implicit GEMMs), library attention, copies and sets, and the rest (eager
elementwise, norm, RoPE, dropout, reduction and optimizer kernels).
"""

from __future__ import annotations

import dataclasses
import re

__all__ = ["DeviceOp", "Trace", "kernel_group", "reduce", "WINDOW_SPAN", "STEP_SPAN", "BATCH_SPAN"]

WINDOW_SPAN = "cardbench.window"
STEP_SPAN = "cardbench.step"
BATCH_SPAN = "cardbench.batch"
HARNESS_PREFIX = "cardbench."

# The port's kernels (phantom_vlb_tpu_torch/csrc), by the group they report under.
PORT_KERNELS = {
    "flash_fwd_kernel": "flash_fwd", "flash_bwd_prep_kernel": "flash_bwd", "flash_bwd_kernel": "flash_bwd",
    "flash_bwd_post_kernel": "flash_bwd", "ring_fwd_kernel": "ring_fwd", "lora_fwd_kernel": "lora",
    "lora_dx_kernel": "lora", "lora_da_kernel": "lora", "epi_fwd_kernel": "epilogue",
    "epi_dzdb_kernel": "epilogue", "row_quant_kernel": "row_quant", "row_absmax_kernel": "row_quant",
    "row_quant_given_kernel": "row_quant",
}
GEMM_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
ATTENTION_MARKERS = ("pytorch_flash", "fmha", "flash_fwd", "flash_bwd", "sdpa", "attention")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
QUEUE_FULL = "Command Buffer Full"
_SYMBOL = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?([A-Za-z_][A-Za-z0-9_]*)\s*[<(]")


def port_kernel(name: str) -> str | None:
    """The port kernel's symbol, or None: a name at global scope or in an
    anonymous namespace, not a library's (``pytorch_flash::flash_fwd_kernel``
    is PyTorch's)."""
    m = _SYMBOL.match(name)
    return m.group(1) if m and m.group(1) in PORT_KERNELS else None


def kernel_group(name: str, is_kernel: bool = True) -> str:
    if not is_kernel:
        return "memory"
    symbol = port_kernel(name)
    if symbol is not None:
        return PORT_KERNELS[symbol]
    low = name.lower()
    if any(m in low for m in ATTENTION_MARKERS):
        return "attention_lib"
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    return "eager"


@dataclasses.dataclass
class DeviceOp:
    name: str
    group: str
    start_ns: int
    dur_ns: int
    launched_at_ns: int     # the start of the host op that launched it (-1: none traced)


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]
    window_ns: tuple[int, int]
    window_s: float                                  # the host clock's, where it was read
    busy_ns: int
    steps: int
    gaps: list[tuple[str, int]]                      # (what the host was doing, idle ns)
    host_ranges: dict[str, list[tuple[int, int]]]    # record_function ranges by name
    op_shapes: dict[str, list[list]]                 # shapes of each call of a host op, by name

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def group_s(self, group: str) -> float:
        return sum(op.dur_ns for op in self.ops if op.group == group) / 1e9

    def in_range_s(self, span: str) -> float:
        """Device time of the operations launched inside the host ranges
        named ``span``."""
        ranges = self.host_ranges.get(span, [])
        return sum(op.dur_ns for op in self.ops
                   if any(a <= op.launched_at_ns < b for a, b in ranges)) / 1e9


def _union_ns(intervals: list[tuple[int, int]], lo: int, hi: int) -> tuple[int, list[tuple[int, int]]]:
    """Total covered length of ``intervals`` clipped to [lo, hi], and the
    uncovered gaps."""
    busy, gaps, cursor = 0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps


def _host_at(times: list[int], host: list[tuple[int, int, str, int]], main_tid: int) -> list[str]:
    """For each time (sorted), "<harness span>/<host op>": the innermost
    harness span open on the main thread, and the most recently started
    host op still open on any thread."""
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    stacks: dict[int, list] = {}
    names, i = [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            a, b, name, tid = events[i]
            stacks.setdefault(tid, []).append((a, b, name))
            i += 1
        for stack in stacks.values():
            while stack and stack[-1][1] <= t:
                stack.pop()
            # a closed range under an open one also goes
            stack[:] = [e for e in stack if e[1] > t]
        harness = [e[2] for e in stacks.get(main_tid, []) if e[2].startswith(HARNESS_PREFIX)]
        ops = [s[-1] for s in stacks.values() if s and not s[-1][2].startswith(HARNESS_PREFIX)]
        op = max(ops)[2] if ops else "-"
        names.append(f"{harness[-1] if harness else 'outside'}/{op}")
    return names


def activity(e) -> str:
    """The event's kind, from its device and name: device events are
    copies, sets or kernels (a device-side range keeps its host range's
    name, and :func:`reduce` drops it), host events runtime calls, ops
    (``ns::name``) or ranges."""
    name = e.name()
    if e.device_type().name == "CUDA":
        low = name.lower()
        return "gpu_memcpy" if low.startswith("memcpy") else "gpu_memset" if low.startswith("memset") else "kernel"
    if _RUNTIME.match(name):
        return "cuda_runtime"
    return "cpu_op" if "::" in name else "user_annotation"


def reduce(events, steps: int, window_s: float | None = None) -> Trace:
    """``events``: the profiler's raw events (``prof.profiler.kineto_results
    .events()``) of ``steps`` traced steps. The window is the
    :data:`WINDOW_SPAN` range where the host was traced, else the span of
    all events; ``window_s`` is its length by the host's clock where the
    caller read it."""
    device, host, by_corr = [], [], {}
    ranges: dict[str, list[tuple[int, int]]] = {}
    shapes: dict[str, list[list]] = {}
    main_tid = None
    for e in events:
        kind = activity(e)
        if kind in DEVICE_KINDS:
            device.append(e)
            continue
        if kind not in HOST_KINDS:
            continue                                  # device-side ranges, queue records
        start, name = e.start_ns(), e.name()
        end = start + e.duration_ns()
        host.append((start, end, name, e.start_thread_id()))
        if kind in ("cuda_runtime", "cuda_driver"):
            continue
        by_corr[e.correlation_id()] = start
        if kind == "user_annotation":
            ranges.setdefault(name, []).append((start, end))
            if name == WINDOW_SPAN:
                main_tid = e.start_thread_id()
        elif name.startswith("vlb::"):
            shapes.setdefault(name, []).append(e.shapes())
    if WINDOW_SPAN in ranges:
        lo, hi = ranges[WINDOW_SPAN][0]
    else:
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device] + [h[:2] for h in host]
        if not spans:
            raise ValueError("an empty trace")
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans) + 1
    ops = []
    for e in device:
        start, name = e.start_ns(), e.name()
        if not lo <= start < hi or name in ranges or name == QUEUE_FULL:
            continue
        is_kernel = activity(e) == "kernel"
        launched_at = by_corr.get(e.linked_correlation_id(), -1)
        ops.append(DeviceOp(name, kernel_group(name, is_kernel), start, e.duration_ns(), launched_at))
    busy, gaps = _union_ns([(op.start_ns, op.start_ns + op.dur_ns) for op in ops], lo, hi)
    names = _host_at([a for a, _ in gaps], host, main_tid)
    return Trace(ops, (lo, hi), (hi - lo) / 1e9 if window_s is None else window_s, busy, steps,
                 [(n, b - a) for n, (a, b) in zip(names, gaps)], ranges, shapes)
