"""The program's spans (``phantom_vlb_tpu_torch/utils/profiling.py``
``span``) read against the pass that traces the device alone.

The program records its spans while any ``torch.profiler`` session is
active, so both of the harness's traced passes leave records. A step is
the tree under one ``train_one`` root; :func:`steps` keeps the steps whose
root overlaps the device-only pass's window, which drops the host-traced
step (it runs after that window, and the host tracer makes its spans
longer). Spans and device records share the profiler's clock (Unix-epoch
ns). A program without the recorder gives no records, and every reader
then gives nothing.
"""

from __future__ import annotations

from cardbench.trace import _union_ns

__all__ = ["ROOT", "SYNC", "OUTSIDE", "records", "steps", "mean_ms", "total_ns", "idle_by_span",
           "issuing_idle_ns", "table"]

ROOT = "train_one"
SYNC = "finite_sync"
OUTSIDE = -1        # idle_by_span's key for the instants no span was open


def records() -> list:
    """The program's closed spans (``SpanRecord``: index, name, start_ns,
    end_ns, parent, step), or none where the program has no recorder."""
    from phantom_vlb_tpu_torch.utils import profiling

    recorder = getattr(profiling, "SPANS", None)
    return [] if recorder is None else list(recorder.records)


def steps(trace, recs: list) -> dict[int, list]:
    """The records of each step whose ``train_one`` root overlaps the
    trace's window, by the root's index."""
    lo, hi = trace.window_ns
    out = {r.index: [] for r in recs if r.parent == -1 and r.name == ROOT and r.start_ns < hi and r.end_ns > lo}
    for r in recs:
        if r.step in out:
            out[r.step].append(r)
    return out


def total_ns(step: list, name: str) -> int:
    """The summed length of the step's spans named ``name`` (0: none)."""
    return sum(r.dur_ns for r in step if r.name == name)


def mean_ms(run, measure) -> float | None:
    """The mean over the device-only pass's steps of ``measure(step)`` ns,
    in ms; nothing without that pass or without spans in it."""
    if run.trace is None:
        return None
    by_step = steps(run.trace, records())
    if not by_step:
        return None
    return sum(measure(step) for step in by_step.values()) / len(by_step) / 1e6


def idle_by_span(trace, recs: list) -> dict[int, int]:
    """Each ns of the window in which no device operation ran, put down to
    the innermost span open at that instant (the latest opened of those
    open), by its index, or to :data:`OUTSIDE`. The values sum to the
    window's idle time."""
    lo, hi = trace.window_ns
    _, gaps = _union_ns([(op.start_ns, op.start_ns + op.dur_ns) for op in trace.ops], lo, hi)
    # a span of no length holds no instant
    inside = [r for r in recs if r.start_ns < hi and r.end_ns > lo and r.end_ns > r.start_ns]
    # at one instant a span that closes goes before one that opens
    events = sorted([(r.start_ns, 1, r.index) for r in inside] + [(r.end_ns, 0, r.index) for r in inside])
    cuts = sorted({t for gap in gaps for t in gap} | {min(max(t, lo), hi) for t, _, _ in events})
    idle: dict[int, int] = {}
    open_, e, g = set(), 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while e < len(events) and events[e][0] <= a:
            _, opens, index = events[e]
            (open_.add if opens else open_.discard)(index)
            e += 1
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            key = max(open_) if open_ else OUTSIDE
            idle[key] = idle.get(key, 0) + b - a
    return idle


def issuing_idle_ns(trace, recs: list) -> tuple[int, int]:
    """(idle ns under a ``train_one`` root of the window's steps and under
    no ``finite_sync``, the number of those steps)."""
    by_step = steps(trace, recs)
    by_index = {r.index: r for r in recs}
    total = 0
    for index, ns in idle_by_span(trace, recs).items():
        chain, r = set(), by_index.get(index)
        while r is not None:
            chain.add(r.name)
            r = by_index.get(r.parent)
        if index in by_index and by_index[index].step in by_step and SYNC not in chain:
            total += ns
    return total, len(by_step)


def table(trace, recs: list) -> dict:
    """The device-only pass by span name, in ms a step over the window's
    steps: its idle time (:func:`idle_by_span`, with ``outside`` for
    :data:`OUTSIDE`; the values sum to ``idle_ms``), and the host's length
    and self time (length less the children's) of each span of those steps."""
    by_step = steps(trace, recs)
    n = len(by_step) or 1
    names = {r.index: r.name for r in recs}
    idle: dict[str, float] = {}
    for index, ns in idle_by_span(trace, recs).items():
        key = "outside" if index == OUTSIDE else names[index]
        idle[key] = idle.get(key, 0.0) + ns / n / 1e6
    children: dict[int, int] = {}
    for r in recs:
        children[r.parent] = children.get(r.parent, 0) + r.dur_ns
    dur: dict[str, float] = {}
    own: dict[str, float] = {}
    for step in by_step.values():
        for r in step:
            dur[r.name] = dur.get(r.name, 0.0) + r.dur_ns / n / 1e6
            own[r.name] = own.get(r.name, 0.0) + (r.dur_ns - children.get(r.index, 0)) / n / 1e6
    lo, hi = trace.window_ns
    return {"steps": len(by_step), "idle_ms": (hi - lo - trace.busy_ns) / n / 1e6, "idle_ms_by_span": idle,
            "ms_by_span": dur, "self_ms_by_span": own}
