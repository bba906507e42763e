"""The card idle while the program's host issued the step, in ms: of the
pass that traces the device alone, each ns in which no device operation
ran, put down to the innermost program span open then (``spans.py``), and
summed where that span lies under a ``train_one`` root and under no
``finite_sync``; the mean over the pass's steps. Nothing without device
operations."""

from cardbench.spans import issuing_idle_ns, records


def read(run):
    tr = run.trace
    if tr is None or tr.busy_ns <= 0:
        return None
    ns, steps = issuing_idle_ns(tr, records())
    return ns / steps / 1e6 if steps else None
