"""The share of the traced window in which no operation ran on the card,
in %: one minus the union of the device operations' intervals over the
window's host-clock length, in the pass that traces the device alone."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / 1e9 / tr.window_s)
