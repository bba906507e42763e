"""The host's time issuing a step, in ms: the program's ``train_one`` span
(``train/loop.py`` ``VLBTrainer.train_one``: Python, dispatch and launches
of the put, forward, backward, clip and update) less its ``finite_sync``
span (``train/step.py``: the wait for the card), the mean over the steps
of the pass that traces the device alone (``spans.py``)."""

from cardbench.spans import ROOT, SYNC, mean_ms, total_ns


def read(run):
    return mean_ms(run, lambda step: total_ns(step, ROOT) - total_ns(step, SYNC))
