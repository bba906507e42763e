"""The batch's copy to the card, in ms: the program's ``put`` span
(``train/loop.py`` ``VLBTrainer._put``: frames, tokens and targets from
host memory), the mean over the steps of the pass that traces the device
alone (``spans.py``)."""

from cardbench.spans import mean_ms, total_ns


def read(run):
    return mean_ms(run, lambda step: total_ns(step, "put"))
