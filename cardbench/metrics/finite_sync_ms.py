"""The host's wait in the finiteness check, in ms: the program's
``finite_sync`` span (``train/step.py``: ``bool(torch.isfinite(loss))``
waits until the card has computed the loss), the mean over the steps of
the pass that traces the device alone (``spans.py``); 0.0 where it did not
wait."""

from cardbench.spans import SYNC, mean_ms, total_ns


def read(run):
    return mean_ms(run, lambda step: total_ns(step, SYNC))
