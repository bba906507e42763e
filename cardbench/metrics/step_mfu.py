"""The model step's share of the card's bf16 peak, in %: the operations
every step of the measured window needs (``flops.step_flops``: no
recompute) over the window's host-clock time times the peak of the card
(``flops.PEAKS``). Nothing where the card's peak is not in the table."""


def read(run):
    if run.peaks is None or not run.steps or run.window_s <= 0:
        return None
    return 100.0 * run.steps * run.step_flops / (run.window_s * run.peaks["bf16_flops"])
