"""The worst step of the measured window, in ms: the harness's host-clock
span around each ``VLBTrainer.train_one`` call (a step ends when the call
returns; its finiteness check waits for the card). It shows stalls."""


def read(run):
    return max(run.step_s) * 1e3 if run.step_s else None
