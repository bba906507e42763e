"""Device time the step traced with the host spends in the vision tower, in ms: the
operations launched inside ``models/videollama2.py``'s ``vision`` range
(``encode_video``: CLIP ViT-L/14-336 and the STC connector)."""


def read(run):
    tr = run.host_trace
    if tr is None or "vision" not in tr.host_ranges:
        return None
    ms = tr.in_range_s("vision") * 1e3 / tr.steps
    return ms if ms > 0 else None
