"""Device time a traced step spends in eager kernels, in ms: every kernel
that is neither a library GEMM, nor library attention, nor one of the
port's kernels (elementwise, norm, RoPE, dropout, reduction, optimizer)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ms = tr.group_s("eager") * 1e3 / tr.steps
    return ms if ms > 0 else None
