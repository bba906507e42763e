"""Device time a traced step spends in library GEMM kernels (cuBLAS,
CUTLASS, cuDNN's implicit GEMMs), in ms: the decoder's projections above
all (``models/mistral.py``, ``models/lora.py``)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ms = tr.group_s("gemm") * 1e3 / tr.steps
    return ms if ms > 0 else None
