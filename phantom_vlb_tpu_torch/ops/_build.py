"""Build a CUDA source into a plain-C shared library and load it with ctypes.

Each ``csrc/*.cu`` file exports ``extern "C"`` launchers that take raw
pointers, sizes and a stream, and return ``cudaGetLastError()``. ``nvcc``
compiles one such file in seconds (no PyTorch headers are included). The
library is built at first use into ``build/phantom_vlb_tpu_torch/`` beside
the package (listed in ``.gitignore``), under a name that carries a hash of
the source and flags, so an edited source is rebuilt and an unchanged one is
not. Nothing here runs at import time: this module imports on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CudaKernel", "BUILD_DIR", "NVCC_FLAGS"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phantom_vlb_tpu_torch"
# sm_90a (not sm_90): keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` unless a library of the same hash exists.

    Returns the library path and nvcc's report (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when the library was cached).
    """
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, proc.stdout + proc.stderr


class CudaKernel:
    """One ``extern "C"`` launcher of a ``csrc`` source.

    Built and loaded at the first :meth:`load`. ``launches`` counts the
    successful launches made through :meth:`launch`, so a run can show that
    its path went through the kernel; callers may reset it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def load(self):
        if self._fn is None:
            path, self.build_log = _build(self.source)
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
