"""Build CUDA sources into plain-C shared libraries and load them with ctypes.

Each ``csrc/*.cu`` file exports ``extern "C"`` launchers that take raw
pointers, sizes and a stream, and return ``cudaGetLastError()``. ``nvcc``
compiles one such file in seconds (no PyTorch headers are included). A
library is built at first use into ``build/phantom_vlb_tpu_torch/`` beside
the package (listed in ``.gitignore``), under a name that carries a hash of
the source and flags, so an edited source is rebuilt and an unchanged one is
not. :func:`build_all` starts one ``nvcc`` process per source, all at once,
and waits for them. Nothing here runs at import time: this module imports on
machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CudaKernel", "BUILD_DIR", "NVCC_FLAGS", "build_all"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phantom_vlb_tpu_torch"
# sm_90a (not sm_90): keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Sources that call the CUDA driver API (``cuStreamWriteValue32``) link it.
LINK_FLAGS = {"ring_fwd.cu": ("-lcuda",)}
# nvcc's report per source (``-Xptxas -v``: registers, shared memory and
# spills per kernel); empty when the library was already built.
BUILD_LOGS: dict[Path, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(source: Path) -> tuple[str, ...]:
    return NVCC_FLAGS + LINK_FLAGS.get(source.name, ())


def _library(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(_flags(source)).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources) -> dict[Path, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started before any is waited for. Returns source -> library."""
    libs = {Path(s): _library(Path(s)) for s in sources}
    running = []
    for source, lib in libs.items():
        if lib.exists():
            BUILD_LOGS.setdefault(source, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(source), "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
        BUILD_LOGS[source] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


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
        self._fn = None

    @property
    def build_log(self) -> str:
        return BUILD_LOGS.get(self.source, "")

    def load(self):
        if self._fn is None:
            path = build_all([self.source])[self.source]
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, count: int = 1) -> None:
        """Call the launcher; ``count`` is the number of kernel launches it
        makes (one for most)."""
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += count
