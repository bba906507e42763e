"""Build CUDA sources into plain-C shared libraries and load them with ctypes.

Each ``csrc/*.cu`` file exports ``extern "C"`` launchers that take raw
pointers, sizes and a stream, and return ``cudaGetLastError()``. ``nvcc``
compiles one such file in seconds (no PyTorch headers are included). A
library is built at first use into ``build/phantom_vlb_tpu_torch/`` beside
the package (listed in ``.gitignore``), under a name that carries a hash of
the source, of every local header it includes (``#include "..."``, found
beside it, and theirs in turn) and of the flags, so an edited source or
header is rebuilt and an unchanged one is not. A source may also be built
with macros defined (a separate library).
:func:`build_all` starts one ``nvcc`` process per build, all at once, and
waits for them. Nothing here runs at import time: this module imports on
machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# Sources that call the CUDA driver API (``cuStreamWriteValue32``,
# ``cuTensorMapEncodeTiled``) link it.
LINK_FLAGS = {name: ("-lcuda",) for name in ("flash_fwd.cu", "ring_fwd.cu", "flash_bwd.cu",
                                              "lora_epilogue.cu", "lora_dropout.cu")}
# nvcc's report per build target (``-Xptxas -v``: registers, shared memory
# and spills per kernel); empty when the library was already built.
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _split(target) -> tuple[Path, tuple[str, ...]]:
    """A build target is a source path, or a (source, macros) pair."""
    return (Path(target[0]), tuple(target[1])) if isinstance(target, tuple) else (Path(target), ())


def _flags(source: Path, defines: tuple[str, ...] = ()) -> tuple[str, ...]:
    return NVCC_FLAGS + LINK_FLAGS.get(source.name, ()) + tuple(f"-D{d}" for d in defines)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: Path) -> list[Path]:
    """The source and the local headers it includes, transitively, each
    once, in the order first reached; an include not found beside its
    includer is a system header's business and is left out."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            cand = path.parent / name.decode()
            if cand.is_file():
                todo.append(cand.resolve())
    return seen


def _library(source: Path, defines: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256()
    for path in _sources(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(_flags(source, defines)).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(targets) -> dict:
    """Compile every target (a source, or a (source, macros) pair) whose
    library is missing, one ``nvcc`` process each, all started before any is
    waited for. Returns target -> library."""
    libs = {t: _library(*_split(t)) for t in targets}
    running = []
    for target, lib in libs.items():
        if lib.exists():
            BUILD_LOGS.setdefault(target, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        source, defines = _split(target)
        proc = subprocess.Popen(
            [_nvcc(), *_flags(source, defines), "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((target, lib, tmp, proc))
    failed = []
    for target, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {target}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
        BUILD_LOGS[target] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


class CudaKernel:
    """One ``extern "C"`` launcher of a ``csrc`` source.

    Built and loaded at the first :meth:`load`, with ``defines`` (macro
    names) defined if given. ``launches`` counts the successful launches
    made through :meth:`launch`, so a run can show that its path went
    through the kernel; callers may reset it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes: list, defines: tuple[str, ...] = ()):
        self.source = CSRC_DIR / source
        # What build_all builds: the source alone, or with the macros.
        self.target = (self.source, tuple(defines)) if defines else self.source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def build_log(self) -> str:
        return BUILD_LOGS.get(self.target, "")

    def load(self):
        if self._fn is None:
            path = build_all([self.target])[self.target]
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
