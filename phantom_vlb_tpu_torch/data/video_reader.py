"""Native video reader: ctypes over the libav decoder in ``native/decode/vlb_decode.cpp``.

Counterpart of ``phantom_vlb_tpu/data/video_reader.py`` (:29-156):
:class:`NativeVideoSource` implements ``data/video.py``'s ``VideoSource``
with decord's semantics (frames numbered in decode order,
``get_batch(indices)``). Decoding is forward-only with an LRU cache sized to
cover the overlapping TR windows of extraction, so a whole episode decodes
in one pass, each frame once. :func:`write_test_video` encodes a small
MPEG-4 test video, so tests need no ``ffmpeg`` binary.

The library is built at first use with ``g++`` from the shared source into
``build/phantom_vlb_tpu_torch/`` beside the package (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is not. It needs
the libav development files (``libavformat``, ``libavcodec``,
``libavutil``, ``libswscale``); without them the first use raises with the
compiler's message. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from collections import OrderedDict
from pathlib import Path

import numpy as np

from phantom_vlb_tpu_torch.ops._build import BUILD_DIR

__all__ = ["DECODE_SOURCE", "ensure_built", "NativeVideoSource", "write_test_video"]

DECODE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "decode" / "vlb_decode.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
_LIB = None


def _library() -> Path:
    digest = hashlib.sha256(DECODE_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"vlb_decode-{digest.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """The decoder's library, compiled with ``g++`` when missing."""
    lib = _library()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(DECODE_SOURCE),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {DECODE_SOURCE} (the decoder needs the libav development "
                           f"files):\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build never loads a partial file
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(ensure_built()))
        signatures = {
            "vlb_open": (ctypes.c_void_p, [ctypes.c_char_p]),
            "vlb_close": (None, [ctypes.c_void_p]),
            "vlb_fps": (ctypes.c_double, [ctypes.c_void_p]),
            "vlb_width": (ctypes.c_int, [ctypes.c_void_p]),
            "vlb_height": (ctypes.c_int, [ctypes.c_void_p]),
            "vlb_num_frames_estimate": (ctypes.c_long, [ctypes.c_void_p]),
            "vlb_count_frames": (ctypes.c_long, [ctypes.c_char_p]),
            "vlb_read_next": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_char_p]),
            "vlb_write_test_video": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_int, ctypes.c_double]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
    return _LIB


def write_test_video(path: str | Path, w: int, h: int, n: int, fps: float) -> None:
    """An MPEG-4 video of ``n`` frames of ``w`` x ``h`` at ``fps``."""
    rc = _lib().vlb_write_test_video(str(path).encode(), w, h, n, fps)
    if rc != 0:
        raise RuntimeError(f"vlb_write_test_video failed: {rc}")


class NativeVideoSource:
    """Frame-exact sequential reader with an overlap cache."""

    def __init__(self, path: str | Path, cache_size: int = 256, exact_count: bool = True):
        self.path = str(path)
        self._h = _lib().vlb_open(self.path.encode())
        if not self._h:
            raise IOError(f"cannot open video {path}")
        self._fps = float(_lib().vlb_fps(self._h))
        if exact_count:
            n = int(_lib().vlb_count_frames(self.path.encode()))
        else:
            n = int(_lib().vlb_num_frames_estimate(self._h))
        if n <= 0:
            self.close()
            raise IOError(f"cannot determine frame count for {path}")
        self._num_frames = n
        self._next = 0
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        self._w = int(_lib().vlb_width(self._h))
        self._hgt = int(_lib().vlb_height(self._h))

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def num_frames(self) -> int:
        return self._num_frames

    def get_batch(self, indices) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB frames."""
        return np.stack([self._get_frame(int(i)) for i in indices])

    def _reopen(self) -> None:
        _lib().vlb_close(self._h)
        self._h = _lib().vlb_open(self.path.encode())
        if not self._h:
            raise IOError(f"cannot reopen video {self.path}")
        self._next = 0

    def _decode_next(self) -> np.ndarray:
        buf = np.empty((self._hgt, self._w, 3), np.uint8)
        idx = _lib().vlb_read_next(self._h, buf.ctypes.data_as(ctypes.c_char_p))
        if idx < 0:
            raise EOFError(f"unexpected EOF at frame {self._next} of {self.path}")
        if idx != self._next:
            raise IOError(f"{self.path}: decoded frame {idx}, expected {self._next}")
        self._next += 1
        self._cache[idx] = buf
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return buf

    def _get_frame(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            return self._cache[idx]
        if idx < self._next:
            # Backward access beyond the cache: restart the stream (rare).
            self._reopen()
            self._cache.clear()
        frame = None
        while self._next <= idx:
            frame = self._decode_next()
        return frame

    def close(self) -> None:
        if getattr(self, "_h", None):
            _lib().vlb_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
