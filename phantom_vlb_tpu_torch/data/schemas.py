"""The lazy-load HDF5 file, read side.

Counterpart of ``LazySample``, ``read_lazy_sample`` and ``lazyload_len`` in
``phantom_vlb_tpu/data/schemas.py`` (:123-177). A lazy-load file (per
subject x season x split) holds groups ``{idx}`` with uncompressed datasets
``{idx}_timeseries`` (num_parcels,), ``{idx}_vision`` (num_frames, 3,
image, image), ``{idx}_vis_weights`` (num_ds_frames,), ``{idx}_language``
(max_lang_tokens,), ``{idx}_lang_weights`` (onsets_width,),
``{idx}_padvals`` (3,), and a root dataset ``dset_len`` = [n].

``h5py`` is imported where a file is opened (:func:`import_h5py`), so the
module imports on a machine without it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["LazySample", "import_h5py", "open_h5", "read_lazy_sample", "lazyload_len"]


@dataclasses.dataclass
class LazySample:
    """One training examplar."""

    timeseries: np.ndarray    # (num_parcels,)
    vision: np.ndarray        # (num_frames, 3, H, W) float32
    vis_weights: np.ndarray   # (num_ds_frames,)
    language: np.ndarray      # (max_lang_tokens,) int
    lang_weights: np.ndarray  # (onsets_width,)
    padvals: np.ndarray       # (3,) int = [pad_len, inst_len, diag_len]

    FIELDS = ("timeseries", "vision", "vis_weights", "language", "lang_weights", "padvals")


def import_h5py(purpose: str):
    """The ``h5py`` module; raises an ImportError that names h5py when it is
    not installed."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{purpose} needs h5py, which is not installed") from e
    return h5py


def open_h5(path: str | Path, mode: str = "r"):
    """``h5py.File(path, mode)`` (see :func:`import_h5py`)."""
    return import_h5py(f"opening the HDF5 file {path}").File(path, mode)


def read_lazy_sample(f, idx: int) -> LazySample:
    """Sample ``idx`` of an open lazy-load file."""
    g = f[f"{idx}"]
    return LazySample(**{field: np.asarray(g[f"{idx}_{field}"]) for field in LazySample.FIELDS})


def lazyload_len(path: str | Path) -> int:
    with open_h5(path) as f:
        return int(np.asarray(f["dset_len"])[0])
