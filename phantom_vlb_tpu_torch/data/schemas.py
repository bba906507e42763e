"""The three HDF5 layouts of the pipeline's stages, read and written.

Counterpart of ``phantom_vlb_tpu/data/schemas.py`` (:51-209), making the
same h5py calls in the same order, so a file written here is byte-equal to
the JAX package's for the same data:

1. **Features file** (per season): one group per episode with gzip-4
   datasets ``transcript_features`` (n_TR, max_lang_tokens) int64,
   ``transcript_onsets`` (n_TR, onsets_width) float64, ``masking_params``
   (n_TR, 3) int64 = [pad_len, inst_len, diag_len], ``video_features``
   (n_TR, num_frames, 3, image, image) float32.
2. **BOLD timeseries file** (per subject): groups ``<ses>`` holding datasets
   named ``*_task-<episode>*`` of shape (n_TR, num_parcels).
3. **Lazy-load file** (per subject x season x split): groups ``{idx}`` with
   uncompressed datasets ``{idx}_timeseries`` (num_parcels,),
   ``{idx}_vision`` (num_frames, 3, image, image), ``{idx}_vis_weights``
   (num_ds_frames,), ``{idx}_language`` (max_lang_tokens,),
   ``{idx}_lang_weights`` (onsets_width,), ``{idx}_padvals`` (3,), and a
   root dataset ``dset_len`` = [n].

Every function takes a path, where h5py opens the file, or an open store
with h5py's group interface (``create_group``, ``create_dataset``,
``keys``, ``[]``, ``in``), such as :class:`MemoryStore`, which keeps the
layout in host memory. ``h5py`` is imported where a file is opened
(:func:`import_h5py`), so the module imports on a machine without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Iterator

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry

__all__ = [
    "GZIP4", "MemoryStore", "import_h5py", "open_h5", "is_path", "opened",
    "FeatureEpisode", "write_feature_episode", "read_feature_episode", "list_feature_episodes",
    "bold_episode_keys", "LazySample", "LazyloadWriter", "read_lazy_sample", "lazyload_len",
    "validate_features_file", "validate_lazyload_file", "iter_lazy_samples",
]

GZIP4 = {"compression": "gzip", "compression_opts": 4}


class MemoryStore(dict):
    """An in-memory store with the part of h5py's group interface the
    layouts use (``create_group``, ``require_group``, ``create_dataset``,
    ``keys``, ``[]``, ``in``), for a caller that keeps them in host memory
    instead of an HDF5 file. Compression options are accepted and ignored."""

    def create_group(self, name):
        self[name] = MemoryStore()
        return self[name]

    def require_group(self, name):
        return self[name] if name in self else self.create_group(name)

    def create_dataset(self, name, data, **options):
        self[name] = np.array(data)
        return self[name]


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


def is_path(target) -> bool:
    """Whether ``target`` names a file (else it is an open store)."""
    return isinstance(target, (str, os.PathLike))


@contextlib.contextmanager
def opened(target, mode: str = "r"):
    """The HDF5 file at ``target`` opened in ``mode`` for the block, or
    ``target`` itself when it is an open store."""
    if is_path(target):
        with open_h5(target, mode) as f:
            yield f
    else:
        yield target


@dataclasses.dataclass
class FeatureEpisode:
    """One episode's extracted features (stage-1 output)."""

    transcript_features: np.ndarray  # (n_TR, max_lang_tokens) int
    transcript_onsets: np.ndarray    # (n_TR, onsets_width) float
    masking_params: np.ndarray       # (n_TR, 3) int
    video_features: np.ndarray       # (n_TR, num_frames, 3, H, W) float32

    FIELDS = ("transcript_features", "transcript_onsets", "masking_params", "video_features")

    def validate(self, geom: VLBGeometry) -> None:
        """Raise ValueError unless the arrays have the geometry's widths. The
        video may have another TR count than the text (they come from
        independent loops; the builder aligns them)."""
        n = self.transcript_features.shape[0]
        want = {"transcript_features": (n, geom.max_lang_tokens),
                "transcript_onsets": (n, geom.onsets_width), "masking_params": (n, 3)}
        for field, shape in want.items():
            if getattr(self, field).shape != shape:
                raise ValueError(f"{field} has shape {getattr(self, field).shape}, want {shape}")
        v = self.video_features
        if v.ndim != 5 or v.shape[1:] != (geom.num_frames, 3, geom.image_size, geom.image_size):
            raise ValueError(f"video_features has shape {v.shape}, want (n_TR, {geom.num_frames}, 3, "
                             f"{geom.image_size}, {geom.image_size})")


def write_feature_episode(target, episode: str, ep: FeatureEpisode) -> None:
    with opened(target, "a") as f:
        group = f.create_group(episode) if episode not in f else f[episode]
        for field in FeatureEpisode.FIELDS:
            group.create_dataset(field, data=getattr(ep, field), **GZIP4)


def read_feature_episode(target, episode: str) -> FeatureEpisode:
    with opened(target) as f:
        g = f[episode]
        return FeatureEpisode(**{field: np.asarray(g[field]) for field in FeatureEpisode.FIELDS})


def list_feature_episodes(target) -> list[str]:
    """Episodes already present (the resume contract). A path with no file
    behind it gets an empty file."""
    if is_path(target) and not Path(target).exists():
        with open_h5(target, "w"):
            pass
        return []
    with opened(target) as f:
        return sorted(f.keys())


def bold_episode_keys(target) -> dict[str, tuple[str, str]]:
    """Map episode id -> (session, run) of a subject's BOLD file: a run name
    carries the episode as the last dash field of its second underscore
    field, e.g. ``ses-001_task-s01e02a`` -> ``s01e02a``."""
    with opened(target) as f:
        return {run.split("_")[1].split("-")[-1]: (ses, run)
                for ses, val in f.items() for run in val.keys()}


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


class LazyloadWriter:
    """Appends samples under sequential ``{idx}`` groups; finalizes ``dset_len``."""

    def __init__(self, target):
        self.target = Path(target) if is_path(target) else target
        self.idx = 0

    def append_many(self, samples: list[LazySample]) -> None:
        """An episode's samples, in one open of the file."""
        with opened(self.target, "a") as f:
            for sample in samples:
                group = f.create_group(f"{self.idx}")
                for field in LazySample.FIELDS:
                    group.create_dataset(f"{self.idx}_{field}", data=getattr(sample, field))
                self.idx += 1

    def finalize(self) -> int:
        with opened(self.target, "a") as f:
            f.create_dataset("dset_len", data=[self.idx])
        return self.idx


def read_lazy_sample(f, idx: int) -> LazySample:
    """Sample ``idx`` of an open lazy-load file or store."""
    g = f[f"{idx}"]
    return LazySample(**{field: np.asarray(g[f"{idx}_{field}"]) for field in LazySample.FIELDS})


def lazyload_len(target) -> int:
    with opened(target) as f:
        return int(np.asarray(f["dset_len"])[0])


def validate_features_file(target, geom: VLBGeometry) -> list[str]:
    episodes = list_feature_episodes(target)
    for ep in episodes:
        read_feature_episode(target, ep).validate(geom)
    return episodes


def validate_lazyload_file(target, geom: VLBGeometry) -> int:
    """The sample count; raises ValueError if the first or last sample does
    not have the geometry's shapes."""
    n = lazyload_len(target)
    want = {"timeseries": (geom.num_parcels,),
            "vision": (geom.num_frames, 3, geom.image_size, geom.image_size),
            "vis_weights": (geom.num_ds_frames,), "language": (geom.max_lang_tokens,),
            "lang_weights": (geom.onsets_width,), "padvals": (3,)}
    with opened(target) as f:
        for idx in (0, n - 1) if n else ():
            s = read_lazy_sample(f, idx)
            for field, shape in want.items():
                if getattr(s, field).shape != shape:
                    raise ValueError(f"sample {idx}'s {field} has shape {getattr(s, field).shape}, "
                                     f"want {shape}")
    return n


def iter_lazy_samples(target) -> Iterator[LazySample]:
    n = lazyload_len(target)
    with opened(target) as f:
        for idx in range(n):
            yield read_lazy_sample(f, idx)
