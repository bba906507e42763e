"""Stage 2: align extracted features with BOLD and write the lazy-load files.

Counterpart of ``phantom_vlb_tpu/data/lazyload_build.py`` (:44-164); each
file it writes is byte-equal to the JAX package's for the same inputs.

- Episodes present in both the features file and the subject's BOLD file are
  assigned to ``n_split`` chunks by ``floor(rank / (n_episodes/n_split))``.
- Per episode: drop the first ``window-1`` TRs of the features and
  ``(window-1)+delay`` TRs of BOLD; target-TR midpoints at
  ``((window-1)+delay+0.5+i)*tr``; sample count = min over modalities.
- Vision HRF weights: one shared vector per geometry (``num_ds_frames``
  values).
- Language HRF weights: per sample, ``get_hrf_weight(target_time - onset)``
  for the first ``diag_len`` entries; the remaining entries keep their
  stored (zero-padded) values.
- Output naming: ``friends_llFile_{subject}_{season}_n{i}.h5``.

The features and BOLD inputs are paths or open stores (``data/schemas.py``).
The output ``lazyload_path`` is a directory, where each split is a file, or
a store (e.g. a ``MemoryStore``), where each split is a group of that name.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data.hrf import get_hrf_weights
from phantom_vlb_tpu_torch.data.schemas import (
    LazySample,
    LazyloadWriter,
    bold_episode_keys,
    is_path,
    opened,
)

__all__ = ["LazyloadBuildConfig", "build_lazyload_dsets", "lazyload_filename", "infer_geometry"]


def lazyload_filename(subject: str, season: str, split: int) -> str:
    return f"friends_llFile_{subject}_{season}_n{split}.h5"


def infer_geometry(
    features,
    window: int = 3,
    delay: int = 3,
    tr: float = 1.49,
    patch_size: int = 14,
) -> VLBGeometry:
    """The full geometry from a features file's (or store's) shapes, so the
    builder's HRF weight vectors (num_ds_frames) and padding widths match
    the extraction geometry. Raises ValueError when the frames a sample
    are not a multiple of ``window``."""
    with opened(features) as f:
        ep = next(iter(f.keys()))
        n, num_frames, _, image_size, _ = f[ep]["video_features"].shape
        max_lang = f[ep]["transcript_features"].shape[1]
        onsets_width = f[ep]["transcript_onsets"].shape[1]

    if num_frames % window:
        raise ValueError(f"{num_frames} frames/sample not divisible by window={window}")
    probe = VLBGeometry(
        tr=tr,
        frames_per_tr=num_frames // window,
        window=window,
        delay=delay,
        model_max_length=0,  # fixed next from max_lang
        image_size=image_size,
        patch_size=patch_size,
        onsets_width=onsets_width,
    )
    geom = dataclasses.replace(probe, model_max_length=probe.num_vis_tokens + max_lang - 1)
    geom.validate()
    return geom


@dataclasses.dataclass
class LazyloadBuildConfig:
    features_path: object         # a path or an open store
    timeseries_path: object       # a path or an open store
    lazyload_path: object         # output directory, or a store to hold one group a split
    subject: str
    season: str
    n_split: int = 4
    geometry: VLBGeometry = dataclasses.field(default_factory=VLBGeometry)


def build_lazyload_dsets(config: LazyloadBuildConfig) -> list:
    """Build the ``n_split`` lazy-load files (or groups); returns their paths
    (or the groups)."""
    geom = config.geometry
    geom.validate()

    ep_keys = bold_episode_keys(config.timeseries_path)

    outputs: list = []
    with opened(config.features_path) as f_file, opened(config.timeseries_path) as b_file:
        epi_list = [x for x in f_file.keys() if x in ep_keys]
        chunk_idx = np.floor(
            np.arange(len(epi_list)) / (len(epi_list) / config.n_split)
        ).astype(int)

        # Shared per-geometry vision weights.
        vis_weights = get_hrf_weights(geom.vision_onset_deltas())

        for i in range(config.n_split):
            name = lazyload_filename(config.subject, config.season, i)
            if is_path(config.lazyload_path):
                target = Path(config.lazyload_path) / name
            else:
                target = config.lazyload_path.create_group(name)
            writer = LazyloadWriter(target)

            chunk_epi_list = np.array(epi_list)[chunk_idx == i].tolist()
            for ep_num in chunk_epi_list:
                ses, run = ep_keys[ep_num]
                run_tseries = np.asarray(b_file[ses][run])[geom.bold_offset:]
                run_tr_onsets = geom.target_tr_onsets(run_tseries.shape[0])

                grp = f_file[ep_num]
                run_vision = np.asarray(grp["video_features"])[geom.window_offset:]
                run_language = np.asarray(grp["transcript_features"])[geom.window_offset:]
                run_lang_onsets = np.asarray(grp["transcript_onsets"])[geom.window_offset:]
                run_maskval = np.asarray(grp["masking_params"])[geom.window_offset:]

                if run_maskval.shape[0] != run_language.shape[0]:
                    raise ValueError(f"{ep_num}: {run_maskval.shape[0]} masking rows for "
                                     f"{run_language.shape[0]} language rows")
                n_rows = min(run_tseries.shape[0], run_vision.shape[0], run_language.shape[0])

                samples = []
                for n in range(n_rows):
                    pad_len, inst_len, diag_len = (int(v) for v in run_maskval[n])
                    lang_weights = run_lang_onsets[n].astype(np.float64).copy()
                    if diag_len:
                        lang_weights[:diag_len] = get_hrf_weights(
                            run_tr_onsets[n] - lang_weights[:diag_len]
                        )
                    samples.append(
                        LazySample(
                            timeseries=run_tseries[n],
                            vision=run_vision[n],
                            vis_weights=vis_weights,
                            language=run_language[n],
                            lang_weights=lang_weights,
                            padvals=run_maskval[n],
                        )
                    )
                writer.append_many(samples)

            writer.finalize()
            outputs.append(str(target) if is_path(target) else target)

    return outputs
