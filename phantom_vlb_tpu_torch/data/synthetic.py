"""Synthetic stage inputs and outputs (numpy only).

Counterpart of ``phantom_vlb_tpu/data/synthetic.py`` (:55-153): the same
``rng`` state or seed gives the same rows, episodes and files (each a path
or an open store, as ``data/schemas.py`` takes them). Token layout of a
language row::

    [prefix] [<video>=-201] [2 joiner + inst_len] [diag_len] [4 joiner] [pad_len zeros]
    |-------------------------- total = max_lang_tokens --------------------------|
"""

from __future__ import annotations

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID, VLBGeometry
from phantom_vlb_tpu_torch.data.schemas import FeatureEpisode, opened, write_feature_episode

__all__ = ["TEST_GEOMETRY", "synth_language_row", "synth_feature_episode", "write_synthetic_features_file",
           "write_synthetic_bold_file"]

# Tiny geometry obeying all production invariants: 27 vision tokens
# (3 ds-frames x 9 tokens), 38 text tokens, multimodal seq 64.
TEST_GEOMETRY = VLBGeometry(
    tr=1.49, frames_per_tr=2, window=2, delay=1, model_max_length=64,
    image_size=56, patch_size=14, onsets_width=16, num_parcels=8,
)
TEST_GEOMETRY.validate()

JOINER_PRE = 2
JOINER_POST = 4


def synth_language_row(
    geom: VLBGeometry,
    rng: np.random.Generator,
    tr_time: float,
    vocab_size: int = 1000,
    inst_len: int = 4,
):
    """One TR's (token_ids, onsets, maskvals) honoring the layout contract."""
    max_diag = min(
        geom.onsets_width,
        geom.max_lang_tokens - 1 - JOINER_PRE - inst_len - JOINER_POST - 2,
    )
    diag_len = int(rng.integers(2, max_diag + 1))
    budget = geom.max_lang_tokens - 1 - JOINER_PRE - inst_len - diag_len - JOINER_POST
    pad_len = int(rng.integers(0, max(1, budget - 1)))
    prefix_len = budget - pad_len
    if prefix_len < 1:
        raise ValueError(f"geometry leaves no room for a prefix: {geom}")

    def toks(n):
        return rng.integers(3, vocab_size, size=n, dtype=np.int64)

    ids = np.concatenate([
        toks(prefix_len),
        np.array([VIDEO_TOKEN_ID], dtype=np.int64),
        toks(JOINER_PRE + inst_len),
        toks(diag_len),
        toks(JOINER_POST),
        np.zeros(pad_len, dtype=np.int64),
    ])

    # Dialogue token onsets: inside the current window, before the TR end.
    onsets = np.zeros(geom.onsets_width, dtype=np.float64)
    onsets[:diag_len] = np.sort(
        rng.uniform(max(0.0, tr_time - geom.window * geom.tr), tr_time, size=diag_len)
    )
    maskvals = np.array([pad_len, inst_len, diag_len], dtype=np.int64)
    return ids, onsets, maskvals


def synth_feature_episode(
    geom: VLBGeometry,
    n_tr: int,
    rng: np.random.Generator,
    vocab_size: int = 1000,
) -> FeatureEpisode:
    """An episode of ``n_tr`` language rows and standard-normal frames."""
    rows = [synth_language_row(geom, rng, (i + 1) * geom.tr, vocab_size) for i in range(n_tr)]
    video = rng.standard_normal(
        (n_tr, geom.num_frames, 3, geom.image_size, geom.image_size)
    ).astype(np.float32)
    return FeatureEpisode(
        transcript_features=np.stack([r[0] for r in rows]),
        transcript_onsets=np.stack([r[1] for r in rows]),
        masking_params=np.stack([r[2] for r in rows]),
        video_features=video,
    )


def write_synthetic_features_file(
    target,
    episodes: dict[str, int],
    geom: VLBGeometry,
    seed: int = 0,
    vocab_size: int = 1000,
) -> None:
    rng = np.random.default_rng(seed)
    for ep_name, n_tr in episodes.items():
        write_feature_episode(target, ep_name, synth_feature_episode(geom, n_tr, rng, vocab_size))


def write_synthetic_bold_file(
    target,
    episodes: dict[str, int],
    geom: VLBGeometry,
    seed: int = 1,
) -> None:
    """A subject's BOLD file (a path is created anew) with run keys shaped
    like the CNeuroMod layout: run ``ses-XXX_task-<episode>`` parses back to
    the episode, each run as long as its episode's stimulus."""
    rng = np.random.default_rng(seed)
    with opened(target, "w") as f:
        for i, (ep_name, n_tr) in enumerate(episodes.items()):
            ses = f.require_group(f"ses-{i + 1:03d}")
            data = rng.standard_normal((n_tr, geom.num_parcels)).astype(np.float32)
            ses.create_dataset(f"ses-{i + 1:03d}_task-{ep_name}", data=data)
