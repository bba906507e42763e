"""Synthetic language rows (numpy only).

Counterpart of ``synth_language_row`` and ``TEST_GEOMETRY`` in
``phantom_vlb_tpu/data/synthetic.py`` (:55); the same ``rng`` state gives the
same row. Token layout of a row::

    [prefix] [<video>=-201] [2 joiner + inst_len] [diag_len] [4 joiner] [pad_len zeros]
    |-------------------------- total = max_lang_tokens --------------------------|
"""

from __future__ import annotations

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID, VLBGeometry

__all__ = ["TEST_GEOMETRY", "synth_language_row"]

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
