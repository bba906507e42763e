"""The benchmark's training batches, made on the host from the seed.

A batch is what the port's lazy-load loader yields: a dict of numpy arrays
(``language`` int32, ``vision`` f32 frames, ``padvals`` int32, the HRF
weights, the targets, ``row_mask``). Each language row follows the
lazy-load row layout (``[prefix] [<video>] [2 joiner + inst_len]
[diag_len] [4 joiner] [pad_len zeros]``, ``max_lang_tokens`` long): a
dialogue of ``dialogue_tokens`` tokens after a rolling-context prefix,
then pads. Every row of every batch differs; the same seed gives the same
pool, element for element.
"""

from __future__ import annotations

import numpy as np

__all__ = ["VIDEO_TOKEN_ID", "JOINER_PRE", "JOINER_POST", "Geometry", "language_row", "make_pool"]

VIDEO_TOKEN_ID = -201   # the <video> sentinel in the token stream
JOINER_PRE = 2          # chat-template joiner after <video>
JOINER_POST = 4         # the '[/INST]' tail


class Geometry:
    """The sample geometry of a configuration file's ``geometry`` group."""

    def __init__(self, g: dict):
        self.frames_per_tr = int(g["frames_per_tr"])
        self.window = int(g["window"])
        self.tr = float(g["tr"])
        self.model_max_length = int(g["model_max_length"])
        self.image_size = int(g["image_size"])
        self.patch_size = int(g["patch_size"])
        self.onsets_width = int(g["onsets_width"])
        self.num_frames = self.window * self.frames_per_tr
        self.num_ds_frames = self.num_frames // 2 + 1
        self.ds_grid = (self.image_size // self.patch_size) // 2 + 1
        self.tokens_per_frame = self.ds_grid ** 2
        self.num_vis_tokens = self.num_ds_frames * self.tokens_per_frame
        self.max_lang_tokens = self.model_max_length - self.num_vis_tokens + 1
        self.feature_len = self.num_vis_tokens + self.max_lang_tokens - 1


def language_row(geom: Geometry, rng: np.random.Generator, tr_time: float, vocab_size: int,
                 dialogue_tokens: tuple[int, int], inst_len: int):
    """One row's (token ids, dialogue onsets, [pad_len, inst_len, diag_len])."""
    lo, hi = dialogue_tokens
    hi = min(hi, geom.onsets_width, geom.max_lang_tokens - 1 - JOINER_PRE - inst_len - JOINER_POST - 2)
    diag_len = int(rng.integers(lo, hi + 1))
    budget = geom.max_lang_tokens - 1 - JOINER_PRE - inst_len - diag_len - JOINER_POST
    pad_len = int(rng.integers(0, max(1, budget - 1)))
    prefix_len = budget - pad_len

    def toks(n):
        return rng.integers(3, vocab_size, size=n, dtype=np.int64)

    ids = np.concatenate([toks(prefix_len), np.array([VIDEO_TOKEN_ID], np.int64),
                          toks(JOINER_PRE + inst_len), toks(diag_len), toks(JOINER_POST),
                          np.zeros(pad_len, np.int64)])
    onsets = np.zeros(geom.onsets_width, np.float64)
    onsets[:diag_len] = np.sort(rng.uniform(max(0.0, tr_time - geom.window * geom.tr), tr_time, diag_len))
    return ids, onsets, np.array([pad_len, inst_len, diag_len], np.int64)


def make_pool(geom: Geometry, rng: np.random.Generator, n_batches: int, batch: int, vocab_size: int,
              num_target: int, dialogue_tokens: tuple[int, int], inst_len: int) -> list[dict]:
    """``n_batches`` batches of ``batch`` rows from raw frames, N(0, 1)."""
    pool = []
    frame_shape = (batch, geom.num_frames, 3, geom.image_size, geom.image_size)
    for i in range(n_batches):
        rows = [language_row(geom, rng, (i * batch + r + 1) * geom.tr, vocab_size, dialogue_tokens, inst_len)
                for r in range(batch)]
        pool.append({
            "language": np.stack([r[0] for r in rows]).astype(np.int32),
            "vision": rng.standard_normal(frame_shape, dtype=np.float32),
            "padvals": np.stack([r[2] for r in rows]).astype(np.int32),
            "vis_weights": rng.uniform(0, 0.3, (batch, geom.num_ds_frames)).astype(np.float32),
            "lang_weights": rng.uniform(0, 0.3, (batch, geom.onsets_width)).astype(np.float32),
            "timeseries": rng.standard_normal((batch, num_target)).astype(np.float32),
            "row_mask": np.ones(batch, np.float32),
        })
    return pool
