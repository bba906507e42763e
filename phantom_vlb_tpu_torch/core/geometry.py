"""VLB sample geometry: the arithmetic contract shared by every stage.

A numpy-only copy of ``phantom_vlb_tpu/core/geometry.py`` (importing that
module would import JAX through its package). For the defaults:

- ``num_frames``       = window * frames_per_tr                = 12
- ``num_ds_frames``    = floor(num_frames / 2) + 1             = 7
- ``ds_grid``          = floor((image_size / patch_size) / 2) + 1 = 13
- ``tokens_per_frame`` = ds_grid**2                            = 169
- ``num_vis_tokens``   = num_ds_frames * tokens_per_frame      = 1183
- ``max_lang_tokens``  = model_max_length - num_vis_tokens + 1 = 866
- ``feature_len``      = num_vis_tokens + max_lang_tokens - 1  = 2048
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["VLBGeometry", "REFERENCE_GEOMETRY", "VIDEO_TOKEN_ID"]

# Sentinel id of the <video> modal token in the tokenized text stream.
VIDEO_TOKEN_ID = -201


@dataclasses.dataclass(frozen=True)
class VLBGeometry:
    tr: float = 1.49                 # fMRI repetition time (s)
    frames_per_tr: int = 4
    window: int = 3                  # TRs of video per sample
    delay: int = 3                   # TRs between window end and target TR
    model_max_length: int = 2048     # LLM token budget (vision + text)
    image_size: int = 336
    patch_size: int = 14
    onsets_width: int = 64           # padded width of per-TR token onsets
    num_parcels: int = 1000          # brain readout targets

    @property
    def num_frames(self) -> int:
        return self.window * self.frames_per_tr

    @property
    def num_ds_frames(self) -> int:
        return math.floor(self.num_frames / 2) + 1

    @property
    def patch_grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        return self.image_size // self.patch_size

    @property
    def ds_grid(self) -> int:
        return math.floor(self.patch_grid / 2) + 1

    @property
    def tokens_per_frame(self) -> int:
        return self.ds_grid**2

    @property
    def num_vis_tokens(self) -> int:
        return self.num_ds_frames * self.tokens_per_frame

    @property
    def max_lang_tokens(self) -> int:
        return self.model_max_length - self.num_vis_tokens + 1

    @property
    def feature_len(self) -> int:
        """Multimodal sequence length after the <video> splice."""
        return self.num_vis_tokens + self.max_lang_tokens - 1

    @property
    def window_offset(self) -> int:
        """TRs dropped from the head of the feature arrays (window - 1)."""
        return self.window - 1

    @property
    def bold_offset(self) -> int:
        """TRs dropped from the head of the BOLD timeseries."""
        return self.window_offset + self.delay

    @property
    def abs_tr_delay(self) -> float:
        """Window onset -> target-TR midpoint distance, in TRs (= 5.5)."""
        return self.bold_offset + 0.5

    def target_tr_onsets(self, n: int) -> np.ndarray:
        """Target-TR midpoints (s, from episode onset) for n samples."""
        return (self.bold_offset + 0.5 + np.arange(n, dtype=np.float64)) * self.tr

    def vision_onset_deltas(self) -> np.ndarray:
        """Time (s) from each downsampled frame to the target-TR midpoint:
        ``num_ds_frames`` values stepping back ``window / (num_ds_frames - 1)``
        TRs from ``abs_tr_delay``."""
        step = self.window / (self.num_ds_frames - 1)
        return self.tr * (self.abs_tr_delay - step * np.arange(self.num_ds_frames))

    def validate(self) -> None:
        if self.feature_len != self.model_max_length:
            raise ValueError(
                f"feature_len {self.feature_len} != model_max_length "
                f"{self.model_max_length}: pick model_max_length >= num_vis_tokens"
            )
        if self.num_ds_frames < 2 or self.max_lang_tokens <= 0:
            raise ValueError(f"degenerate geometry {self}")


REFERENCE_GEOMETRY = VLBGeometry()
REFERENCE_GEOMETRY.validate()
