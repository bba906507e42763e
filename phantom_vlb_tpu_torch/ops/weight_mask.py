"""HRF weight mask over the multimodal sequence (vectorised gathers).

Counterpart of ``phantom_vlb_tpu/ops/weight_mask.py:33``. Layout per sample,
as positions in the ``feature_len`` sequence::

    [pad_left zeros]
    [num_vis_tokens vision weights: vis_weights[f] repeated tokens_per_frame x]
    [JOINER_PRE + inst_len zeros]
    [diag_len language weights]
    [JOINER_POST + pad_len zeros]
"""

from __future__ import annotations

import torch

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry

__all__ = ["build_weight_mask", "JOINER_PRE", "JOINER_POST"]

JOINER_PRE = 2    # chat-template joiner after <video>
JOINER_POST = 4   # '[/INST]' tail


def build_weight_mask(
    padvals: torch.Tensor,        # (B, 3) int  [pad_len, inst_len, diag_len]
    vis_weights: torch.Tensor,    # (B, num_ds_frames)
    lang_weights: torch.Tensor,   # (B, onsets_width)
    geom: VLBGeometry,
) -> torch.Tensor:
    """Return the (B, feature_len) f32 HRF weight mask."""
    L, V = geom.feature_len, geom.num_vis_tokens
    padvals = padvals.long()
    pad_len, inst_len, diag_len = padvals[:, 0:1], padvals[:, 1:2], padvals[:, 2:3]

    pos = torch.arange(L, device=padvals.device)[None, :]
    trial_len = V + JOINER_PRE + inst_len + diag_len + JOINER_POST + pad_len
    pad_left = L - trial_len                                     # (B, 1)

    vis_off = pos - pad_left                                     # (B, L)
    in_vis = (vis_off >= 0) & (vis_off < V)
    frame_idx = torch.div(vis_off, geom.tokens_per_frame, rounding_mode="floor")
    frame_idx = frame_idx.clamp(0, geom.num_ds_frames - 1)
    vis = torch.gather(vis_weights.float(), 1, frame_idx)

    lang_off = pos - (pad_left + V + JOINER_PRE + inst_len)
    in_lang = (lang_off >= 0) & (lang_off < diag_len)
    lang = torch.gather(lang_weights.float(), 1, lang_off.clamp(0, geom.onsets_width - 1))

    zero = torch.zeros((), device=padvals.device)
    return torch.where(in_vis, vis, zero) + torch.where(in_lang, lang, zero)
