"""Frame preprocessing on the device: square-pad, bicubic resize, normalise.

Counterpart of ``phantom_vlb_tpu/ops/preprocess.py`` (``_preprocess_jit``
:28-60): uint8 (N, H, W, 3) frames -> f32 / 255 -> centred square pad with
the CLIP mean's uint8 fill (``expand2square``) -> bicubic resize to
``image_size`` with antialiasing -> ``(x - mean) / std`` -> (N, 3, S, S).

The reference resizes with ``jax.image.resize(..., "bicubic",
antialias=True)``: Keys cubic weights (a = -0.5), the kernel widened by
input / output when shrinking, each output's weights normalised to sum 1.
PyTorch's ``interpolate(mode="bicubic", antialias=True)`` computes the same
weights (its antialiased path follows PIL, a = -0.5, edges renormalised),
and it is what runs here; ``tests/test_torch_vision_vlb.py`` holds the
result against ``device_preprocess``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from phantom_vlb_tpu_torch.core.device import resolve_device

__all__ = ["CLIP_MEAN", "CLIP_STD", "preprocess"]

# OpenAI CLIP normalisation (phantom_vlb_tpu/data/video.py:47-48).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(frames, image_size: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """uint8 (N, H, W, 3) frames (numpy or a tensor) -> (N, 3, S, S) f32
    normalised on ``device``."""
    device = resolve_device(device)
    x = torch.as_tensor(frames).to(device).float() / 255.0
    n, h, w, _ = x.shape
    mean = torch.as_tensor(CLIP_MEAN, device=device)
    std = torch.as_tensor(CLIP_STD, device=device)
    side = max(h, w)
    if h != w:
        fill = torch.floor(mean * 255.0) / 255.0
        square = fill.expand(n, side, side, 3).clone()
        top, left = (side - h) // 2, (side - w) // 2
        square[:, top:top + h, left:left + w] = x
        x = square
    x = x.permute(0, 3, 1, 2)
    if side != image_size:
        x = F.interpolate(x, size=(image_size, image_size), mode="bicubic", antialias=True,
                          align_corners=False)
    return ((x - mean[:, None, None]) / std[:, None, None]).contiguous()
