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
from phantom_vlb_tpu_torch.data.video import CLIP_MEAN, CLIP_STD

__all__ = ["CLIP_MEAN", "CLIP_STD", "preprocess", "DevicePreprocessor"]


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


class DevicePreprocessor:
    """The extraction pipeline's frame preprocessor on ``device`` (default
    the card; raises without one): a ``preprocess_batch`` for
    ``data/video.py``'s ``extract_video_features`` and a ``preprocessor``
    for its ``extract_video_chunk``. Takes uint8 (N, H, W, 3) frames (an
    array or a list of frames), returns host (N, 3, S, S) f32.

    Unlike the JAX package's, it pads no batch to a size bucket: the
    buckets there only spare XLA a recompile per unique-frame count, and
    eager PyTorch compiles nothing.
    """

    def __init__(self, image_size: int, device: str | torch.device = "cuda"):
        self.image_size = image_size
        self.device = resolve_device(device)

    def __call__(self, images) -> np.ndarray:
        batch = np.stack([np.asarray(img) for img in images])
        return preprocess(batch, self.image_size, self.device).cpu().numpy()
