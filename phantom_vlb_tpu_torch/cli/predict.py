"""Serving: predictions, actuals and per-ROI Pearson r over a stream of batches.

Counterpart of the sweep in ``phantom_vlb_tpu/cli/predict.py`` (:24-71): the
frozen model's forward over each batch, the masked loss, and the streaming
Pearson merge, keeping only the valid rows of each fixed-shape batch. The
HDF5 writer, config composition and data loaders are not ported yet;
:func:`synthetic_batches` makes seeded inputs of the serving shapes instead,
with cached video tokens or raw frames.
"""

from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.data.synthetic import synth_language_row
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, VLBConfig
from phantom_vlb_tpu_torch.train.metrics import pearson_compute, pearson_init
from phantom_vlb_tpu_torch.train.step import eval_step

__all__ = ["predict_batches", "synthetic_batches"]


def predict_batches(
    model: VideoLLaMA2VLB,
    batches: Iterable[Mapping[str, object]],
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Run ``model`` over ``batches`` (numpy arrays or tensors, moved to ``device``).

    Returns ``predicted`` and ``actual`` (N valid rows, P), ``val_corr_roi``
    (P,), and per batch ``brain_loss`` and ``batch_ms`` (host wall time of
    the batch, ending when its loss has reached the host).
    """
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device != device:
        raise ValueError(f"model is on {param_device}, not {device}")
    pearson = pearson_init(model.cfg.num_target, device=device)
    preds, actual, losses, batch_ms = [], [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        pearson, out = eval_step(model, dev, pearson)
        losses.append(float(out["brain_loss"]))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        keep = dev["row_mask"] > 0
        preds.append(out["pred"][keep].float().cpu())
        actual.append(dev["timeseries"][keep].float().cpu())
    return {
        "predicted": torch.cat(preds).numpy(),
        "actual": torch.cat(actual).numpy(),
        "val_corr_roi": pearson_compute(pearson).cpu().numpy(),
        "brain_loss": np.asarray(losses),
        "batch_ms": np.asarray(batch_ms),
    }


def synthetic_batches(
    cfg: VLBConfig,
    n: int,
    batch: int,
    rng: np.random.Generator,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    frames: bool = False,
) -> list[dict]:
    """``n`` seeded batches: text rows from :func:`synth_language_row` and HRF
    weights, targets from ``rng``; and, made on ``device`` from
    ``generator``, either cached video tokens (N(0, 1), in the backbone's
    dtype) or, with ``frames``, normalised frames (B, T, 3, H, W) (N(0, 1),
    f32) for the vision towers."""
    device = resolve_device(device)
    g = cfg.geometry
    if frames:
        shape, dtype = (g.num_frames, 3, g.image_size, g.image_size), torch.float32
    else:
        shape, dtype = (g.num_vis_tokens, cfg.mistral.hidden_size), cfg.mistral.dtype
    out = []
    for i in range(n):
        rows = [synth_language_row(g, rng, (i * batch + r + 1) * g.tr) for r in range(batch)]
        out.append({
            "language": np.stack([r[0] for r in rows]),
            "vision": torch.randn(batch, *shape, generator=generator, device=device, dtype=dtype),
            "padvals": np.stack([r[2] for r in rows]),
            "vis_weights": rng.uniform(0, 0.3, (batch, g.num_ds_frames)).astype(np.float32),
            "lang_weights": rng.uniform(0, 0.3, (batch, g.onsets_width)).astype(np.float32),
            "timeseries": rng.standard_normal((batch, cfg.num_target)).astype(np.float32),
            "row_mask": np.ones(batch, np.float32),
        })
    return out
