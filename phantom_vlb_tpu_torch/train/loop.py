"""Training over a stream of batches: the per-step loop of the trainer.

Counterpart of the step loop of ``VLBTrainer.fit`` in
``phantom_vlb_tpu/train/loop.py`` (:223-287): each batch is moved to the
device, gets a fresh dropout seed from ``generator``, and goes through
:func:`train_step`. Validation cadence, early stopping, resume and
checkpoints are not ported yet.
"""

from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, trainable_parameters
from phantom_vlb_tpu_torch.train.optim import AdamWCosine
from phantom_vlb_tpu_torch.train.step import train_step

__all__ = ["train_batches"]


def train_batches(
    model: VideoLLaMA2VLB,
    batches: Iterable[Mapping[str, object]],
    *,
    device: str | torch.device = "cuda",
    generator: torch.Generator,
    optimizer: AdamWCosine | None = None,
) -> dict[str, np.ndarray]:
    """Train ``model`` on ``batches`` (numpy arrays or tensors), one update each.

    ``generator`` (a CPU generator) draws each step's dropout seed.
    ``optimizer`` carries AdamW's state and the step count across calls; a
    new one with the reference's recipe over :func:`trainable_parameters`
    is made when it is None.
    Returns per step ``step_ms`` (host wall time from the batch's transfer
    to the end of its update on the device), ``brain_loss``, ``grad_norm``
    (before the clip) and ``finite``.
    """
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device != device:
        raise ValueError(f"model is on {param_device}, not {device}")
    if optimizer is None:
        optimizer = AdamWCosine(trainable_parameters(model))
    model.train()
    step_ms, losses, norms, finite = [], [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        seed = int(torch.randint(0, 2**32, (), generator=generator))
        out = train_step(model, optimizer, dev, seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["brain_loss"]))
        norms.append(float(out["grad_norm"]))
        finite.append(out["finite"])
    return {"step_ms": np.asarray(step_ms), "brain_loss": np.asarray(losses),
            "grad_norm": np.asarray(norms), "finite": np.asarray(finite)}
