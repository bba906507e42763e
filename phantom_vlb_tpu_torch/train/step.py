"""The train and eval steps: forward, masked MSE + L2, update or Pearson merge.

Counterpart of ``_masked_mse``, ``make_train_step`` and ``make_eval_step`` in
``phantom_vlb_tpu/train/step.py`` (:95-100, :103-143, :146-157). The loss is
``mse + l2`` with the MSE taken over the valid rows of the fixed-shape batch
only, so a partial final batch gives the mean over its real rows. A train
step runs the forward in train mode, the backward, the clip and the AdamW
update on the schedule; a non-finite loss leaves parameters, optimizer state
and step count untouched (:129-141). ``forward(model, batch, seed)`` gives
(predictions, l2 penalty); :func:`vlb_forward` is the VLB's, the default.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB
from phantom_vlb_tpu_torch.train.metrics import PearsonState, pearson_update
from phantom_vlb_tpu_torch.train.optim import AdamWCosine

__all__ = ["masked_mse", "vlb_forward", "loss_fn", "train_step", "eval_step"]


def masked_mse(pred: torch.Tensor, y: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    m = row_mask.to(pred.dtype)[:, None]
    n_valid = row_mask.to(pred.dtype).sum().clamp_min(1.0)
    return ((pred - y.to(pred.dtype)).square() * m).sum() / (n_valid * y.shape[1])


def vlb_forward(model: VideoLLaMA2VLB, batch: Mapping[str, torch.Tensor], seed: int | None = None):
    """The VLB's forward on a batch dict -> (predictions, l2 penalty)."""
    return model(batch["language"], batch["vision"], batch["padvals"],
                 batch["vis_weights"], batch["lang_weights"], seed=seed)


Forward = Callable[[torch.nn.Module, Mapping[str, torch.Tensor], "int | None"], tuple]


def loss_fn(model: torch.nn.Module, batch: Mapping[str, torch.Tensor], seed: int | None = None,
            forward: Forward = vlb_forward):
    """Forward in the model's current mode -> (loss, mse, l2)."""
    pred, l2_reg = forward(model, batch, seed)
    mse = masked_mse(pred, batch["timeseries"], batch["row_mask"])
    return mse + l2_reg, mse, l2_reg


def train_step(
    model: torch.nn.Module,
    optimizer: AdamWCosine,
    batch: Mapping[str, torch.Tensor],
    seed: int,
    forward: Forward = vlb_forward,
) -> dict[str, object]:
    """One update of ``optimizer.params`` on ``batch`` with dropout seed ``seed``.

    The model must be in train mode with ``requires_grad`` on exactly the
    trainable tensors. Returns {"brain_loss", "mse", "l2_reg", "grad_norm"}
    as tensors, "finite" and, for an applied update, "lr". The gradients
    stay in ``.grad`` (clipped) until the next step.
    """
    optimizer.zero_grad()
    loss, mse, l2_reg = loss_fn(model, batch, seed, forward)
    loss.backward()
    grad_norm = optimizer.clip_()
    out = {"brain_loss": loss.detach(), "mse": mse.detach(), "l2_reg": l2_reg.detach(),
           "grad_norm": grad_norm, "finite": bool(torch.isfinite(loss))}
    if out["finite"]:
        out["lr"] = optimizer.apply()
    return out


@torch.inference_mode()
def eval_step(
    model: torch.nn.Module,
    batch: Mapping[str, torch.Tensor],
    pearson: PearsonState,
    forward: Forward = vlb_forward,
) -> tuple[PearsonState, dict[str, torch.Tensor]]:
    """One eval batch -> (updated Pearson state, {"brain_loss", "n", "pred"}).

    ``batch`` holds tensors on the model's device: language, vision (cached
    video tokens or raw frames), padvals, vis_weights, lang_weights,
    timeseries, row_mask.
    """
    pred, l2_reg = forward(model, batch, None)
    loss = masked_mse(pred, batch["timeseries"], batch["row_mask"]) + l2_reg
    pearson = pearson_update(pearson, pred, batch["timeseries"], batch["row_mask"])
    return pearson, {"brain_loss": loss, "n": batch["row_mask"].sum(), "pred": pred}
