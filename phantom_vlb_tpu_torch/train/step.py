"""The eval step: forward, masked MSE + L2, streaming Pearson merge.

Counterpart of ``_masked_mse`` and ``make_eval_step`` in
``phantom_vlb_tpu/train/step.py`` (:95-100, :146-157). The loss is
``mse + l2`` with the MSE taken over the valid rows of the fixed-shape batch
only, so a partial final batch gives the mean over its real rows.
"""

from __future__ import annotations

from typing import Mapping

import torch

from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB
from phantom_vlb_tpu_torch.train.metrics import PearsonState, pearson_update

__all__ = ["masked_mse", "eval_step"]


def masked_mse(pred: torch.Tensor, y: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    m = row_mask.to(pred.dtype)[:, None]
    n_valid = row_mask.to(pred.dtype).sum().clamp_min(1.0)
    return ((pred - y.to(pred.dtype)).square() * m).sum() / (n_valid * y.shape[1])


@torch.inference_mode()
def eval_step(
    model: VideoLLaMA2VLB,
    batch: Mapping[str, torch.Tensor],
    pearson: PearsonState,
) -> tuple[PearsonState, dict[str, torch.Tensor]]:
    """One eval batch -> (updated Pearson state, {"brain_loss", "n", "pred"}).

    ``batch`` holds tensors on the model's device: language, vision (cached
    video tokens), padvals, vis_weights, lang_weights, timeseries, row_mask.
    """
    pred, l2_reg = model(
        batch["language"], batch["vision"], batch["padvals"],
        batch["vis_weights"], batch["lang_weights"],
    )
    loss = masked_mse(pred, batch["timeseries"], batch["row_mask"]) + l2_reg
    pearson = pearson_update(pearson, pred, batch["timeseries"], batch["row_mask"])
    return pearson, {"brain_loss": loss, "n": batch["row_mask"].sum(), "pred": pred}
