"""The train and eval steps: forward, masked MSE + L2, update or Pearson merge.

Counterpart of ``_masked_mse``, ``make_train_step`` and ``make_eval_step`` in
``phantom_vlb_tpu/train/step.py`` (:95-100, :103-143, :146-157). The loss is
``mse + l2`` with the MSE taken over the valid rows of the fixed-shape batch
only, so a partial final batch gives the mean over its real rows. A train
step runs the forward in train mode, the backward, the clip and the AdamW
update on the schedule; a non-finite loss leaves parameters, optimizer state
and step count untouched (:129-141). ``forward(model, batch, seed)`` gives
(predictions, l2 penalty); :func:`vlb_forward` is the VLB's, the default.
A train step's stages run in spans (``utils/profiling.py``): ``forward``,
``backward``, ``clip``, ``finite_sync`` (the host's wait for the loss)
and ``update``.

Under a sharded ``mesh`` (``core/mesh.py``) each rank holds its rows of the
global batch: its loss is its rows' squared errors over the global count
of valid rows (summed over the batch axes first), with the L2 penalty on
batch coordinate 0 alone, so the batch coordinates' losses and gradients
sum to the one-card step's (``parallel/sharding.py`` has FSDP2 sum the
gradients, not average them); the dropout masks are the global batch's on
the rank's rows. The ``tensor`` ranks of a coordinate run the same loss
(``parallel/tensor.py``). The loss reported, and the choice to apply or
skip an update, come from the sum over the batch axes, so every rank makes
the same choice.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB
from phantom_vlb_tpu_torch.train.metrics import PearsonState, pearson_update
from phantom_vlb_tpu_torch.train.optim import AdamWCosine
from phantom_vlb_tpu_torch.utils.profiling import span

__all__ = ["masked_mse", "vlb_forward", "loss_fn", "train_step", "eval_step"]


def masked_mse(pred: torch.Tensor, y: torch.Tensor, row_mask: torch.Tensor,
               n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The squared errors of the valid rows over ``n_valid`` (default: the
    batch's valid rows; at least 1) times the targets' width."""
    m = row_mask.to(pred.dtype)[:, None]
    if n_valid is None:
        n_valid = row_mask.to(pred.dtype).sum()
    return ((pred - y.to(pred.dtype)).square() * m).sum() / (n_valid.clamp_min(1.0) * y.shape[1])


def vlb_forward(model: VideoLLaMA2VLB, batch: Mapping[str, torch.Tensor], seed: int | None = None,
                rows: tuple[int, int] | None = None):
    """The VLB's forward on a batch dict -> (predictions, l2 penalty);
    ``rows`` as ``VideoLLaMA2VLB.forward`` takes them."""
    return model(batch["language"], batch["vision"], batch["padvals"],
                 batch["vis_weights"], batch["lang_weights"], seed=seed, rows=rows)


def _sharded(mesh: MeshEnv | None) -> bool:
    return mesh is not None and mesh.sharded


Forward = Callable[[torch.nn.Module, Mapping[str, torch.Tensor], "int | None"], tuple]


def loss_fn(model: torch.nn.Module, batch: Mapping[str, torch.Tensor], seed: int | None = None,
            forward: Forward = vlb_forward, mesh: MeshEnv | None = None):
    """Forward in the model's current mode -> (loss, mse, l2); under a
    sharded ``mesh``, this rank's part of each (see the module's note)."""
    if not _sharded(mesh):
        pred, l2_reg = forward(model, batch, seed)
        mse = masked_mse(pred, batch["timeseries"], batch["row_mask"])
        return mse + l2_reg, mse, l2_reg
    row_mask = batch["row_mask"]
    pred, l2_reg = forward(model, batch, seed, rows=mesh.rows(row_mask.shape[0]))
    n_valid = mesh.all_sum(row_mask.to(pred.dtype).sum())
    mse = masked_mse(pred, batch["timeseries"], row_mask, n_valid)
    return (mse + l2_reg if mesh.batch_rank == 0 else mse), mse, l2_reg


def train_step(
    model: torch.nn.Module,
    optimizer: AdamWCosine,
    batch: Mapping[str, torch.Tensor],
    seed: int,
    forward: Forward = vlb_forward,
    mesh: MeshEnv | None = None,
) -> dict[str, object]:
    """One update of ``optimizer.params`` on ``batch`` with dropout seed ``seed``.

    The model must be in train mode with ``requires_grad`` on exactly the
    trainable tensors. Returns {"brain_loss", "mse", "l2_reg", "grad_norm"}
    as tensors (the global batch's under a sharded ``mesh``), "finite" and,
    for an applied update, "lr". The gradients stay in ``.grad`` (clipped)
    until the next step.
    """
    optimizer.zero_grad()
    with span("forward"):
        loss, mse, l2_reg = loss_fn(model, batch, seed, forward, mesh)
    with span("backward"):
        loss.backward()
    with span("clip"):
        grad_norm = optimizer.clip_()
    loss, mse, l2_reg = loss.detach(), mse.detach(), l2_reg.detach()
    if _sharded(mesh):
        mse = mesh.all_sum(mse)
        loss = mse + l2_reg
    with span("finite_sync"):
        finite = bool(torch.isfinite(loss))
    out = {"brain_loss": loss, "mse": mse, "l2_reg": l2_reg, "grad_norm": grad_norm, "finite": finite}
    if finite:
        with span("update"):
            out["lr"] = optimizer.apply()
    return out


@torch.inference_mode()
def eval_step(
    model: torch.nn.Module,
    batch: Mapping[str, torch.Tensor],
    pearson: PearsonState,
    forward: Forward = vlb_forward,
    mesh: MeshEnv | None = None,
) -> tuple[PearsonState, dict[str, torch.Tensor]]:
    """One eval batch -> (updated Pearson state, {"brain_loss", "n", "pred"}).

    ``batch`` holds tensors on the model's device: language, vision (cached
    video tokens or raw frames), padvals, vis_weights, lang_weights,
    timeseries, row_mask. Under a sharded ``mesh``, "brain_loss" and "n"
    are the global batch's, and the Pearson state holds this rank's rows
    (``train/metrics.py`` merges the ranks' states).
    """
    pred, l2_reg = forward(model, batch, None)
    row_mask = batch["row_mask"]
    if not _sharded(mesh):
        loss = masked_mse(pred, batch["timeseries"], row_mask) + l2_reg
        n = row_mask.sum()
    else:
        n = mesh.all_sum(row_mask.to(pred.dtype).sum())
        loss = mesh.all_sum(masked_mse(pred, batch["timeseries"], row_mask, n)) + l2_reg
    pearson = pearson_update(pearson, pred, batch["timeseries"], row_mask)
    return pearson, {"brain_loss": loss, "n": n, "pred": pred}
