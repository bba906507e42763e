"""The training loop: epochs, the fractional validation cadence, checkpoints, logging.

Counterpart of ``TrainLoopConfig`` and ``VLBTrainer`` in
``phantom_vlb_tpu/train/loop.py`` (:40-307), the reference's orchestration:
``max_epochs`` epochs with a validation every ``max(1, int(n *
val_check_interval))`` batches inside an epoch and one at its end, a log
row every ``log_every_n_steps`` steps (``train/brain_loss``,
``train/steps_per_sec`` over the steps since the last row, and
``lr-AdamW``, the rate of the next update), best and last checkpoints on
``val/brain_loss``, the per-ROI Pearson in each validation's row, optional
early stopping whose state survives a resume, and an abort after
``nan_abort_after`` consecutive non-finite losses (raised at the first log
step that sees the streak; those steps leave the model and the optimizer as
they were). :meth:`VLBTrainer.maybe_resume` restarts from ``last`` and
:meth:`VLBTrainer.fit` then skips the epochs already done.

Each step's dropout seed is drawn from a CPU ``torch.Generator`` seeded
with ``seed`` when the trainer is made, so a resumed run restarts that
stream from ``seed``, as the reference's key does. :func:`train_batches` is
the bare step loop (no validation, no checkpoints).

Under a sharded ``mesh`` (``core/mesh.py``) the trainer shards the model
with FSDP2 (``parallel/sharding.py``) and each rank's loaders yield its
rows of each global batch. Every rank computes the same reduced loss,
validation loss and merged Pearson, so early stopping, the NaN-streak
abort and the best checkpoint are decided alike on all of them; rank 0
alone writes ``metrics.csv``, the console and Comet logs and the files,
from whole tensors gathered by every rank (the one-process layout, so a
checkpoint resumes at any world size).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.data.loader import batch_fields
from phantom_vlb_tpu_torch.models.videollama2 import (
    VideoLLaMA2VLB,
    trainable_parameters,
    trainable_predicate,
)
from phantom_vlb_tpu_torch.parallel.sharding import shard_like, shard_model, whole
from phantom_vlb_tpu_torch.train.checkpoint import CheckpointManager, export_adapters
from phantom_vlb_tpu_torch.train.metrics import (
    CSVMetricsLogger,
    NullMetricsLogger,
    pearson_all_merge,
    pearson_compute,
    pearson_init,
    roi_metric_names,
)
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig, learning_rate, local_part
from phantom_vlb_tpu_torch.train.step import Forward, eval_step, train_step, vlb_forward

__all__ = ["TrainLoopConfig", "VLBTrainer", "train_batches", "is_adapter"]


@dataclasses.dataclass
class TrainLoopConfig:
    max_epochs: int = 10
    val_check_interval: float = 0.2
    log_every_n_steps: int = 15
    seed: int = 1234
    output_dir: str = "./results"
    run_name: str = "vlb"
    num_target: int = 1000
    checkpoint: bool = True
    # Abort after this many consecutive non-finite losses (0 disables),
    # checked at log cadence; non-finite updates are never applied.
    nan_abort_after: int = 3
    # Early stopping on val/brain_loss (mode min): stop after this many
    # validations without an improvement of more than min_delta. Off (0)
    # by default, as the reference always runs its full max_epochs.
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0


def is_adapter(name: str) -> bool:
    """What the adapters export keeps: the head and the LoRA factors."""
    return name.startswith("head") or "lora_a" in name or "lora_b" in name


class VLBTrainer:
    """Drives (train_loader, val_loader) through the train and eval steps.

    ``model`` lives on ``device``; ``trainable(name)`` selects the tensors
    that train (``requires_grad`` is set on exactly those), and
    ``forward(model, batch, seed)`` gives (predictions, l2 penalty). A
    loader is anything with a length that yields batches: a
    :class:`~phantom_vlb_tpu_torch.data.loader.Batch` or a dict of arrays
    or tensors. Under a sharded ``mesh`` the model is sharded here (after
    ``requires_grad`` is set) and batches hold this rank's rows.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optim_config: OptimConfig,
        loop_config: TrainLoopConfig,
        *,
        trainable: Callable[[str], bool] = trainable_predicate,
        forward: Forward = vlb_forward,
        device: str | torch.device = "cuda",
        csv_logger: CSVMetricsLogger | None = None,
        extra_loggers: Iterable = (),
        mesh: MeshEnv | None = None,
    ):
        self.device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device != self.device:
            raise ValueError(f"model is on {param_device}, not {self.device}")
        self.config = loop_config
        self.model = model
        self.forward = forward
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        writer = self.mesh is None or self.mesh.is_writer
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        if self.mesh is not None:
            shard_model(model, self.mesh)
        self.trainable: dict[str, torch.nn.Parameter] = {
            name: p for name, p in model.named_parameters() if p.requires_grad}
        self.optimizer = AdamWCosine(self.trainable.values(), optim_config, self.mesh, names=self.trainable)
        if csv_logger is None:
            csv_logger = (CSVMetricsLogger(loop_config.output_dir, loop_config.run_name) if writer
                          else NullMetricsLogger())
        self.csv_logger = csv_logger
        self.extra_loggers = list(extra_loggers) if writer else []
        self.ckpt = CheckpointManager(loop_config.output_dir, writer) if loop_config.checkpoint else None
        self._seeds = torch.Generator().manual_seed(loop_config.seed)
        self._nan_streak = 0
        self.global_step = 0
        self.epoch = 0
        self.last_val_metrics: dict[str, float] = {}
        self._es_best = float("inf")
        self._es_strikes = 0
        self.stopped_early = False

    # ------------------------------------------------------------------
    def _put(self, batch) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch_fields(batch).items()}

    def _log(self, metrics: Mapping[str, float]) -> None:
        self.csv_logger.log_metrics(metrics, self.global_step, self.epoch)
        for logger in self.extra_loggers:
            logger.log_metrics(metrics, self.global_step, self.epoch)

    def state(self) -> dict:
        """What a checkpoint holds: the applied-update count, the trainable
        tensors by name and the optimizer's state, whole (under a mesh,
        gathered on every rank: a collective)."""
        return {"step": self.optimizer.step,
                "params": {name: whole(p.detach(), p) for name, p in self.trainable.items()},
                "optimizer": self.optimizer.state_dict()}

    def load_params(self, params: Mapping[str, torch.Tensor], source: str = "the tensors given") -> None:
        """Copy ``params`` (a checkpoint's whole ``params``) into the
        trainable tensors, each rank its shard; raises when a name is
        missing or stray."""
        if set(params) != set(self.trainable):
            raise ValueError(f"{source} holds other tensors than the trainable ones: "
                             f"{sorted(set(params) ^ set(self.trainable))[:8]}")
        with torch.no_grad():
            for key, t in params.items():
                p = self.trainable[key]
                local_part(p).copy_(local_part(shard_like(t, p)))

    # ------------------------------------------------------------------
    def maybe_resume(self, name: str = "last") -> bool:
        """Resume from checkpoint ``name`` if present: the trainable
        tensors, the optimizer's state, the step, and the host-side trainer
        state (early-stop window, best metric and path)."""
        if self.ckpt is None or not (self.ckpt.directory / name).exists():
            return False
        # Read onto the trainer's device, not the host (whose memory every
        # rank of a node shares); AdamWCosine moves the step counts to the
        # host, where AdamW keeps them.
        state = self.ckpt.restore(name, self.device)
        self.load_params(state["params"], f"checkpoint {name!r}")
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["step"])
        meta = self.ckpt.load_metadata()
        self._es_best = float(meta.get("es_best", self._es_best))
        self._es_strikes = int(meta.get("es_strikes", self._es_strikes))
        self.ckpt.best_metric = float(meta.get("best_metric", self.ckpt.best_metric))
        best_path = meta.get("best_path")
        if best_path and Path(best_path).exists():
            self.ckpt.best_path = Path(best_path)
        return True

    # ------------------------------------------------------------------
    def validate(self, val_loader) -> dict[str, float]:
        self.model.eval()
        pearson = pearson_init(self.config.num_target, device=self.device)
        total_loss, total_n = 0.0, 0.0
        for batch in val_loader:
            pearson, out = eval_step(self.model, self._put(batch), pearson, self.forward, self.mesh)
            n = float(out["n"])
            total_loss += float(out["brain_loss"]) * n
            total_n += n
        self.model.train()
        corr = pearson_compute(pearson_all_merge(pearson, self.mesh)).cpu().numpy()
        val_loss = total_loss / max(total_n, 1.0)

        row: dict[str, float] = {"val/brain_loss": val_loss}
        for name, value in zip(roi_metric_names(self.config.num_target), corr):
            row[name] = float(value)
        row["val_corr_avg"] = float(np.nanmean(corr))
        self._log(row)
        self.last_val_metrics = row
        if self.ckpt is not None:
            self.ckpt.save_on_validation(self.state(), val_loss, self.epoch, self.global_step)
        self._early_stop_update(val_loss)
        if self.ckpt is not None:
            self.ckpt.save_metadata({
                "es_best": self._es_best,
                "es_strikes": self._es_strikes,
                "best_metric": self.ckpt.best_metric,
                "best_path": str(self.ckpt.best_path or ""),
                "epoch": self.epoch,
                "global_step": self.global_step,
            })
        return row

    def _early_stop_update(self, val_loss: float) -> None:
        if not self.config.early_stop_patience:
            return
        if val_loss < self._es_best - self.config.early_stop_min_delta:
            self._es_best = val_loss
            self._es_strikes = 0
        else:
            self._es_strikes += 1
            if self._es_strikes >= self.config.early_stop_patience:
                self.stopped_early = True

    def train_one(self, batch) -> dict[str, object]:
        """One step on ``batch`` with the next dropout seed; counts the
        streak of non-finite losses."""
        seed = int(torch.randint(0, 2**32, (), generator=self._seeds))
        out = train_step(self.model, self.optimizer, self._put(batch), seed, self.forward, self.mesh)
        self._nan_streak = 0 if out["finite"] else self._nan_streak + 1
        return out

    def fit(self, train_loader, val_loader) -> dict[str, float]:
        cfg = self.config
        # After maybe_resume(), completed epochs are skipped.
        start_epoch = 0
        if self.global_step and len(train_loader):
            start_epoch = min(self.global_step // max(1, len(train_loader)), cfg.max_epochs)
        self.model.train()
        for self.epoch in range(start_epoch, cfg.max_epochs):
            n_batches = len(train_loader)
            val_every = (max(1, int(n_batches * cfg.val_check_interval))
                         if cfg.val_check_interval else 0)
            window_t0, window_steps = time.perf_counter(), 0
            for i, batch in enumerate(train_loader):
                out = self.train_one(batch)
                self.global_step += 1
                window_steps += 1
                if self.global_step % cfg.log_every_n_steps == 0:
                    loss = float(out["brain_loss"])
                    now = time.perf_counter()
                    sps = window_steps / max(now - window_t0, 1e-9)
                    window_t0, window_steps = now, 0
                    self._log({
                        "train/brain_loss": loss,
                        "train/steps_per_sec": sps,
                        # The rate of the next update, named as Lightning's
                        # LearningRateMonitor names it.
                        "lr-AdamW": learning_rate(self.optimizer.config, self.global_step),
                    })
                    if cfg.nan_abort_after and self._nan_streak >= cfg.nan_abort_after:
                        raise FloatingPointError(
                            f"train/brain_loss non-finite for {self._nan_streak} consecutive "
                            f"steps at step {self.global_step}; aborting (model state was not "
                            "updated by the non-finite steps; last good checkpoint: "
                            f"{self.ckpt.best_path if self.ckpt else None})")
                if val_every and (i + 1) % val_every == 0 and (i + 1) < n_batches:
                    self.validate(val_loader)
                    if self.stopped_early:
                        break
            if not self.stopped_early:
                self.validate(val_loader)
            if self.stopped_early:
                self._log({"early_stopped_epoch": float(self.epoch)})
                break
        if self.ckpt is not None:
            self.ckpt.save_last(self.state())
            adapters = {k: whole(p.detach(), p) for k, p in self.model.named_parameters() if is_adapter(k)}
            if adapters and self.ckpt.writer:       # none: a model other than the VLB
                export_adapters(adapters, Path(self.config.output_dir) / "adapters", is_adapter)
        return self.last_val_metrics


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
