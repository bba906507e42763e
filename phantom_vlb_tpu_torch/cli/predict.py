"""vlb-predict-torch: a trained model over a split, its predictions exported.

Counterpart of ``phantom_vlb_tpu/cli/predict.py`` (:24-92)::

    vlb-predict-torch experiment=vlb_friends_lora subject=sub-01 \
        predict.checkpoint=results/.../last predict.out=preds_sub-01.h5 [--device cpu]

The config is composed as for ``vlb-train-torch``; the model is built as
the trainer builds it and the trainable tensors of ``predict.checkpoint``
(a checkpoint directory's ``state.pt``) are loaded into it, every name
checked. :func:`predict_split` sweeps ``predict.split`` (``val`` by
default) with :func:`predict_batches`: the frozen forward, the masked loss
and the streaming Pearson merge, keeping the valid rows of each fixed-shape
batch. :func:`write_predictions` writes ``predicted``, ``actual`` and
``val_corr_roi`` (f32) to ``predict.out`` through h5py.

The frozen backbone is rebuilt from ``random_state`` (and
``model.checkpoint_path``) as in training, with a generator on the device:
random weights made on the card are not those made on the CPU, so predict
on the device kind that trained. It runs on the card (``--device cuda``,
the default) and raises when there is none.

:func:`synthetic_batches` makes seeded inputs of the serving shapes, with
cached video tokens or raw frames.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Iterable, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.cli.train import DEFAULT_CONFIG_PATH
from phantom_vlb_tpu_torch.core.config import Config, load_config
from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.data.loader import batch_fields
from phantom_vlb_tpu_torch.data.schemas import import_h5py
from phantom_vlb_tpu_torch.data.synthetic import synth_language_row
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, VLBConfig
from phantom_vlb_tpu_torch.train.builder import build_trainer
from phantom_vlb_tpu_torch.train.checkpoint import CheckpointManager
from phantom_vlb_tpu_torch.train.metrics import pearson_compute, pearson_init
from phantom_vlb_tpu_torch.train.step import eval_step

__all__ = ["predict_batches", "predict_split", "write_predictions", "run_predict", "main",
           "synthetic_batches"]


def predict_batches(
    model: VideoLLaMA2VLB,
    batches: Iterable[Mapping[str, object]],
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Run ``model`` over ``batches`` (dicts or loader batches of numpy arrays
    or tensors, moved to ``device``).

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
        dev = {k: torch.as_tensor(v).to(device) for k, v in batch_fields(batch).items()}
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


def predict_split(config: Config, device: str | torch.device = "cuda", loaders=None) -> dict:
    """The model of ``config`` with ``predict.checkpoint``'s trainable
    tensors, over ``predict.split``: :func:`predict_batches`' result.
    ``loaders``: an optional (train, val) pair, as ``build_trainer`` takes."""
    device = resolve_device(device)
    trainer, train_loader, val_loader = build_trainer(config, device, loaders)
    pcfg = config.get("predict", Config())
    ckpt = pcfg.get("checkpoint")
    if ckpt:
        trainer.load_params(CheckpointManager.restore_path(ckpt, "cpu")["params"],
                            f"checkpoint {ckpt}")
    loader = val_loader if pcfg.get("split", "val") == "val" else train_loader
    return predict_batches(trainer.model.eval(), loader, device)


def write_predictions(result: Mapping[str, np.ndarray], path: str | Path) -> None:
    """``predicted``, ``actual`` and ``val_corr_roi`` as f32 datasets of an
    HDF5 file at ``path``."""
    h5py = import_h5py("writing predictions")
    with h5py.File(path, "w") as f:
        for key in ("predicted", "actual", "val_corr_roi"):
            f.create_dataset(key, data=np.asarray(result[key], np.float32))


def run_predict(config: Config, device: str | torch.device = "cuda") -> dict:
    """:func:`predict_split`, written to ``predict.out`` -> {out,
    n_samples, corr_avg}."""
    result = predict_split(config, device)
    out_path = str(config.get("predict", Config()).get("out", "predictions.h5"))
    write_predictions(result, out_path)
    return {"out": out_path, "n_samples": int(result["predicted"].shape[0]),
            "corr_avg": float(np.nanmean(result["val_corr_roi"]))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-path", default=str(DEFAULT_CONFIG_PATH))
    parser.add_argument("--config-name", default="base")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    config = load_config(args.config_path, args.config_name, args.overrides)
    result = run_predict(config, args.device)
    print(f"wrote {result['out']}: {result['n_samples']} samples, "
          f"corr_avg={result['corr_avg']:.4f}")
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
