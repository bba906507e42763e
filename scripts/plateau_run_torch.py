#!/usr/bin/env python3
"""Planted-HRF plateau runs through the port's trainer of record, on the card.

The counterpart of ``scripts/plateau_run.py`` for ``phantom_vlb_tpu_torch``.
The target is defined by the stimulus as the frozen vision path sees it,
never by a trained parameter: per clip

    z[b] = sum_f vis_w[b, f] * mean_t tok[b, f, t] @ R     (K latent dims)
    y[b] = zscore(z[b] @ P) + sigma * eps                  (num_parcels ROIs)

where tok are the bf16 CLIP + STC video tokens of ds-frame f, so the known
noise ceiling is r_max = 1 / sqrt(1 + sigma^2). ``--plant self`` plants
the code in each config's own frozen pooled rep instead (the head's input:
LN of the HRF-mask pooled hidden states at init, LoRA being zero there),
which gives every config the same ceiling. ``--probe`` solves a host ridge
from the pooled reps at alpha 1, 1e2, 1e4 and prints the best linear val r
instead of training.

Each config trains the recipe of record through ``VLBTrainer``: epochs,
a validation at each epoch's end, early stopping on ``val/brain_loss``,
the streaming per-ROI Pearson, the head and the adapters trainable (the
adapters' dropout 0.1 with 8-bit thresholds, unfused, as the JAX script's
``LoRAConfig(dropout=0.1, dropout_bits=8)``), AdamW on the cosine
schedule at ``--lr``, from cached video tokens: the tower and the STC
(bf16 in every config) encode every batch once, on the card, and are
freed; each config's model holds no towers.

What is kept from the JAX script: the host data (the language rows,
padvals and HRF weights from ``default_rng(0)``; clip i's pixels from
``default_rng(10_000 + i)``, made when its batch is encoded), the planted
code (``default_rng(42)`` gives R, then P, then under ``self`` one R a
config in config order; the noise from the data stream under ``token``,
from a fresh ``default_rng(7)`` a config under ``self``; z-scores with
``+1e-9`` and LN with eps 1e-6), the probe's arithmetic (float64 solve) and
the records. The weights are drawn on the device from a seeded generator
and the dropout masks from the port's own, so the curves compare with the
JAX runs as a trend only. One JSON line per config (``config``,
``layers``, ``noise_ceiling_r``, ``final_val_corr_avg``, ``stopped_early``,
``stop_step``, ``walltime_s``, ``curve`` of (step, val_corr_avg,
val/brain_loss) read back from the run's ``metrics.csv`` under
``{out}_{config}_{layers}L/plateau/version_k``); with ``--probe``, one
``probe_alpha`` / ``probe_val_r`` line per alpha. It runs on the card and
raises without one, unless ``--device cpu`` is given; ``--preset narrow``
is the tiny geometry (narrow tower, connector and decoder, f32) that the
CPU tests run.

    python scripts/plateau_run_torch.py --plant self --layers 16 --configs bf16,w8a8g8 --patience 8 --max-epochs 60
    python scripts/plateau_run_torch.py --layers 32 --configs w8a8g8
"""

from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from phantom_vlb_tpu_torch.core.device import resolve_device  # noqa: E402
from phantom_vlb_tpu_torch.data.synthetic import synth_language_row  # noqa: E402
from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.convert import init_params  # noqa: E402
from phantom_vlb_tpu_torch.models.lora import LoRAConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.mistral import MistralConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.videollama2 import VISION_PREFIXES, VLBConfig, VideoLLaMA2VLB  # noqa: E402
from phantom_vlb_tpu_torch.ops.weight_mask import build_weight_mask  # noqa: E402
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer  # noqa: E402
from phantom_vlb_tpu_torch.train.metrics import CSVMetricsLogger  # noqa: E402
from phantom_vlb_tpu_torch.train.optim import OptimConfig  # noqa: E402

PRESETS = ("full", "narrow")
WEIGHTS_SEED = 0           # every model's weights, drawn on the device
DATA_SEED = 0              # language rows, padvals, HRF weights, then the token plant's noise
PIXEL_SEED = 10_000        # clip i's pixels: default_rng(PIXEL_SEED + i)
PLANT_SEED = 42            # R, P, then one R a config under --plant self
SELF_NOISE_SEED = 7        # the self plant's noise, afresh for each config
PROBE_ALPHAS = (1e0, 1e2, 1e4)
ZS_EPS, LN_EPS = 1e-9, 1e-6


def log(msg: str) -> None:
    print(f"[plateau-torch {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--train-batches", type=int, default=16)
    ap.add_argument("--val-batches", type=int, default=3)
    ap.add_argument("--max-epochs", type=int, default=20)
    ap.add_argument("--patience", type=int, default=3, help="early-stop patience in validations (0 = off)")
    ap.add_argument("--min-delta", type=float, default=1e-4)
    ap.add_argument("--noise", type=float, default=0.3, help="target noise sigma (ceiling r = 1/sqrt(1+s^2))")
    ap.add_argument("--latent", type=int, default=32, help="planted latent dims")
    ap.add_argument("--configs", default="bf16,w8a8g8")
    ap.add_argument("--lr", type=float, default=1e-4, help="recipe-of-record lr (train/optim.py OptimConfig)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "plateau"),
                    help="run directories' prefix (default: plateau under the temporary directory)")
    ap.add_argument("--plant", choices=("token", "self"), default="token",
                    help="token: the code through the shared bf16 video tokens; self: the code in each "
                         "config's own frozen pooled rep (the same ceiling for every config)")
    ap.add_argument("--probe", action="store_true", help="closed-form ridge achievability probe only")
    ap.add_argument("--preset", choices=PRESETS, default="full",
                    help="full: the production geometry in bf16; narrow: the tiny geometry in f32")
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def quant_of(name: str) -> str | None:
    return None if name == "bf16" else name


def build_cfg(quant: str | None, layers: int, preset: str = "full") -> VLBConfig:
    """The JAX script's ``build_cfg``: the tower and the STC bf16 in every
    config, the decoder on ``quant`` with the adapters' dropout 0.1 on 8-bit
    thresholds, the backbone not frozen (``narrow``: the tiny configs, f32,
    rank-4 adapters)."""
    if preset == "narrow":
        mistral = MistralConfig.tiny(vocab_size=1000, num_hidden_layers=layers, base_quant=quant,
                                     lora=LoRAConfig(rank=4, alpha=8.0, dropout=0.1, dropout_bits=8))
        return VLBConfig.tiny(use_lora=True, mistral=mistral)
    cfg = VLBConfig(clip=CLIPVisionConfig(), stc=STCConfig(),
                    mistral=MistralConfig(num_hidden_layers=layers, base_quant=quant,
                                          lora=LoRAConfig(dropout=0.1, dropout_bits=8)),
                    freeze_backbone=False)
    cfg.validate()
    return cfg


def base_state(cfg: VLBConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """``cfg``'s state dict made on ``device`` from WEIGHTS_SEED (a
    quantized config's int8 base is the bf16 draw, quantized)."""
    return init_params(cfg, device, torch.Generator(device=device).manual_seed(WEIGHTS_SEED))


@dataclasses.dataclass
class PlateauData:
    """What every config shares: the batches (video tokens on the device),
    the token means, the planted projection and the generators' states."""
    batches: list[dict]
    tok_mean: np.ndarray          # (N, num_ds_frames, E) f32
    y: np.ndarray                 # (N, num_parcels): the token plant's targets
    p_out: np.ndarray             # (K, num_parcels)
    prng: np.random.Generator     # after R and P: draws each config's R under --plant self
    ceiling: float


def host_rows(cfg: VLBConfig, n_clips: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """The language rows, padvals and HRF weights of ``n_clips`` clips, in
    the JAX script's draw order."""
    g = cfg.geometry
    lang, padvals, vis_w, lang_w = [], [], [], []
    for i in range(n_clips):
        ids, _onsets, maskvals = synth_language_row(g, rng, tr_time=(i % 40 + 1) * g.tr,
                                                    vocab_size=cfg.mistral.vocab_size)
        lang.append(ids)
        padvals.append(maskvals)
        vis_w.append(rng.uniform(0, 0.3, g.num_ds_frames))
        lang_w.append(rng.uniform(0, 0.3, g.onsets_width))
    return {"language": np.stack(lang).astype(np.int32), "padvals": np.stack(padvals).astype(np.int32),
            "vis_weights": np.stack(vis_w).astype(np.float32), "lang_weights": np.stack(lang_w).astype(np.float32)}


def clip_pixels(geom, i: int) -> np.ndarray:
    return np.random.default_rng(PIXEL_SEED + i).standard_normal(
        (geom.num_frames, 3, geom.image_size, geom.image_size)).astype(np.float32)


def encode_batches(model: VideoLLaMA2VLB, rows: dict[str, np.ndarray], n_batches: int, batch: int
                   ) -> tuple[list[dict], np.ndarray]:
    """Every batch's video tokens, once, through ``model.encode_video``:
    bf16, kept on the model's device; and each ds-frame's token mean (the
    JAX script's mean of bf16 tokens, which rounds it to bf16), as f32."""
    g = model.cfg.geometry
    device = next(model.parameters()).device
    batches, tok_means = [], []
    for bi in range(n_batches):
        s = bi * batch
        pixels = torch.from_numpy(np.stack([clip_pixels(g, s + j) for j in range(batch)])).to(device)
        tokens = model.encode_video(pixels).to(torch.bfloat16)
        del pixels
        means = tokens.reshape(batch, g.num_ds_frames, g.tokens_per_frame, -1).float().mean(2)
        tok_means.append(means.to(torch.bfloat16).float().cpu().numpy())
        batches.append({"language": rows["language"][s:s + batch], "vision": tokens,
                        "padvals": rows["padvals"][s:s + batch], "vis_weights": rows["vis_weights"][s:s + batch],
                        "lang_weights": rows["lang_weights"][s:s + batch],
                        "row_mask": np.ones((batch,), np.float32)})
    return batches, np.concatenate(tok_means)


def zs(a: np.ndarray) -> np.ndarray:
    return (a - a.mean(0)) / (a.std(0) + ZS_EPS)


def layer_norm(a: np.ndarray) -> np.ndarray:
    """LN over the last axis without scale or shift (the JAX script's ``_ln``)."""
    mu = a.mean(-1, keepdims=True)
    var = ((a - mu) ** 2).mean(-1, keepdims=True)
    return (a - mu) / np.sqrt(var + LN_EPS)


def prepare(args: argparse.Namespace, encoder_state) -> PlateauData:
    """The host data, the tokens (through a model on ``encoder_state``'s
    towers, freed after) and the token plant."""
    device = resolve_device(args.device)
    cfg = build_cfg(None, args.layers, args.preset)
    g, b = cfg.geometry, args.batch
    n_batches = args.train_batches + args.val_batches
    rng = np.random.default_rng(DATA_SEED)
    rows = host_rows(cfg, n_batches * b, rng)
    encoder = VideoLLaMA2VLB.from_state_dict(cfg, encoder_state(cfg, device))
    log(f"encoding vision tokens ({n_batches} batches, on {device}, bf16) ...")
    batches, tok_mean = encode_batches(encoder, rows, n_batches, b)
    del encoder
    free(device)

    prng = np.random.default_rng(PLANT_SEED)
    e_llm = tok_mean.shape[-1]
    r_tok = prng.standard_normal((e_llm, args.latent)).astype(np.float32) / np.sqrt(e_llm)
    p_out = prng.standard_normal((args.latent, g.num_parcels)).astype(np.float32) / np.sqrt(args.latent)
    z = np.einsum("nd,ndk->nk", rows["vis_weights"], tok_mean @ r_tok)
    y = zs(zs(z) @ p_out)
    y = y + args.noise * rng.standard_normal(y.shape).astype(np.float32)
    for bi, batch in enumerate(batches):
        batch["timeseries"] = y[bi * b:(bi + 1) * b]
    ceiling = 1.0 / np.sqrt(1.0 + args.noise ** 2)
    log(f"targets planted: {y.shape}, noise ceiling r = {ceiling:.3f}")
    return PlateauData(batches, tok_mean, y, p_out, prng, ceiling)


def pooled_reps(model: VideoLLaMA2VLB, batches: list[dict]) -> np.ndarray:
    """The head's exact input before its LayerNorm: the frozen backbone's
    f32 hidden states pooled by the HRF weight mask (``bse,bs->be``)."""
    device = next(model.parameters()).device
    g = model.cfg.geometry
    model.eval()
    reps = []
    with torch.no_grad():
        for bt in batches:
            dev = {k: torch.as_tensor(v).to(device) for k, v in bt.items()}
            hidden, _ = model.backbone(dev["language"], dev["vision"])
            mask = build_weight_mask(dev["padvals"], dev["vis_weights"], dev["lang_weights"], g)
            reps.append(torch.einsum("bse,bs->be", hidden.float(), mask).cpu().numpy())
    model.train()
    return np.concatenate(reps).astype(np.float32)


def self_plant(x0: np.ndarray, prng: np.random.Generator, p_out: np.ndarray, noise: float) -> np.ndarray:
    """The code planted in ``x0`` (a config's LN'd pooled reps): R from
    ``prng``, the noise from a fresh ``default_rng(7)``."""
    r_self = prng.standard_normal((x0.shape[-1], p_out.shape[0])).astype(np.float32) / np.sqrt(x0.shape[-1])
    y = zs(zs(x0 @ r_self) @ p_out)
    return y + noise * np.random.default_rng(SELF_NOISE_SEED).standard_normal(y.shape).astype(np.float32)


def probe(x: np.ndarray, y: np.ndarray, n_train: int) -> list[tuple[float, float]]:
    """(alpha, mean per-ROI val r) of a host ridge fit on the first
    ``n_train`` rows, solved in float64 (``XᵀX`` in f32 plus a float64
    identity), at each of PROBE_ALPHAS."""
    xt, xv, yt, yv = x[:n_train], x[n_train:], y[:n_train], y[n_train:]
    out = []
    for alpha in PROBE_ALPHAS:
        w = np.linalg.solve(xt.T @ xt + alpha * np.eye(x.shape[1], dtype=np.float64), xt.T @ yt)
        pv = xv @ w
        num = ((pv - pv.mean(0)) * (yv - yv.mean(0))).sum(0)
        den = (np.linalg.norm(pv - pv.mean(0), axis=0) * np.linalg.norm(yv - yv.mean(0), axis=0) + 1e-9)
        out.append((alpha, float(np.mean(num / den))))
    return out


def read_curve(path: Path) -> list[tuple[int, float, float]]:
    """(step, val_corr_avg, val/brain_loss) of each validation row of a
    ``metrics.csv``."""
    with open(path, newline="") as f:
        return [(int(row["step"]), float(row["val_corr_avg"]), float(row["val/brain_loss"]))
                for row in csv.DictReader(f) if row.get("val_corr_avg")]


def fit(model: VideoLLaMA2VLB, batches: list[dict], args: argparse.Namespace, name: str,
        ceiling: float) -> dict:
    """The trainer of record over ``batches`` (train, then val); the run's
    record, its curve unrounded."""
    out_dir = f"{args.out}_{name}_{args.layers}L"
    trainer = VLBTrainer(
        model, OptimConfig(lr=args.lr),
        TrainLoopConfig(max_epochs=args.max_epochs, val_check_interval=0.0,
                        log_every_n_steps=args.train_batches, output_dir=out_dir, run_name="plateau",
                        num_target=model.cfg.num_target, checkpoint=False,
                        early_stop_patience=args.patience, early_stop_min_delta=args.min_delta),
        device=next(model.parameters()).device, csv_logger=CSVMetricsLogger(out_dir, "plateau"))
    t0 = time.perf_counter()
    final = trainer.fit(batches[:args.train_batches], batches[args.train_batches:])
    walltime = time.perf_counter() - t0
    return {"config": name, "layers": args.layers, "noise_ceiling_r": float(ceiling),
            "final_val_corr_avg": float(final["val_corr_avg"]), "stopped_early": trainer.stopped_early,
            "stop_step": trainer.global_step, "walltime_s": walltime,
            "curve": read_curve(trainer.csv_logger.path)}


def rounded(rec: dict) -> dict:
    """The JAX script's record: r, loss and ceiling to 4 places, the wall
    time to 0.1 s."""
    return {**rec, "noise_ceiling_r": round(rec["noise_ceiling_r"], 4),
            "final_val_corr_avg": round(rec["final_val_corr_avg"], 4), "walltime_s": round(rec["walltime_s"], 1),
            "curve": [(step, round(r, 4), round(loss, 4)) for step, r, loss in rec["curve"]]}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(args: argparse.Namespace, data: PlateauData | None = None, state=None) -> list[dict]:
    """Each config's fit (or, with ``--probe``, its ridge probe) on
    ``data`` (default: :func:`prepare`'s); prints one JSON line per config,
    or per alpha, as the JAX script does, and returns the records
    unrounded. ``state(cfg, device)`` makes a config's state dict (default:
    ``base_state``); the towers' tensors are dropped from it. A ``data``
    may be run again: each run draws from a copy of its plant generator."""
    device = resolve_device(args.device)
    state = state or base_state
    data = data or prepare(args, state)
    prng = copy.deepcopy(data.prng)
    b, n_train = args.batch, args.train_batches * args.batch
    results = []
    for name in args.configs.split(","):
        cfg = build_cfg(quant_of(name), args.layers, args.preset)
        log(f"[{name}] init at {args.layers}L ...")
        sd = {k: v for k, v in state(cfg, device).items() if not k.startswith(VISION_PREFIXES)}
        model = VideoLLaMA2VLB.from_state_dict(cfg, sd)
        del sd
        batches, y = data.batches, data.y
        x0 = None
        if args.plant == "self":
            # LoRA starts at zero, so the rep at init is the frozen rep.
            x0 = layer_norm(pooled_reps(model, batches))
            y = self_plant(x0, prng, data.p_out, args.noise)
            batches = [{**bt, "timeseries": y[bi * b:(bi + 1) * b]} for bi, bt in enumerate(batches)]
            log(f"[{name}] self-plant targets built (ceiling r = {data.ceiling:.3f} by construction)")
        if args.probe:
            x = x0 if x0 is not None else layer_norm(pooled_reps(model, batches))
            for alpha, r in probe(x, y, n_train):
                rec = {"config": name, "probe_alpha": alpha, "probe_val_r": r}
                print(json.dumps({**rec, "probe_val_r": round(r, 4)}), flush=True)
                results.append(rec)
        else:
            rec = fit(model, batches, args, name, data.ceiling)
            print(json.dumps(rounded(rec)), flush=True)
            results.append(rec)
        del model
        free(device)
    return results


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
