#!/usr/bin/env python3
"""Teacher-student LoRA recovery through the bf16, w8a8 and w8a8g8 bases, on the card.

The counterpart of ``scripts/quant_quality_run.py`` for
``phantom_vlb_tpu_torch``, at production geometry (32 layers, 4096/14336,
seq 2048, 1183 video tokens from 12 frames of 336 px): a teacher (a frozen
base with nonzero adapters and the head at its init) makes BOLD-like
targets from synthetic frames and text; students with ``base_quant`` in
{None (bf16), w8a8, w8a8g8} train their adapters and head to recover them
through the frozen base. The val Pearson r (the streaming per-ROI r,
averaged) is reported per config: equal curves mean the int8 bases train
at bf16 quality.

What is kept from the JAX script, so its curves compare as a trend:

- the batches: ``example_batch`` reseeds ``default_rng(0)`` at every call,
  so every batch shares its text, HRF weights and the frames' base draw;
  only ``+ 0.3 N(0, 1)`` on the frames differs, drawn from the script's own
  ``default_rng(0)``, which then draws the targets' noise (byte for byte
  the JAX script's batches);
- the model: the tower and the decoder take the same ``base_quant``, the
  STC stays bf16 (``mm_projector`` is never quantized), no adapter or head
  dropout, the backbone not frozen; the head and the adapters train;
- the teacher: each ``lora_b`` is ``N(0, 1) * 0.5 / L``, where L is the
  decoder's depth: the JAX leaf is stacked (L, r, out) under
  ``scan_layers`` and the script scales by its first axis; the targets are
  its predictions z-scored over the batch (``+1e-6`` on the std) plus
  ``0.3 N(0, 1)``. ``--teacher auto`` is bf16 whenever bf16 is a config;
  the teacher and a student never hold the card together;
- the students: each rebuilt from the teacher's seed (its bf16 base
  bitwise the teacher's, ``lora_a`` the teacher's, ``lora_b`` zero), the
  int8 ones quantized on the card per output channel (``quantize_base``);
  AdamW on the cosine schedule at ``--lr``, the batch of step ``it`` being
  ``batches[it % n_train]``, a validation at every ``--eval-every`` steps
  and at the last.

The weights are drawn on the device from a seeded generator (the teacher's
adapters from another), so the values, and the curves, are not the JAX
script's: compare them as a trend. One JSON line per config, with the JAX
script's keys (``config``, ``geometry``, ``curve`` of ``step`` and
``val_pearson_avg``); progress and times go to stderr. It runs on the card
and raises without one, unless ``--device cpu`` is given; ``--preset
narrow`` is the tiny geometry (56 px frames, 64-token sequences, narrow
tower, connector and decoder, f32) that the CPU tests run.

    python scripts/quant_quality_run_torch.py [--steps 150] [--configs bf16,w8a8g8]
    python scripts/quant_quality_run_torch.py --preset narrow --layers 2 --batch 3 --steps 3 \\
        --eval-every 1 --n-train 2 --n-val 1 --device cpu
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
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
from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig, VideoLLaMA2VLB, trainable_parameters  # noqa: E402
from phantom_vlb_tpu_torch.ops.quant import quantize_state_dict  # noqa: E402
from phantom_vlb_tpu_torch.train.metrics import pearson_compute, pearson_init  # noqa: E402
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig  # noqa: E402
from phantom_vlb_tpu_torch.train.step import eval_step, train_step  # noqa: E402

PRESETS = ("full", "narrow")
WEIGHTS_SEED = 0          # the base, lora_a and the head: the teacher's and every student's
ADAPTER_SEED = 7          # the teacher's lora_b (the JAX script's default_rng(7))
DATA_SEED = 0             # the frames' noise, then the targets' noise
FRAME_NOISE = TARGET_NOISE = 0.3
TEACHER_LORA_B = 0.5      # over the decoder's depth
ZSCORE_EPS = 1e-6


def log(msg: str) -> None:
    print(f"[quantq-torch {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--n-train", type=int, default=8, help="train batches")
    ap.add_argument("--n-val", type=int, default=2)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--configs", default="bf16,w8a8,w8a8g8")
    ap.add_argument("--teacher", default="auto", help="teacher base quant: auto|bf16|w8a8|w8a8g8")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--preset", choices=PRESETS, default="full",
                    help="full: the production geometry in bf16; narrow: the tiny geometry in f32")
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def quant_of(name: str) -> str | None:
    return None if name == "bf16" else name


def build_cfg(quant: str | None, layers: int, preset: str = "full") -> VLBConfig:
    """The JAX script's ``build_cfg``: the tower and the decoder on
    ``quant``, the STC bf16, adapters and head without dropout, the
    backbone not frozen (``narrow``: the tiny configs, f32, rank-4
    adapters)."""
    if preset == "narrow":
        mistral = MistralConfig.tiny(vocab_size=1000, num_hidden_layers=layers, base_quant=quant,
                                     lora=LoRAConfig(rank=4, alpha=8.0, dropout=0.0))
        return VLBConfig.tiny(use_lora=True, base_quant=quant, mistral=mistral, dropout_rate=0.0)
    cfg = VLBConfig(clip=CLIPVisionConfig(base_quant=quant), stc=STCConfig(),
                    mistral=MistralConfig(num_hidden_layers=layers, lora=LoRAConfig(dropout=0.0),
                                          base_quant=quant),
                    freeze_backbone=False, dropout_rate=0.0)
    cfg.validate()
    return cfg


def teacher_quant(configs: list[str], teacher: str = "auto") -> str | None:
    """bf16 (None) whenever it is among ``configs`` under ``auto``; else
    the first config's quantization, as the JAX script picks."""
    if teacher != "auto":
        return quant_of(teacher)
    return None if "bf16" in configs else quant_of(configs[0])


def example_batch(geom, batch_size: int, vocab: int) -> dict[str, np.ndarray]:
    """``__graft_entry__._example_batch`` in numpy: a fresh
    ``default_rng(0)`` at every call, so every call gives the same arrays."""
    rng = np.random.default_rng(0)
    rows = [synth_language_row(geom, rng, tr_time=(i + 1) * geom.tr, vocab_size=vocab)
            for i in range(batch_size)]
    vision = rng.standard_normal(
        (batch_size, geom.num_frames, 3, geom.image_size, geom.image_size)).astype(np.float32)
    vis_w = rng.uniform(0, 0.3, (batch_size, geom.num_ds_frames)).astype(np.float32)
    lang_w = rng.uniform(0, 0.3, (batch_size, geom.onsets_width)).astype(np.float32)
    return {
        "language": np.stack([r[0] for r in rows]).astype(np.int32),
        "vision": vision,
        "padvals": np.stack([r[2] for r in rows]).astype(np.int32),
        "vis_weights": vis_w,
        "lang_weights": lang_w,
        "timeseries": rng.standard_normal((batch_size, geom.num_parcels)).astype(np.float32),
        "row_mask": np.ones((batch_size,), np.float32),
    }


def make_batches(cfg: VLBConfig, n: int, batch_size: int, rng: np.random.Generator,
                 device: torch.device) -> list[dict]:
    """``n`` batches: the example batch with ``0.3 N(0, 1)`` from ``rng``
    added to its frames, which go to ``device`` one batch at a time (97.5
    MB a batch at full width); the rest stays numpy until the step."""
    base = example_batch(cfg.geometry, batch_size, cfg.mistral.vocab_size)
    batches = []
    for _ in range(n):
        frames = base["vision"] + rng.standard_normal(base["vision"].shape).astype(np.float32) * FRAME_NOISE
        batches.append({**base, "vision": torch.from_numpy(frames).to(device)})
        del frames
    return batches


def base_state(cfg: VLBConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """The bf16 config ``cfg``'s state dict, which every model of the run
    starts from, made on ``device`` from WEIGHTS_SEED."""
    return init_params(cfg, device, torch.Generator(device=device).manual_seed(WEIGHTS_SEED))


def quantize_base(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The JAX script's ``q8_dev`` over its targets, in place on the
    weights' device: the decoder's 7 projections and the tower's q, k, v,
    out_proj, fc1 and fc2 to int8 codes with an f32 scale per output
    channel (a zero channel scaled by 1); ``mm_projector`` untouched."""
    return quantize_state_dict(sd)


def teacher_adapters(sd: dict[str, torch.Tensor], layers: int, draw) -> dict[str, torch.Tensor]:
    """Every ``lora_b`` set to ``draw(key, shape) * 0.5 / layers`` in f32:
    the JAX script's ``perturb`` scales by the stacked leaf's first axis,
    (L, r, out) under ``scan_layers``, so by the depth, not the rank."""
    scale = TEACHER_LORA_B / max(1, layers)
    for key in [k for k in sd if k.endswith(".lora_b")]:
        sd[key] = draw(key, tuple(sd[key].shape)).float() * scale
    return sd


def generator_draw(device: torch.device, seed: int = ADAPTER_SEED):
    """``draw(key, shape)``: standard normals from one generator on
    ``device``, in the order of the calls."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda key, shape: torch.randn(shape, generator=gen, device=device)


def set_teacher_targets(model: VideoLLaMA2VLB, batches: list[dict], rng: np.random.Generator) -> None:
    """Each batch's ``timeseries``: the teacher's deterministic predictions,
    z-scored over the batch axis, plus ``0.3 N(0, 1)`` from ``rng``."""
    model.eval()
    with torch.no_grad():
        for b in batches:
            dev = _on(b, next(model.parameters()).device)
            pred, _ = model(dev["language"], dev["vision"], dev["padvals"], dev["vis_weights"],
                            dev["lang_weights"])
            y = pred.float().cpu().numpy()
            y = (y - y.mean(0)) / (y.std(0) + ZSCORE_EPS)
            b["timeseries"] = y + rng.standard_normal(y.shape).astype(np.float32) * TARGET_NOISE


def _on(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def evaluate(model: VideoLLaMA2VLB, batches: list[dict]) -> float:
    """The deterministic forward over ``batches`` into the streaming
    per-ROI Pearson (a row mask of ones), then its NaN-mean."""
    device = next(model.parameters()).device
    model.eval()
    pearson = pearson_init(model.cfg.num_target, device=device)
    for b in batches:
        pearson, _ = eval_step(model, _on(b, device), pearson)
    model.train()
    return float(np.nanmean(pearson_compute(pearson).cpu().numpy()))


def train_student(model: VideoLLaMA2VLB, batches: list[dict], n_train: int, steps: int, eval_every: int,
                  lr: float) -> list[tuple[int, float]]:
    """``steps`` updates of the head and adapters; (step, val r) at every
    ``eval_every`` steps and at the last, over ``batches[n_train:]``."""
    device = next(model.parameters()).device
    optimizer = AdamWCosine(trainable_parameters(model), OptimConfig(lr=lr))
    model.train()
    curve, step_s = [], []
    for it in range(steps):
        t0 = time.perf_counter()
        # No dropout anywhere: the seed train mode asks for draws nothing.
        # train_step reads the loss's finiteness, so the step has ended.
        train_step(model, optimizer, _on(batches[it % n_train], device), seed=it)
        step_s.append(time.perf_counter() - t0)
        if (it + 1) % eval_every == 0 or it == steps - 1:
            curve.append((it + 1, evaluate(model, batches[n_train:])))
            log(f"step {it + 1}: val pearson {curve[-1][1]:.4f}; step ms first "
                f"{step_s[0] * 1e3:.1f}, median {np.median(step_s) * 1e3:.1f}")
    return curve


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(args: argparse.Namespace, draw=None, state=None) -> list[dict]:
    """The teacher's targets, then each config's student. Prints one JSON
    line per config as it ends (r rounded to 4 places, as the JAX script
    does) and returns the records with the curves as (step, r) pairs,
    unrounded. ``draw`` makes the teacher's ``lora_b``
    (default: ``generator_draw``); ``state(cfg, device)`` the bf16 state
    dict every model starts from (default: ``base_state``)."""
    device = resolve_device(args.device)
    configs = args.configs.split(",")
    state = state or base_state
    t_quant = teacher_quant(configs, args.teacher)
    cfg0 = build_cfg(None, args.layers, args.preset)
    # The frames' noise, then the targets': one stream, as in the JAX script.
    rng = np.random.default_rng(DATA_SEED)
    batches = make_batches(cfg0, args.n_train + args.n_val, args.batch, rng, device)

    log(f"teacher ({t_quant or 'bf16'}, {args.layers} layers) ...")
    sd = state(cfg0, device)
    if t_quant is not None:
        quantize_base(sd)
    teacher_adapters(sd, args.layers, draw or generator_draw(device))
    teacher = VideoLLaMA2VLB.from_state_dict(build_cfg(t_quant, args.layers, args.preset), sd)
    del sd
    set_teacher_targets(teacher, batches, rng)
    del teacher
    free(device)
    log("teacher targets done")

    g, hidden = cfg0.geometry, cfg0.mistral.hidden_size
    results = []
    for name in configs:
        quant = quant_of(name)
        t0 = time.perf_counter()
        sd = state(cfg0, device)
        if quant is not None:
            quantize_base(sd)
        model = VideoLLaMA2VLB.from_state_dict(build_cfg(quant, args.layers, args.preset), sd)
        del sd
        log(f"[{name}] training {args.steps} steps ...")
        curve = train_student(model, batches, args.n_train, args.steps, args.eval_every, args.lr)
        row = {"config": name, "geometry": f"{args.layers}L/{hidden}/seq{g.feature_len}/batch{args.batch}"}
        print(json.dumps({**row, "curve": [{"step": step, "val_pearson_avg": round(r, 4)} for step, r in curve]}),
              flush=True)
        results.append({**row, "curve": curve})
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")
        del model
        free(device)
    log(f"final: { {r['config']: round(r['curve'][-1][1], 4) for r in results} }")
    return results


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
