#!/usr/bin/env python3
"""The day-one real-weights runbook for the PyTorch port, on the CPU.

The counterpart of ``scripts/parity_real.py`` (stages 1-5) for
``phantom_vlb_tpu_torch``: the one command to run when the real
VideoLLaMA2-7B shards (and its tokenizer) are at hand.

  1. inventory   -- the key census of the shards under ``--ckpt``;
  2. strict load -- the port's ``load_pretrained_params`` over the shards
                    into the whole model's state dict (the STC key and
                    shape checks fire on a reconstruction that does not
                    hold); every key that was not read is reported and
                    fails the stage (``lm_head.weight`` excepted: the
                    regimes stop at the hidden states; and the tower's
                    layers past ``select_layer`` and ``post_layernorm``,
                    which the feature path never runs);
  3. mistral     -- the port's decoder against ``transformers.MistralModel``
                    from the same weights, in f32: each layer's hidden state
                    and the final norm, at positions 0.. and at the end of
                    the 2048-token window;
  4. clip        -- the port's tower against ``transformers.CLIPVisionModel``
                    (dimensions read from the shapes), its ``select_layer=-2``
                    patch features; skipped without tower keys;
  5. tokenizer   -- with ``--tokenizer``: the chat template rendered by
                    ``transformers``' ``apply_chat_template`` through the
                    port's ``data/hf_tokenizer.py``, the +2/+4 joiner counts
                    re-derived by the port's ``data/text.py``
                    (``validate_joiner_counts``), and a ``prep_text`` sample.

Errors are ``|a - b| / |b|`` over all elements (the JAX runbook's), within
``--tol`` (2e-3). Exit 0 when every stage that ran passed; 1 on any
failure. Without ``--ckpt``, or with one that holds no ``*.safetensors``,
it prints one line saying why it skips and exits 0. ``--tiny`` reads a
tiny fixture checkpoint (TEST_GEOMETRY, the tiny tower and connector)
instead of the production geometry. The real weights are not in the
repository; nothing is fetched.

    python scripts/parity_real_torch.py --ckpt /path/to/VideoLLaMA2-7B [--tokenizer DIR] [--layers 4]
    make parity-real-torch CKPT=/path/to/VideoLLaMA2-7B [TOK=DIR] [LAYERS=4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import full_width_parity_torch as fw  # noqa: E402
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY  # noqa: E402
from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.convert import HF_VISION_PREFIX, SafetensorsDir  # noqa: E402
from phantom_vlb_tpu_torch.models.mistral import MistralConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig  # noqa: E402
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, VLBConfig, stored_dtype  # noqa: E402
from phantom_vlb_tpu_torch.train.builder import load_pretrained_params  # noqa: E402


def log(msg: str) -> None:
    print(f"[parity-real-torch {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def mistral_config(ckpt: Path, layers: int | None) -> MistralConfig:
    """The decoder's dimensions from the checkpoint's ``config.json``
    (Mistral-7B's where it has none), in f32."""
    dims = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8, rope_theta=1e6, rms_norm_eps=1e-5)
    if (ckpt / "config.json").exists():
        raw = json.loads((ckpt / "config.json").read_text())
        dims.update({k: raw[k] for k in dims if k in raw})
    if layers:
        dims["num_hidden_layers"] = layers
    return MistralConfig(**dims, head_dim=dims["hidden_size"] // dims["num_attention_heads"],
                         dtype=torch.float32, remat=False)


def model_config(ckpt: Path, layers: int | None, tiny: bool) -> VLBConfig:
    m = mistral_config(ckpt, layers)
    if tiny:
        g = TEST_GEOMETRY
        clip = CLIPVisionConfig.tiny(image_size=g.image_size)
        stc = STCConfig.tiny(encoder_hidden_size=clip.hidden_size, hidden_size=96, output_hidden_size=m.hidden_size)
        return VLBConfig(clip=clip, stc=stc, mistral=m, geometry=g, num_target=g.num_parcels)
    return VLBConfig(clip=CLIPVisionConfig(dtype=torch.float32), stc=STCConfig(dtype=torch.float32), mistral=m)


def stage_inventory(sd) -> None:
    families: dict[str, int] = {}
    for k in sd:
        fam = ".".join(k.split(".")[:3])
        families[fam] = families.get(fam, 0) + 1
    log(f"inventory: {len(sd)} tensors")
    for fam, n in sorted(families.items()):
        log(f"  {fam}.* : {n}")


def stage_strict_load(ckpt: Path, sd: fw.Recorder, cfg: VLBConfig) -> list[str]:
    has_vision = any(k.startswith("model.vision_tower") for k in sd)
    if not has_vision:
        log("strict-load: no vision tower in the checkpoint: the language side only")
    # The decoder held in bf16 here: this stage checks keys and shapes, and
    # the f32 decoder is loaded again in stage 3.
    cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, dtype=torch.bfloat16))
    with torch.device("meta"):
        shapes = VideoLLaMA2VLB(cfg, vision=has_vision).state_dict()
    params = {k: torch.empty(v.shape, dtype=stored_dtype(k, cfg)) for k, v in shapes.items()}
    log(f"strict-load: the port's state dict at hidden {cfg.mistral.hidden_size}, "
        f"{cfg.mistral.num_hidden_layers} layers ({len(params)} tensors, host)...")
    try:
        load_pretrained_params(cfg, ckpt, params, sd=sd)
    except (ValueError, KeyError) as e:
        log(f"strict-load: FAIL {e}")
        return [f"strict-load: {e}"]
    log("strict-load: the port's loader and its key and shape checks PASS")
    unused = ("lm_head.",) + fw.clip_unused(cfg.clip) + tuple(
        f"model.layers.{i}." for i in range(cfg.mistral.num_hidden_layers, 10_000))
    unread = [k for k in sd.unread() if not k.startswith(unused)]
    if unread:
        log(f"strict-load: {len(unread)} keys not read (first 12): {unread[:12]}")
        return [f"unread keys: {len(unread)}"]
    log("strict-load: every checkpoint key read (lm_head and the unused tower layers excepted) PASS")
    return []


def stage_mistral(ckpt: Path, sd: fw.Recorder, model_cfg: VLBConfig, seq: int, tol: float) -> list[str]:
    cfg = model_cfg.mistral
    log(f"mistral: transformers MistralModel ({cfg.num_hidden_layers} layers, f32)...")
    hf = fw.hf_mistral(ckpt, cfg, lm_head=False)
    ids = np.random.default_rng(1).integers(3, min(32000, cfg.vocab_size), (1, seq)).astype(np.int64)
    regimes = {"pos0": np.arange(seq)[None], f"pos{fw.WINDOW - seq}": (fw.WINDOW - seq + np.arange(seq))[None]}
    want = {}
    with torch.no_grad():
        for tag, pos in regimes.items():
            o = hf(input_ids=torch.from_numpy(ids), position_ids=torch.from_numpy(pos.astype(np.int64)),
                   output_hidden_states=True)
            want[tag] = [h.numpy() for h in o.hidden_states]
    del hf
    model, _ = fw.load_port_decoder(ckpt, cfg, sd, model_cfg)
    failures = []
    for tag, pos in regimes.items():
        got = fw.decoder_states(model, ids, pos.astype(np.int64))
        for i, (g, w) in enumerate(zip(got, want[tag])):
            e = rel_err(g, w)
            name = "final norm" if i == cfg.num_hidden_layers else f"hidden[{i}]"
            if e >= tol or i == cfg.num_hidden_layers:
                log(f"mistral {tag}: {name} rel_err {e:.2e} {'PASS' if e < tol else 'FAIL'}")
            if e >= tol:
                failures.append(f"mistral {tag} {name} rel_err {e:.2e}")
    return failures


def stage_clip(ckpt: Path, sd: fw.Recorder, model_cfg: VLBConfig, tol: float, heads: int | None) -> list[str]:
    p = HF_VISION_PREFIX
    if not any(k.startswith(p) for k in sd):
        log("clip: SKIP (no vision tower keys)")
        return []
    hidden, _, patch, _ = sd.inner[p + "embeddings.patch_embedding.weight"].shape
    n_pos = sd.inner[p + "embeddings.position_embedding.weight"].shape[0]
    inter = sd.inner[p + "encoder.layers.0.mlp.fc1.weight"].shape[0]
    layers = 1 + max(int(k[len(p + "encoder.layers."):].split(".")[0]) for k in sd
                     if k.startswith(p + "encoder.layers."))
    image = int(round((n_pos - 1) ** 0.5)) * patch
    heads = heads or hidden // 64          # ViT-L/14's heads are 64 wide
    log(f"clip: hidden {hidden}, {layers} layers, patch {patch}, image {image}, heads {heads} (from the shapes)")
    cfg = CLIPVisionConfig(image_size=image, patch_size=patch, hidden_size=hidden, intermediate_size=inter,
                           num_hidden_layers=layers, num_attention_heads=heads, dtype=torch.float32)
    img = np.random.default_rng(2).standard_normal((1, 3, image, image)).astype(np.float32)
    want = fw.hf_clip_features(ckpt, cfg, img)
    tower, _ = fw.load_port_tower(ckpt, cfg, sd, dataclasses.replace(model_cfg, clip=cfg))
    with torch.no_grad():
        got = tower(torch.from_numpy(img)).numpy()
    e = rel_err(got, want)
    log(f"clip: select(-2) patch features rel_err {e:.2e} {'PASS' if e < tol else 'FAIL'}")
    return [f"clip rel_err {e:.2e}"] if e >= tol else []


def stage_tokenizer(tok_dir: str) -> list[str]:
    from transformers import AutoTokenizer

    from phantom_vlb_tpu_torch.data.hf_tokenizer import hf_chat_template
    from phantom_vlb_tpu_torch.data.text import prep_text, validate_joiner_counts

    tok = AutoTokenizer.from_pretrained(tok_dir, use_fast=True, local_files_only=True)
    if tok.pad_token is None:
        tok.pad_token = tok.unk_token
    template = hf_chat_template(tok)
    failures = []
    try:
        validate_joiner_counts(tok, template)
        log("tokenizer: joiner re-derivation (+2/+4 accounting) PASS")
    except Exception as e:                       # any mismatch is a finding of the run
        failures.append(f"joiner: {e}")
        log(f"tokenizer: joiner re-derivation FAIL {e}")
    log(f"tokenizer: template bytes: {template('sys', 'usr').encode()[:120]!r}")
    out = prep_text("previous scene words", "hello there world ", [["hello", "there", "world"]],
                    [[0.5, 0.9, 1.3]], tok, 2048)
    log(f"tokenizer: prep_text sample -> {len(out.input_ids)} ids, {len(out.token_onsets)} dialogue-token "
        f"onsets, inst_len {out.inst_len} PASS")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", help="VideoLLaMA2-7B safetensors directory")
    ap.add_argument("--tokenizer", help="the shipped tokenizer's directory (HF layout)")
    ap.add_argument("--layers", type=int, default=None, help="cut the decoder's depth for a first pass")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--tol", type=float, default=2e-3)
    ap.add_argument("--clip-heads", type=int, default=None, help="the tower's heads (default hidden // 64)")
    ap.add_argument("--tiny", action="store_true", help="a tiny fixture checkpoint (TEST_GEOMETRY)")
    ap.add_argument("--skip", default="", help="comma list of inventory,load,mistral,clip,tokenizer")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    if not args.ckpt:
        log("SKIP: no --ckpt given (the real VideoLLaMA2-7B weights are not in the repository)")
        return 0
    ckpt = Path(args.ckpt)
    if not list(ckpt.glob("*.safetensors")):
        log(f"SKIP: no *.safetensors under {ckpt} (the weights are absent)")
        return 0
    sd = fw.Recorder(SafetensorsDir(ckpt))
    cfg = model_config(ckpt, args.layers, args.tiny)
    failures: list[str] = []
    if "inventory" not in skip:
        stage_inventory(sd)
    if "load" not in skip:
        failures += stage_strict_load(ckpt, sd, cfg)
    if "mistral" not in skip:
        failures += stage_mistral(ckpt, sd, cfg, args.seq, args.tol)
    if "clip" not in skip:
        failures += stage_clip(ckpt, sd, cfg, args.tol, args.clip_heads)
    if args.tokenizer and "tokenizer" not in skip:
        failures += stage_tokenizer(args.tokenizer)
    elif not args.tokenizer:
        log("no --tokenizer given: SKIP the tokenizer byte checks")
    sd.inner.close()
    if failures:
        log(f"PARITY-REAL-TORCH FAILED: {failures}")
        return 1
    log("PARITY-REAL-TORCH OK (every stage that ran passed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
