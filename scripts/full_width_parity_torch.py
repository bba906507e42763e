#!/usr/bin/env python3
"""Full-width parity of the PyTorch port against independent oracles, on the CPU.

The counterpart of ``scripts/full_width_parity.py`` for
``phantom_vlb_tpu_torch``: random checkpoints in the HF / VideoLLaMA2 key
layout are written at the production widths (with the port's own
safetensors writer), the port reads them through its own path
(``SafetensorsDir``, then ``load_pretrained_params``, every key that was
not read reported) and runs each component in f32 against its oracle:

- ``--component mistral`` (default): the decoder at hidden 4096, MLP 14336,
  GQA 32:8, head dim 128, rope theta 1e6, ``--layers`` deep, against
  ``transformers.MistralForCausalLM``: the hidden state after each layer
  (HF's convention: the embeddings first, the last one after the final
  norm) and the logits, at positions 0.. and at 2048 - seq.. (the end of
  the production window, where theta 1e6 matters);
- ``--component clip``: CLIP ViT-L/14-336 (1024 wide, 24 layers, 577
  tokens) under VideoLLaMA2's prefix against ``transformers.CLIPVisionModel``:
  the ``select_layer=-2`` patch features (2, 576, 1024);
- ``--component stc``: the STC connector at 1024 -> 4096, depth 4, against
  the HF-authored oracle of ``tests/test_stc_hf_oracle.py`` (loaded from
  that file as ``scripts/full_width_parity.py`` loads it): its remapped
  keys must be the port's ``_stc_expected_keys``, then the (1, 1183, 4096)
  tokens of a 12 x 24 x 24 x 1024 patch grid.

The error is the JAX script's: max |port - oracle| / max |oracle|, within
``--tol`` (2e-3). Each component prints its errors, its worst and its
seconds; the script exits 1 on any FAIL.

    python scripts/full_width_parity_torch.py --component mistral --layers 4
    make parity-torch            # mistral at depth 4, clip, stc

Mistral at 4 layers holds one f32 model of ~4.5 GB at a time (the oracle's
outputs are kept, the model freed, then the port's is loaded); CLIP and
the STC run at their fixed geometry. Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import os
import shutil
import sys
import time
from pathlib import Path

os.environ.setdefault("USE_TF", "0")           # transformers without TensorFlow
os.environ.setdefault("USE_FLAX", "0")

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig, CLIPVisionTower  # noqa: E402
from phantom_vlb_tpu_torch.models.convert import (  # noqa: E402
    HF_STC_PREFIX,
    HF_VISION_PREFIX,
    SafetensorsDir,
    write_safetensors,
)
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, MistralModel, rope_tables  # noqa: E402
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig, STCConnector  # noqa: E402
from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig  # noqa: E402
from phantom_vlb_tpu_torch.train.builder import _stc_expected_keys, load_pretrained_params  # noqa: E402

MISTRAL_FULL = dict(vocab=32000, hidden=4096, inter=14336, heads=32, kv_heads=8, head_dim=128,
                    rope_theta=1e6, eps=1e-5)
CLIP_FULL = dict(hidden=1024, inter=4096, heads=16, layers=24, image=336, patch=14)
STC_FULL = dict(encoder=1024, hidden=4096, output=4096, depth=4, mlp_depth=2, frames=12, grid=24)
WINDOW = 2048            # the production sequence: RoPE's positions end here
TOL = 2e-3


def log(msg: str) -> None:
    print(f"[parity-torch {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


class Recorder:
    """A shard mapping that records which keys were read."""

    def __init__(self, inner):
        self.inner, self.read = inner, set()

    def __getitem__(self, key):
        self.read.add(key)
        return self.inner[key]

    def __contains__(self, key):
        return key in self.inner

    def __iter__(self):
        return iter(self.inner)

    def __len__(self):
        return len(self.inner)

    def unread(self) -> list[str]:
        return sorted(set(self.inner) - self.read)


def _empty_like_module(module: torch.nn.Module, prefix: str) -> dict[str, torch.Tensor]:
    """Uninitialised host tensors of a meta module's state dict, keyed
    with ``prefix``: what ``load_pretrained_params`` fills."""
    return {prefix + k: torch.empty(v.shape, dtype=v.dtype) for k, v in module.state_dict().items()}


def _assign(module: torch.nn.Module, params: dict, prefix: str) -> torch.nn.Module:
    module.load_state_dict({k[len(prefix):]: v for k, v in params.items()}, strict=True, assign=True)
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Mistral

def generate_mistral_shards(out: Path, layers: int, widths: dict = MISTRAL_FULL, seed: int = 0) -> None:
    """``model.*`` and ``lm_head.weight`` in HF's layout, f16, one shard a layer."""
    w_ = widths
    rng = np.random.default_rng(seed)
    h, inter, hd = w_["hidden"], w_["inter"], w_["head_dim"]

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape, np.float32) * scale).astype(np.float16)

    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "model-top.safetensors", {
        "model.embed_tokens.weight": w(w_["vocab"], h), "model.norm.weight": np.ones(h, np.float16),
        "lm_head.weight": w(w_["vocab"], h)})
    for i in range(layers):
        p = f"model.layers.{i}."
        write_safetensors(out / f"model-layer-{i:05d}.safetensors", {
            p + "self_attn.q_proj.weight": w(w_["heads"] * hd, h),
            p + "self_attn.k_proj.weight": w(w_["kv_heads"] * hd, h),
            p + "self_attn.v_proj.weight": w(w_["kv_heads"] * hd, h),
            p + "self_attn.o_proj.weight": w(h, w_["heads"] * hd),
            p + "mlp.gate_proj.weight": w(inter, h),
            p + "mlp.up_proj.weight": w(inter, h),
            p + "mlp.down_proj.weight": w(h, inter),
            p + "input_layernorm.weight": np.ones(h, np.float16) + w(h, scale=0.01),
            p + "post_attention_layernorm.weight": np.ones(h, np.float16) + w(h, scale=0.01)})
    log(f"wrote {layers}-layer Mistral shards ({widths['hidden']} wide) to {out}")


def mistral_config(layers: int, widths: dict = MISTRAL_FULL) -> MistralConfig:
    return MistralConfig(vocab_size=widths["vocab"], hidden_size=widths["hidden"],
                         intermediate_size=widths["inter"], num_hidden_layers=layers,
                         num_attention_heads=widths["heads"], num_key_value_heads=widths["kv_heads"],
                         head_dim=widths["head_dim"], rms_norm_eps=widths["eps"],
                         rope_theta=widths["rope_theta"], dtype=torch.float32, remat=False)


def load_port_decoder(ckpt: Path, cfg: MistralConfig, sd=None,
                      model_cfg: VLBConfig | None = None) -> tuple[MistralModel, list[str]]:
    """The port's decoder in f32 from the shards under ``ckpt`` through
    ``load_pretrained_params`` (``sd``: a :class:`Recorder` to read through;
    ``model_cfg``: the whole model's config, whose connector the shards'
    STC keys are checked against); returns it and the decoder keys not read."""
    with torch.device("meta"):
        model = MistralModel(cfg)
    rec = Recorder(SafetensorsDir(ckpt)) if sd is None else sd
    try:
        params = load_pretrained_params(model_cfg or VLBConfig(mistral=cfg), ckpt,
                                        _empty_like_module(model, "model."), sd=rec)
    finally:
        if sd is None:
            rec.inner.close()
    unread = [k for k in rec.unread() if k.startswith("model.")
              and not k.startswith(("model.vision_tower", "model.mm_projector"))]
    return _assign(model, params, "model."), unread


@torch.no_grad()
def decoder_states(model: MistralModel, ids: np.ndarray, positions: np.ndarray) -> list[np.ndarray]:
    """HF's ``hidden_states`` of the port's decoder at explicit positions:
    the embeddings, each layer's output but the last, then the final norm
    of the last."""
    cfg = model.cfg
    x = model.embed(torch.from_numpy(ids)).float()
    rope = rope_tables(torch.from_numpy(positions), cfg.head_dim, cfg.rope_theta)
    states = [x.numpy()]
    for layer in model.layers:
        x = layer(x, rope)
        states.append(x.numpy())
    states[-1] = model.norm(x).numpy()
    return states


def hf_mistral(ckpt: Path, cfg: MistralConfig, lm_head: bool = True):
    """``transformers``' Mistral (for causal LM, or the bare model) in f32
    from the same shards, read by the ``safetensors`` package."""
    from safetensors.torch import load_file
    from transformers import MistralConfig as HFConfig
    from transformers import MistralForCausalLM
    from transformers.models.mistral.modeling_mistral import MistralModel as HFModel

    hf_cfg = HFConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                      intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
                      num_attention_heads=cfg.num_attention_heads,
                      num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
                      rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
                      max_position_embeddings=32768, attn_implementation="eager",
                      tie_word_embeddings=False)
    state = {}
    for shard in sorted(Path(ckpt).glob("*.safetensors")):
        for k, v in load_file(shard).items():
            if k.startswith(("model.vision_tower", "model.mm_projector")):
                continue
            if lm_head or k.startswith("model."):
                state[k if lm_head else k[len("model."):]] = v.float()
    with torch.device("meta"):
        model = MistralForCausalLM(hf_cfg) if lm_head else HFModel(hf_cfg)
    missing, unexpected = model.load_state_dict(state, strict=False, assign=True)
    if unexpected or [k for k in missing if "rotary" not in k]:
        raise ValueError(f"HF Mistral state dict: missing {missing[:4]}, unexpected {unexpected[:4]}")
    if hasattr(model, "model"):
        model.model.rotary_emb = type(model.model.rotary_emb)(hf_cfg)
    else:
        model.rotary_emb = type(model.rotary_emb)(hf_cfg)
    return model.float().eval()


def run_mistral(out: Path, layers: int, seq: int, tol: float = TOL, widths: dict = MISTRAL_FULL,
                keep: bool = False) -> tuple[list, float]:
    """-> (failures, worst error) of the decoder against HF's."""
    if not (out / "model-top.safetensors").exists():
        generate_mistral_shards(out, layers, widths)
    cfg = mistral_config(layers, widths)
    ids = np.random.default_rng(1).integers(3, cfg.vocab_size, (1, seq)).astype(np.int64)
    regimes = {"pos 0..": np.arange(seq)[None],
               f"pos {WINDOW - seq}..": (WINDOW - seq + np.arange(seq))[None]}
    log("transformers MistralForCausalLM forward (f32)...")
    hf = hf_mistral(out, cfg)
    want = {}
    with torch.no_grad():
        for tag, pos in regimes.items():
            o = hf(input_ids=torch.from_numpy(ids), position_ids=torch.from_numpy(pos.astype(np.int64)),
                   output_hidden_states=True)
            want[tag] = ([h.numpy() for h in o.hidden_states], o.logits.numpy())
    del hf, o
    gc.collect()
    log("port decoder forward (f32, through load_pretrained_params)...")
    model, unread = load_port_decoder(out, cfg)
    failures = []
    if unread:
        failures.append(("mistral", "unread keys", unread[:8]))
        log(f"  FAIL: decoder keys not read: {unread[:8]}")
    sd = SafetensorsDir(out)
    lm_head = sd["lm_head.weight"].float()
    sd.close()
    worst = 0.0
    for tag, pos in regimes.items():
        got = decoder_states(model, ids, pos.astype(np.int64))
        hidden, logits = want[tag]
        if len(got) != len(hidden):
            raise AssertionError(f"{len(got)} hidden states against HF's {len(hidden)}")
        for i, (g, w) in enumerate(zip(got, hidden)):
            e = rel_err(g, w)
            worst = max(worst, e)
            name = "final norm" if i == layers else f"hidden[{i}]"
            log(f"  {tag} {name} rel_err {e:.3e} {'ok' if e < tol else 'FAIL'}")
            if e >= tol:
                failures.append((tag, name, e))
        e = rel_err(torch.from_numpy(got[-1]) @ lm_head.T, logits)
        worst = max(worst, e)
        log(f"  {tag} logits rel_err {e:.3e} {'ok' if e < tol else 'FAIL'}")
        if e >= tol:
            failures.append((tag, "logits", e))
    if not keep:
        shutil.rmtree(out, ignore_errors=True)
    return failures, worst


# ---------------------------------------------------------------------------
# CLIP ViT-L/14-336

def generate_clip_shards(out: Path, widths: dict = CLIP_FULL, seed: int = 2) -> None:
    """Random CLIP weights under VideoLLaMA2's prefix (post_layernorm
    included, as the real checkpoint holds it), f16, one shard a layer."""
    cw = widths
    rng = np.random.default_rng(seed)
    h, inter = cw["hidden"], cw["inter"]
    n_pos = (cw["image"] // cw["patch"]) ** 2 + 1

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape, np.float32) * scale).astype(np.float16)

    def ln():
        return np.ones(h, np.float16) + w(h, scale=0.01), w(h, scale=0.01)

    out.mkdir(parents=True, exist_ok=True)
    p = HF_VISION_PREFIX
    (pre_w, pre_b), (post_w, post_b) = ln(), ln()
    write_safetensors(out / "clip-top.safetensors", {
        p + "embeddings.patch_embedding.weight": w(h, 3, cw["patch"], cw["patch"]),
        p + "embeddings.class_embedding": w(h),
        p + "embeddings.position_embedding.weight": w(n_pos, h),
        p + "pre_layrnorm.weight": pre_w, p + "pre_layrnorm.bias": pre_b,
        p + "post_layernorm.weight": post_w, p + "post_layernorm.bias": post_b})
    for i in range(cw["layers"]):
        q = f"{p}encoder.layers.{i}."
        shard = {}
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shard[q + f"self_attn.{name}.weight"] = w(h, h)
            shard[q + f"self_attn.{name}.bias"] = w(h, scale=0.01)
        for name in ("layer_norm1", "layer_norm2"):
            shard[q + f"{name}.weight"], shard[q + f"{name}.bias"] = ln()
        shard[q + "mlp.fc1.weight"], shard[q + "mlp.fc1.bias"] = w(inter, h), w(inter, scale=0.01)
        shard[q + "mlp.fc2.weight"], shard[q + "mlp.fc2.bias"] = w(h, inter), w(h, scale=0.01)
        write_safetensors(out / f"clip-layer-{i:05d}.safetensors", shard)
    log(f"wrote {cw['layers']}-layer CLIP shards ({h} wide) to {out}")


def clip_config(widths: dict = CLIP_FULL) -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=widths["image"], patch_size=widths["patch"],
                            hidden_size=widths["hidden"], intermediate_size=widths["inter"],
                            num_hidden_layers=widths["layers"], num_attention_heads=widths["heads"],
                            dtype=torch.float32)


def load_port_tower(ckpt: Path, cfg: CLIPVisionConfig, sd=None,
                    model_cfg: VLBConfig | None = None) -> tuple[CLIPVisionTower, list[str]]:
    """The port's tower in f32 through ``load_pretrained_params`` (``sd``
    and ``model_cfg`` as for :func:`load_port_decoder`); returns it and the
    tower keys not read other than those the feature path never uses (the
    layers past ``select_layer`` and ``post_layernorm``)."""
    with torch.device("meta"):
        tower = CLIPVisionTower(cfg)
    rec = Recorder(SafetensorsDir(ckpt)) if sd is None else sd
    try:
        params = load_pretrained_params(model_cfg or VLBConfig(clip=cfg), ckpt,
                                        _empty_like_module(tower, "vision_tower."), sd=rec)
    finally:
        if sd is None:
            rec.inner.close()
    return _assign(tower, params, "vision_tower."), [
        k for k in rec.unread() if k.startswith(HF_VISION_PREFIX) and not k.startswith(clip_unused(cfg))]


def clip_unused(cfg: CLIPVisionConfig) -> tuple[str, ...]:
    """Prefixes of the tower keys the feature path never reads: the layers
    past ``select_layer`` and ``post_layernorm``."""
    return tuple(f"{HF_VISION_PREFIX}encoder.layers.{i}." for i in
                 range(cfg.effective_layers, cfg.num_hidden_layers)) + (HF_VISION_PREFIX + "post_layernorm.",)


def hf_clip_features(ckpt: Path, cfg: CLIPVisionConfig, pixels: np.ndarray) -> np.ndarray:
    """``transformers.CLIPVisionModel``'s ``hidden_states[-2]`` patch tokens
    (CLS dropped: LLaVA's and VideoLLaMA2's feature path)."""
    from safetensors.torch import load_file
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModel

    hf_cfg = HFConfig(hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
                      num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
                      image_size=cfg.image_size, patch_size=cfg.patch_size, hidden_act="quick_gelu",
                      layer_norm_eps=cfg.layer_norm_eps, attn_implementation="eager")
    state = {}
    for shard in sorted(Path(ckpt).glob("*.safetensors")):
        for k, v in load_file(shard).items():
            if k.startswith(HF_VISION_PREFIX):
                state["vision_model." + k[len(HF_VISION_PREFIX):]] = v.float()
    with torch.no_grad():
        model = CLIPVisionModel(hf_cfg)
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected or [k for k in missing if "position_ids" not in k and "post_layernorm" not in k]:
            raise ValueError(f"HF CLIP state dict: missing {missing[:4]}, unexpected {unexpected[:4]}")
        hs = model.float().eval()(pixel_values=torch.from_numpy(pixels), output_hidden_states=True).hidden_states
        return hs[-2][:, 1:].numpy()


def run_clip(out: Path, tol: float = TOL, widths: dict = CLIP_FULL, keep: bool = False) -> tuple[list, float]:
    if not (out / "clip-top.safetensors").exists():
        generate_clip_shards(out, widths)
    cfg = clip_config(widths)
    pixels = np.random.default_rng(3).standard_normal((2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    log("transformers CLIPVisionModel forward (f32)...")
    want = hf_clip_features(out, cfg, pixels)
    gc.collect()
    log("port CLIP tower forward (f32, through load_pretrained_params)...")
    tower, unread = load_port_tower(out, cfg)
    failures = [("clip", "unread keys", unread[:8])] if unread else []
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    if got.shape != want.shape:
        raise AssertionError(f"features {got.shape} against HF's {want.shape}")
    e = rel_err(got, want)
    log(f"  clip patch features {tuple(got.shape)} rel_err {e:.3e} {'ok' if e < tol else 'FAIL'}")
    if e >= tol:
        failures.append(("clip", "features", e))
    if not keep:
        shutil.rmtree(out, ignore_errors=True)
    return failures, e


# ---------------------------------------------------------------------------
# STC connector

def load_stc_fixture():
    """``tests/test_stc_hf_oracle.py`` as a module (its HF-authored oracle)."""
    spec = importlib.util.spec_from_file_location("stc_hf_oracle", ROOT / "tests" / "test_stc_hf_oracle.py")
    fix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fix)
    return fix


def stc_config(widths: dict = STC_FULL) -> STCConfig:
    return STCConfig(encoder_hidden_size=widths["encoder"], hidden_size=widths["hidden"],
                     output_hidden_size=widths["output"], depth=widths["depth"],
                     mlp_depth=widths["mlp_depth"], dtype=torch.float32)


def run_stc(out: Path, tol: float = TOL, widths: dict = STC_FULL, keep: bool = False) -> tuple[list, float]:
    fix = load_stc_fixture()
    cfg = stc_config(widths)
    log(f"HF STC oracle at {cfg.encoder_hidden_size} -> {cfg.hidden_size}, depth {cfg.depth}...")
    torch.manual_seed(4)
    oracle = fix.HFSTCOracle(cfg.encoder_hidden_size, cfg.hidden_size, cfg.output_hidden_size,
                             depth=cfg.depth, mlp_depth=cfg.mlp_depth)
    fix._randomize(oracle, seed=4)
    oracle = oracle.eval()
    sd = fix._remap({k: v.detach().numpy() for k, v in oracle.state_dict().items()})
    failures = []
    if set(sd) != _stc_expected_keys(cfg):
        failures.append(("stc", "keys", sorted(set(sd) ^ _stc_expected_keys(cfg))[:8]))
        log(f"  FAIL: the oracle's keys differ from the port's: {failures[-1][2]}")
    else:
        log("  the oracle's remapped keys == the port's _stc_expected_keys: ok")
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "stc.safetensors", {HF_STC_PREFIX + k: np.ascontiguousarray(v, np.float32)
                                                for k, v in sd.items()})
    del sd
    x = (np.random.default_rng(5).standard_normal(
        (1, widths["frames"], widths["grid"], widths["grid"], cfg.encoder_hidden_size)) * 0.5).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x)).numpy()
    del oracle
    gc.collect()
    with torch.device("meta"):
        stc = STCConnector(cfg)
    params = load_pretrained_params(VLBConfig(stc=cfg), out, _empty_like_module(stc, "mm_projector."))
    stc = _assign(stc, params, "mm_projector.")
    with torch.no_grad():
        got = stc(torch.from_numpy(x)).numpy()
    if got.shape != want.shape:
        raise AssertionError(f"tokens {got.shape} against the oracle's {want.shape}")
    e = rel_err(got, want)
    log(f"  stc tokens {tuple(got.shape)} rel_err {e:.3e} {'ok' if e < tol else 'FAIL'}")
    if e >= tol:
        failures.append(("stc", "tokens", e))
    if not keep:
        shutil.rmtree(out, ignore_errors=True)
    return failures, e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--component", choices=("mistral", "clip", "stc"), default="mistral")
    ap.add_argument("--layers", type=int, default=32, help="Mistral depth (CLIP and STC are fixed)")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--out", default=None, help="shard directory (default: a temporary one)")
    ap.add_argument("--tol", type=float, default=TOL)
    ap.add_argument("--keep", action="store_true", help="keep the generated shards")
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    out = Path(args.out) if args.out else Path(os.environ.get("TMPDIR", "/tmp")) / f"fwparity_torch_{args.component}"
    t0 = time.perf_counter()
    if args.component == "mistral":
        failures, worst = run_mistral(out, args.layers, args.seq, args.tol, MISTRAL_FULL, keep=args.keep)
        what = (f"Mistral {args.layers} layers at 4096/14336, GQA 32:8, rope 1e6 at positions 0.. and "
                f"{WINDOW - args.seq}..")
    elif args.component == "clip":
        failures, worst = run_clip(out, args.tol, keep=args.keep)
        what = "CLIP ViT-L/14-336: 24 layers, 1024 wide, 577 tokens, select -2 patch features"
    else:
        failures, worst = run_stc(out, args.tol, keep=args.keep)
        what = "STC 1024 -> 4096, depth 4, 12 x 24 x 24 -> 1183 tokens"
    seconds = time.perf_counter() - t0
    if failures:
        log(f"FULL-WIDTH PORT PARITY FAILED ({what}): {failures}")
        return 1
    log(f"FULL-WIDTH PORT PARITY OK ({what}): worst rel_err {worst:.3e} (tol {args.tol}) in {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
