"""Weights for the port: from the JAX package's Flax tree, or random on the device.

:func:`from_flax_params` maps the parameter tree of the JAX
``VideoLLaMA2VLB`` (numpy leaves) onto this package's state-dict names. It
reads the unrolled ``model/layers_{i}`` form and the stacked ``layers_scan``
form, grouped (``sub_{g}``, leading axis L/G, layer ``j*G + g``) or not
(leading axis L), as ``phantom_vlb_tpu/models/convert.py:stack_layer_params``
writes them:

- Dense ``kernel`` (in, out) -> ``nn.Linear`` ``weight`` (out, in);
- a quantized base's ``kernel_q`` int8 (in, out) -> ``weight_q`` (out, in)
  and ``kernel_scale`` (out,) -> ``weight_scale`` (``ops/quant.py``
  ``quantize_tree``'s leaves);
- LoRA ``lora_a`` (in, r) and ``lora_b`` (r, out) -> as they are (the port
  stores them in the reference's orientation);
- ``embed_tokens/embedding``, RMSNorm ``weight`` -> as they are;
- Flax LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- ``vision_tower`` and ``mm_projector`` are set aside for the vision slice;
- anything else raises.

:func:`init_params` makes a random full-width state dict on the device, in
the backbone's dtype (bf16 at full width) with the head and any adapters in
f32, from an explicit generator, without a host copy of the backbone. With
``base_quant`` each projection is drawn in that dtype and quantized on the
device at once (``quantize_int8``), so the bf16 model is never whole.
:func:`~phantom_vlb_tpu_torch.ops.quant.quantize_state_dict` quantizes an
existing state dict in place, projection by projection, on its device.
"""

from __future__ import annotations

import math
from typing import Iterator, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.models.lora import is_lora_path
from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig, VideoLLaMA2VLB
from phantom_vlb_tpu_torch.ops.quant import quantize_int8

__all__ = ["from_flax_params", "init_params", "DEFERRED_SUBTREES"]

INIT_STD = 0.02  # HF Mistral's initializer_range
# Vision-path subtrees: not used on the cached-token path.
DEFERRED_SUBTREES = ("vision_tower", "mm_projector")

_DENSE = {("self_attn", n) for n in ("q_proj", "k_proj", "v_proj", "o_proj")} | {
    ("mlp", n) for n in ("gate_proj", "up_proj", "down_proj")
}
_NORMS = ("input_layernorm", "post_attention_layernorm")
# Flax path -> (state-dict key, transpose).
_FIXED = {
    ("model", "embed_tokens", "embedding"): ("model.embed_tokens.weight", False),
    ("model", "norm", "weight"): ("model.norm.weight", False),
    ("head", "layer_norm1", "scale"): ("head.layer_norm1.weight", False),
    ("head", "layer_norm1", "bias"): ("head.layer_norm1.bias", False),
    ("head", "layer_norm2", "scale"): ("head.layer_norm2.weight", False),
    ("head", "layer_norm2", "bias"): ("head.layer_norm2.bias", False),
    ("head", "ridge", "linear", "kernel"): ("head.ridge.linear.weight", True),
    ("head", "ridge", "linear", "bias"): ("head.ridge.linear.bias", False),
}


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unconsumed(path: tuple) -> ValueError:
    return ValueError(f"unconsumed Flax parameter {'/'.join(path)}")


def _layer_leaf(path: tuple, within: tuple) -> tuple[str, bool]:
    """Path inside one decoder layer -> (key suffix, transpose)."""
    if len(within) == 3 and within[:2] in _DENSE and within[2] == "kernel":
        return f"{within[0]}.{within[1]}.weight", True
    if len(within) == 3 and within[:2] in _DENSE and within[2] == "kernel_q":
        return f"{within[0]}.{within[1]}.weight_q", True
    if len(within) == 3 and within[:2] in _DENSE and within[2] in ("lora_a", "lora_b", "kernel_scale"):
        name = "weight_scale" if within[2] == "kernel_scale" else within[2]
        return f"{within[0]}.{within[1]}.{name}", False
    if len(within) == 2 and within[0] in _NORMS and within[1] == "weight":
        return f"{within[0]}.weight", False
    raise _unconsumed(path)


def from_flax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree of ``VideoLLaMA2VLB`` -> this package's state dict (CPU)."""
    sd: dict[str, torch.Tensor] = {}

    def put(key: str, leaf, transpose: bool) -> None:
        if key in sd:
            raise ValueError(f"{key} given twice")
        a = np.asarray(leaf)
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))  # own copy

    scan = tree.get("model", {}).get("layers_scan", {})
    group = sum(1 for k in scan if k.startswith("sub_"))
    for path, leaf in _flatten(tree):
        if path[0] in DEFERRED_SUBTREES:
            continue
        if path in _FIXED:
            key, transpose = _FIXED[path]
            put(key, leaf, transpose)
        elif path[0] != "model" or len(path) < 3:
            raise _unconsumed(path)
        elif path[1] == "layers_scan":
            if group:                                   # layers_scan/sub_{g}/...
                g, within = int(path[2][len("sub_"):]), path[3:]
            else:
                g, within = 0, path[2:]
            suffix, transpose = _layer_leaf(path, within)
            for j, a in enumerate(np.asarray(leaf)):
                put(f"model.layers.{j * max(group, 1) + g}.{suffix}", a, transpose)
        elif path[1].startswith("layers_") and path[1][len("layers_"):].isdigit():
            suffix, transpose = _layer_leaf(path, path[2:])
            put(f"model.layers.{int(path[1][len('layers_'):])}.{suffix}", leaf, transpose)
        else:
            raise _unconsumed(path)
    return sd


def init_params(
    cfg: VLBConfig,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Random state dict made on ``device``: N(0, INIT_STD) projections and
    embeddings in ``cfg.mistral.dtype``, unit norms, an f32 head whose
    ridge weight is N(0, 1/hidden), and f32 adapters as the reference
    initialises them (``lora_a`` he-uniform over its fan-in, ``lora_b`` 0).
    With ``cfg.mistral.base_quant`` each projection is drawn as above and
    quantized at once into ``weight_q`` / ``weight_scale``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.device("meta"):
        shapes = VideoLLaMA2VLB(cfg).state_dict()
    sd = {}
    for key, meta in shapes.items():
        if key.startswith("head."):
            if key == "head.ridge.linear.weight":
                t = torch.randn(meta.shape, generator=generator, device=device)
                sd[key] = t.mul_(1.0 / math.sqrt(meta.shape[1]))
            elif key.endswith(".weight"):
                sd[key] = torch.ones(meta.shape, device=device)
            else:
                sd[key] = torch.zeros(meta.shape, device=device)
        elif is_lora_path(key):
            if key.endswith("lora_a"):
                bound = math.sqrt(6.0 / meta.shape[0])
                t = torch.rand(meta.shape, generator=generator, device=device)
                sd[key] = t.mul_(2.0 * bound).sub_(bound)
            else:
                sd[key] = torch.zeros(meta.shape, device=device)
        elif key.endswith("norm.weight"):
            sd[key] = torch.ones(meta.shape, dtype=cfg.mistral.dtype, device=device)
        elif key.endswith(".weight_scale"):
            continue                                     # made with its weight_q
        elif key.endswith(".weight_q"):
            t = torch.randn(meta.shape, generator=generator, device=device, dtype=cfg.mistral.dtype)
            base = key[: -len("weight_q")]
            sd[key], sd[base + "weight_scale"] = quantize_int8(t.mul_(INIT_STD), axis=1)
            del t
        else:
            t = torch.randn(meta.shape, generator=generator, device=device, dtype=cfg.mistral.dtype)
            sd[key] = t.mul_(INIT_STD)
    return sd
