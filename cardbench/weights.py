"""The model's tensors, made on the device from the seed, block by block.

The benchmark hands the same weights to the program and to the plain
reference. Tensors are named as the port's state dict names them (the
checkpoint layout, :func:`state_spec`). They are grouped into blocks (a
decoder layer, a tower layer, a connector block, else one module), and each
block is drawn by one ``torch.randn`` call per dtype from a generator on the
device seeded with (seed, block): so set-up makes them in a few large calls,
and the reference makes any block again when it needs it instead of holding
a second copy. Each tensor is drawn in the dtype the model keeps it in and
then scaled by its role: projections N(0, 0.02) (HF's initializer range),
norm weights 1 + N(0, 0.1), ``lora_a`` N(0, 1/in), ``lora_b`` N(0, 0.02)
(non-zero, as after some training, so that the adapters count), the ridge
weight N(0, 1/hidden).
"""

from __future__ import annotations

import hashlib
import math
import re

import torch

__all__ = ["state_spec", "block_of", "blocks", "make_block", "block_seed"]

INIT_STD = 0.02
_BLOCK = re.compile(r"^(model\.layers\.\d+|vision_tower\.layers\.\d+|mm_projector\.s[12]\.b\d+)\.")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def block_of(name: str) -> str:
    m = _BLOCK.match(name)
    return m.group(1) if m else name.rsplit(".", 1)[0]


def block_seed(seed: int, block: str) -> int:
    """A 63-bit generator seed from the run's seed and the block's name."""
    digest = hashlib.blake2b(f"{seed}/{block}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _is_norm(name: str) -> bool:
    return name.count(".") >= 2 and "norm" in name.rsplit(".", 2)[-2]


def _linear(spec: list, prefix: str, n_in: int, n_out: int, dtype, bias: bool = False,
            lora: dict | None = None) -> None:
    spec.append((f"{prefix}.weight", (n_out, n_in), dtype))
    if bias:
        spec.append((f"{prefix}.bias", (n_out,), dtype))
    if lora is not None:
        spec.append((f"{prefix}.lora_a", (n_in, int(lora["r"])), torch.float32))
        spec.append((f"{prefix}.lora_b", (int(lora["r"]), n_out), torch.float32))


def _layer_norm(spec: list, prefix: str, width: int) -> None:
    spec += [(f"{prefix}.weight", (width,), torch.float32), (f"{prefix}.bias", (width,), torch.float32)]


def state_spec(model: dict) -> list[tuple[str, tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every tensor of the VideoLLaMA2 VLB that a
    configuration file's ``model`` group describes, named as in the port's
    state dict."""
    dt = DTYPES[model["dtype"]]
    t, v, c, h = model["text"], model["vision"], model["connector"], model["head"]
    lora = model.get("lora") if model["trainable"] == "lora+head" else None
    spec: list = []
    # The CLIP tower, up to the selected layer.
    e, p = v["hidden_size"], v["patch_size"]
    grid = v["image_size"] // p
    spec += [("vision_tower.patch_embedding.weight", (e, 3, p, p), dt),
             ("vision_tower.class_embedding", (e,), dt),
             ("vision_tower.position_embedding", (grid * grid + 1, e), dt)]
    _layer_norm(spec, "vision_tower.pre_layrnorm", e)
    layers = v["num_hidden_layers"] + v["select_layer"] + 1 if v["select_layer"] < 0 else v["select_layer"]
    for i in range(layers):
        pre = f"vision_tower.layers.{i}"
        _layer_norm(spec, f"{pre}.layer_norm1", e)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{pre}.self_attn.{proj}", e, e, dt, bias=True)
        _layer_norm(spec, f"{pre}.layer_norm2", e)
        _linear(spec, f"{pre}.mlp.fc1", e, v["intermediate_size"], dt, bias=True)
        _linear(spec, f"{pre}.mlp.fc2", v["intermediate_size"], e, dt, bias=True)
    # The STC connector.
    ch, out = c["hidden_size"], t["hidden_size"]
    for stage, first_in in (("s1", e), ("s2", ch)):
        for j in range(c["depth"]):
            pre, cin = f"mm_projector.{stage}.b{j + 1}", first_in if j == 0 else ch
            rd = max(1, int(round(cin * c["se_ratio"])))
            spec.append((f"{pre}.conv1.weight", (ch, cin, 1, 1), dt))
            _layer_norm(spec, f"{pre}.norm1", ch)
            spec.append((f"{pre}.conv2.weight", (ch, 1, 3, 3), dt))
            _layer_norm(spec, f"{pre}.norm2", ch)
            spec += [(f"{pre}.se.fc1.weight", (rd, ch, 1, 1), dt), (f"{pre}.se.fc1.bias", (rd,), dt),
                     (f"{pre}.se.fc2.weight", (ch, rd, 1, 1), dt), (f"{pre}.se.fc2.bias", (ch,), dt)]
            spec.append((f"{pre}.conv3.weight", (ch, ch, 1, 1), dt))
            _layer_norm(spec, f"{pre}.norm3", ch)
            if cin != ch:
                spec.append((f"{pre}.downsample_conv.weight", (ch, cin, 1, 1), dt))
                _layer_norm(spec, f"{pre}.downsample_norm", ch)
        if stage == "s1":
            spec += [("mm_projector.sampler_conv.weight", (ch, ch, 2, 2, 2), dt),
                     ("mm_projector.sampler_conv.bias", (ch,), dt)]
    widths = [ch] + [out] * c["mlp_depth"]
    for k, (n_in, n_out) in enumerate(zip(widths, widths[1:])):
        _linear(spec, f"mm_projector.readout.{k}", n_in, n_out, dt, bias=True)
    # The Mistral decoder.
    hd, hq, hkv = t["head_dim"], t["num_attention_heads"], t["num_key_value_heads"]
    spec.append(("model.embed_tokens.weight", (t["vocab_size"], out), dt))
    for i in range(t["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        spec.append((f"{pre}.input_layernorm.weight", (out,), dt))
        for proj, n_in, n_out in (("q_proj", out, hq * hd), ("k_proj", out, hkv * hd),
                                  ("v_proj", out, hkv * hd), ("o_proj", hq * hd, out)):
            _linear(spec, f"{pre}.self_attn.{proj}", n_in, n_out, dt, lora=lora)
        spec.append((f"{pre}.post_attention_layernorm.weight", (out,), dt))
        for proj, n_in, n_out in (("gate_proj", out, t["intermediate_size"]),
                                  ("up_proj", out, t["intermediate_size"]),
                                  ("down_proj", t["intermediate_size"], out)):
            _linear(spec, f"{pre}.mlp.{proj}", n_in, n_out, dt, lora=lora)
    spec.append(("model.norm.weight", (out,), dt))
    # The head, in f32.
    for ln in ("layer_norm1", "layer_norm2"):
        _layer_norm(spec, f"head.{ln}", out)
    _linear(spec, "head.ridge.linear", out, h["num_target"], torch.float32, bias=True)
    return spec


def blocks(spec) -> dict[str, list]:
    """The spec's entries by block, in the spec's order."""
    out: dict[str, list] = {}
    for entry in spec:
        out.setdefault(block_of(entry[0]), []).append(entry)
    return out


def _scale_(name: str, shape, t: torch.Tensor) -> torch.Tensor:
    if name.endswith(".lora_a"):
        return t.mul_(1.0 / math.sqrt(shape[0]))
    if name == "head.ridge.linear.weight":
        return t.mul_(1.0 / math.sqrt(shape[1]))
    if _is_norm(name) and name.endswith(".weight"):
        return t.mul_(0.1).add_(1.0)
    return t.mul_(INIT_STD)


def make_block(seed: int, block: str, entries: list, device) -> dict[str, torch.Tensor]:
    """The tensors of ``block`` (its spec entries) on ``device``: one
    ``randn`` per dtype from the block's generator, cut into the tensors in
    the entries' order and scaled by role."""
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block))
    out: dict[str, torch.Tensor] = {}
    for dtype in sorted({d for _, _, d in entries}, key=str):
        members = [(n, s) for n, s, d in entries if d == dtype]
        total = sum(math.prod(s) for _, s in members)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        offset = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = _scale_(name, shape, flat[offset:offset + n].view(shape))
            offset += n
    return out
