"""Weights for the port: from the JAX package's Flax tree, from HF safetensors
shards, or random on the device.

:func:`from_flax_params` maps the parameter tree of the JAX
``VideoLLaMA2VLB`` (numpy leaves) onto this package's state-dict names. It
reads the decoder's unrolled ``model/layers_{i}`` form and its stacked
``layers_scan`` form, grouped (``sub_{g}``, leading axis L/G, layer ``j*G +
g``) or not (leading axis L), as
``phantom_vlb_tpu/models/convert.py:stack_layer_params`` writes them, and
the vision tower's ``layers_{i}`` and ``layers_scan`` (leading axis L)
forms; ``mm_projector`` is the STC connector:

- Dense ``kernel`` (in, out) -> ``nn.Linear`` ``weight`` (out, in);
- Conv ``kernel`` HWIO -> OIHW (the depthwise (3, 3, 1, C) -> (C, 1, 3, 3))
  and Conv3d DHWIO -> OIDHW;
- a quantized base's ``kernel_q`` int8 (in, out) -> ``weight_q`` (out, in)
  and ``kernel_scale`` (out,) -> ``weight_scale`` (``ops/quant.py``
  ``quantize_tree``'s leaves); the tower's ``bias`` beside them as it is;
- LoRA ``lora_a`` (in, r) and ``lora_b`` (r, out) -> as they are (the port
  stores them in the reference's orientation);
- ``embed_tokens/embedding``, RMSNorm ``weight``, ``class_embedding`` and
  ``position_embedding`` -> as they are;
- Flax LayerNorm ``scale``/``bias`` -> ``weight``/``bias`` (the STC's
  ``norm*/LayerNorm_0/`` level dropped);
- anything else raises.

:func:`init_params` makes a random full-width state dict on the device,
each tensor in its :func:`~phantom_vlb_tpu_torch.models.videollama2.stored_dtype`
(bf16 at full width, with the head, any adapters and the vision path's
LayerNorms in f32), from an explicit generator, without a host copy. With
``base_quant`` each projection of the decoder and of the tower is drawn in
that dtype and quantized on the device at once (``quantize_int8``), so the
bf16 model is never whole.
:func:`~phantom_vlb_tpu_torch.ops.quant.quantize_state_dict` quantizes an
existing state dict in place, projection by projection, on its device.

:class:`SafetensorsDir` reads the ``*.safetensors`` shards of a directory
(VideoLLaMA2's HF keys) on demand: the 8-byte header length, the JSON
header, then each tensor's bytes read into a host buffer of its own when
it is asked for (``readinto`` at its offset), copied to the target device
(BF16, F16, F32, I8 and I32). The files are never mapped: on the card's
machine the pages of a mapping stayed resident after ``madvise``, and a
3.9 GB checkpoint raised the reader's RSS by 3.1 GB; read so, host RSS
stays near one tensor. :func:`hf_key` names the HF key a state-dict
key is read from, the mapping that ``convert_mistral`` (:130),
``convert_clip_vision`` (:169) and ``convert_stc_connector`` (:224) of
``phantom_vlb_tpu/models/convert.py`` define; HF's layout is PyTorch's, so
it is renames only. Shards tagged :data:`PORT_LAYOUT` in their
``__metadata__`` hold this package's own state-dict names instead
(``train/from_jax.py`` writes a JAX param tree so).
:func:`write_safetensors` writes a shard, one tensor's bytes at a time.

A Flax leaf may be f32, int8 or bf16 (an ``ml_dtypes`` array, as Orbax
restores one; read through its 16-bit pattern), a ``None`` (a frozen leaf
of a trainable subtree: skipped), or a callable that returns the array
when the leaf is reached (a leaf not yet read from disk).
"""

from __future__ import annotations

import json
import math
import re
import struct
from pathlib import Path
from typing import Iterator, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.models.lora import is_lora_path
from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig, VideoLLaMA2VLB, is_norm, stored_dtype
from phantom_vlb_tpu_torch.ops.quant import quantize_int8

__all__ = ["from_flax_params", "flax_leaf_arrays", "flax_paths", "to_tensor", "init_params",
           "SafetensorsDir", "write_safetensors", "hf_key", "HF_VISION_PREFIX", "HF_STC_PREFIX",
           "PORT_LAYOUT"]

INIT_STD = 0.02  # HF Mistral's initializer_range (and CLIP's)

_DENSE = {("self_attn", n) for n in ("q_proj", "k_proj", "v_proj", "o_proj")} | {
    ("mlp", n) for n in ("gate_proj", "up_proj", "down_proj")
}
_NORMS = ("input_layernorm", "post_attention_layernorm")
# Flax path -> state-dict key.
_FIXED = {
    ("model", "embed_tokens", "embedding"): "model.embed_tokens.weight",
    ("model", "norm", "weight"): "model.norm.weight",
    ("head", "layer_norm1", "scale"): "head.layer_norm1.weight",
    ("head", "layer_norm1", "bias"): "head.layer_norm1.bias",
    ("head", "layer_norm2", "scale"): "head.layer_norm2.weight",
    ("head", "layer_norm2", "bias"): "head.layer_norm2.bias",
    ("head", "ridge", "linear", "kernel"): "head.ridge.linear.weight",
    ("head", "ridge", "linear", "bias"): "head.ridge.linear.bias",
    ("vision_tower", "patch_embedding", "kernel"): "vision_tower.patch_embedding.weight",
    ("vision_tower", "class_embedding"): "vision_tower.class_embedding",
    ("vision_tower", "position_embedding"): "vision_tower.position_embedding",
    ("vision_tower", "pre_layrnorm", "scale"): "vision_tower.pre_layrnorm.weight",
    ("vision_tower", "pre_layrnorm", "bias"): "vision_tower.pre_layrnorm.bias",
    ("mm_projector", "sampler_conv", "kernel"): "mm_projector.sampler_conv.weight",
    ("mm_projector", "sampler_conv", "bias"): "mm_projector.sampler_conv.bias",
}
# The vision tower's projections, and a bottleneck's convolutions and
# LayerNorms in the STC connector.
_CLIP_DENSE = {("self_attn", n) for n in ("q_proj", "k_proj", "v_proj", "out_proj")} | {
    ("mlp", n) for n in ("fc1", "fc2")
}
_STC_CONVS = ("conv1", "conv2", "conv3", "downsample_conv")
_STC_NORMS = ("norm1", "norm2", "norm3", "downsample_norm")
# Flax leaf name -> PyTorch's.
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias", "kernel_q": "weight_q",
               "kernel_scale": "weight_scale", "weight": "weight", "lora_a": "lora_a", "lora_b": "lora_b"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_paths(tree: Mapping) -> list[tuple]:
    """The paths of ``tree``'s leaves that hold a value (not ``None``)."""
    return [path for path, leaf in _flatten(tree) if leaf is not None]


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor of its own holding ``a``: bf16 (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) through its 16-bit pattern."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, order="C").view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def _unconsumed(path: tuple) -> ValueError:
    return ValueError(f"unconsumed Flax parameter {'/'.join(path)}")


def _layout(a: np.ndarray, name: str) -> np.ndarray:
    """A Flax leaf in PyTorch's layout: Dense ``kernel`` and ``kernel_q``
    (in, out) transposed; Conv HWIO / DHWIO -> OIHW / OIDHW; the rest (LoRA
    factors, scales, biases, norms, embeddings) as it is."""
    if name in ("kernel", "kernel_q") and a.ndim == 2:
        return a.T
    if name == "kernel" and a.ndim >= 4:
        return a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
    return a


def _layer_leaf(path: tuple, within: tuple) -> str:
    """Path inside one decoder layer -> key suffix."""
    if len(within) == 3 and within[:2] in _DENSE and within[2] in (
            "kernel", "kernel_q", "kernel_scale", "lora_a", "lora_b"):
        return f"{within[0]}.{within[1]}.{_LEAF_NAMES[within[2]]}"
    if len(within) == 2 and within[0] in _NORMS and within[1] == "weight":
        return f"{within[0]}.weight"
    raise _unconsumed(path)


def _clip_layer_leaf(path: tuple, within: tuple) -> str:
    """Path inside one tower layer -> key suffix."""
    if len(within) == 3 and within[:2] in _CLIP_DENSE and within[2] in (
            "kernel", "bias", "kernel_q", "kernel_scale"):
        return f"{within[0]}.{within[1]}.{_LEAF_NAMES[within[2]]}"
    if len(within) == 2 and within[0] in ("layer_norm1", "layer_norm2") and within[1] in ("scale", "bias"):
        return f"{within[0]}.{_LEAF_NAMES[within[1]]}"
    raise _unconsumed(path)


def _numbered(name: str, prefix: str) -> int | None:
    rest = name[len(prefix):] if name.startswith(prefix) else ""
    return int(rest) if rest.isdigit() else None


def _stc_key(path: tuple) -> str:
    """``mm_projector/...`` below the top level -> key."""
    p = path[1:]
    if len(p) == 2 and _numbered(p[0], "readout_") is not None and p[1] in ("kernel", "bias"):
        return f"mm_projector.readout.{_numbered(p[0], 'readout_')}.{_LEAF_NAMES[p[1]]}"
    if len(p) >= 4 and p[0] in ("s1", "s2") and _numbered(p[1], "b") is not None:
        block, within = f"mm_projector.{p[0]}.{p[1]}", p[2:]
        if len(within) == 2 and within[0] in _STC_CONVS and within[1] == "kernel":
            return f"{block}.{within[0]}.weight"
        if len(within) == 3 and within[0] in _STC_NORMS and within[1] == "LayerNorm_0" \
                and within[2] in ("scale", "bias"):
            return f"{block}.{within[0]}.{_LEAF_NAMES[within[2]]}"
        if len(within) == 3 and within[:2] in (("se", "fc1"), ("se", "fc2")) \
                and within[2] in ("kernel", "bias"):
            return f"{block}.se.{within[1]}.{_LEAF_NAMES[within[2]]}"
    raise _unconsumed(path)


def _layer_keys(path: tuple, group: int, n: int) -> list[str]:
    """Keys of a ``layers_{i}`` leaf (one) or of a stacked ``layers_scan``
    leaf of ``n`` layers, of the decoder (``model``; grouped ``sub_{g}``
    when ``group``, layer ``j*G + g``) or of the tower (``vision_tower``)."""
    root = path[0]
    leaf_of = _layer_leaf if root == "model" else _clip_layer_leaf
    layer = _numbered(path[1], "layers_")
    if layer is not None:
        return [f"{root}.layers.{layer}.{leaf_of(path, path[2:])}"]
    if path[1] != "layers_scan":
        raise _unconsumed(path)
    g, within = (_numbered(path[2], "sub_"), path[3:]) if group else (0, path[2:])
    if g is None:
        raise _unconsumed(path)
    suffix = leaf_of(path, within)
    return [f"{root}.layers.{j * max(group, 1) + g}.{suffix}" for j in range(n)]


def flax_leaf_arrays(tree: Mapping) -> Iterator[tuple[tuple, list[tuple[str, np.ndarray]]]]:
    """For each leaf of a Flax ``params`` tree of ``VideoLLaMA2VLB`` that
    holds a value, in tree order: its path and the (state-dict key, array
    in PyTorch's layout) pairs it maps to, the arrays views of the leaf
    (one a layer of a stacked leaf). A callable leaf is called when
    reached, so one leaf is in memory at a time."""
    for path, leaf in _flatten(tree):
        if leaf is not None:
            yield path, _leaf_pairs(tree, path, leaf)


def _leaf_pairs(tree: Mapping, path: tuple, leaf) -> list[tuple[str, np.ndarray]]:
    a = np.asarray(leaf() if callable(leaf) else leaf)
    if path in _FIXED:
        return [(_FIXED[path], _layout(a, path[-1]))]
    if path[0] == "mm_projector":
        return [(_stc_key(path), _layout(a, path[-1]))]
    if path[0] in ("model", "vision_tower") and len(path) >= 3:
        group = sum(1 for k in tree[path[0]].get("layers_scan", {}) if k.startswith("sub_"))
        keys = _layer_keys(path, group, len(a))
        slices = a if path[1] == "layers_scan" else [a]
        return [(key, _layout(x, path[-1])) for key, x in zip(keys, slices)]
    raise _unconsumed(path)


def from_flax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree of ``VideoLLaMA2VLB`` -> this package's state dict
    (CPU tensors of their own, in the leaves' dtypes)."""
    sd: dict[str, torch.Tensor] = {}
    for _, pairs in flax_leaf_arrays(tree):
        for key, a in pairs:
            if key in sd:
                raise ValueError(f"{key} given twice")
            sd[key] = to_tensor(a)
    return sd


def init_params(
    cfg: VLBConfig,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Random state dict made on ``device``, each tensor in its
    :func:`stored_dtype`: N(0, INIT_STD) projections, convolutions, biases
    and embeddings, unit norm weights and zero norm biases, an f32 head
    whose ridge weight is N(0, 1/hidden), and f32 adapters as the reference
    initialises them (``lora_a`` he-uniform over its fan-in, ``lora_b`` 0).
    With ``base_quant`` (the decoder's, or the tower's) each projection is
    drawn as above and quantized at once into ``weight_q`` /
    ``weight_scale``."""
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
        elif is_norm(key):
            fill = torch.ones if key.endswith(".weight") else torch.zeros
            sd[key] = fill(meta.shape, dtype=stored_dtype(key, cfg), device=device)
        elif key.endswith(".weight_scale"):
            continue                                     # made with its weight_q
        elif key.endswith(".weight_q"):
            base = key[: -len("weight_q")]
            t = torch.randn(meta.shape, generator=generator, device=device,
                            dtype=stored_dtype(base + "weight", cfg))
            sd[key], sd[base + "weight_scale"] = quantize_int8(t.mul_(INIT_STD), axis=1)
            del t
        else:
            t = torch.randn(meta.shape, generator=generator, device=device, dtype=stored_dtype(key, cfg))
            sd[key] = t.mul_(INIT_STD)
    return sd


# ---------------------------------------------------------------------------
# HF safetensors

SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
                      "I8": torch.int8, "I32": torch.int32}
HF_VISION_PREFIX = "model.vision_tower.vision_tower.vision_model."
HF_STC_PREFIX = "model.mm_projector."
# The ``__metadata__`` of shards keyed by this package's state-dict names.
PORT_LAYOUT = {"format": "pt", "layout": "phantom_vlb_tpu_torch"}
_NUMPY_NAMES = {"float32": "F32", "float16": "F16", "int8": "I8", "int32": "I32", "bfloat16": "BF16"}


def _dtype_name(t) -> str:
    """The safetensors dtype name of a tensor or a numpy array."""
    name = ({v: k for k, v in SAFETENSORS_DTYPES.items()}.get(t.dtype) if isinstance(t, torch.Tensor)
            else _NUMPY_NAMES.get(t.dtype.name))
    if name is None:
        raise ValueError(f"safetensors shards here hold {sorted(SAFETENSORS_DTYPES)}, not {t.dtype}")
    return name


def _host_bytes(t) -> np.ndarray:
    """A flat uint8 view of a contiguous host copy of ``t``."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8)


def write_safetensors(path: str | Path, tensors: Mapping[str, object],
                      metadata: Mapping[str, str] | None = None) -> int:
    """A safetensors file at ``path``: an 8-byte little-endian header length,
    a JSON header (``__metadata__``, then each tensor's dtype, shape and
    byte offsets) padded to 8 bytes, then the bytes. ``tensors`` maps keys
    to numpy arrays (bf16 ones included) or tensors on any device; each is
    copied to the host when its bytes are written, so the host holds one
    at a time. Returns the bytes written."""
    header: dict[str, object] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for key, t in tensors.items():
        dtype = _dtype_name(t)
        nbytes = math.prod(t.shape) * SAFETENSORS_DTYPES[dtype].itemsize
        header[key] = {"dtype": dtype, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for t in tensors.values():
            f.write(memoryview(_host_bytes(t)))
    return 8 + len(text) + offset


class SafetensorsDir(Mapping):
    """Read-on-demand mapping over the ``*.safetensors`` shards under
    ``path``: HF key -> tensor on ``device``, read when asked for."""

    def __init__(self, path: str | Path, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self._files: list = []
        self._index: dict[str, tuple] = {}     # key -> (shard, dtype, shape, begin, end)
        self.metadata: dict[str, str] | None = None     # the shards' ``__metadata__`` (all alike)
        shards = sorted(Path(path).glob("*.safetensors"))
        if not shards:
            raise FileNotFoundError(f"no *.safetensors shards under {path}")
        for i, shard in enumerate(shards):
            f = open(shard, "rb", buffering=0)
            self._files.append(f)
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = f.seek(0, 2)
            meta = header.get("__metadata__")
            if i and meta != self.metadata:
                raise ValueError(f"{shard.name}'s __metadata__ {meta} differs from {shards[0].name}'s "
                                 f"{self.metadata}")
            self.metadata = meta
            for key, info in header.items():
                if key == "__metadata__":
                    continue
                if info["dtype"] not in SAFETENSORS_DTYPES:
                    raise ValueError(f"{shard.name}: {key} has dtype {info['dtype']}, not one of "
                                     f"{sorted(SAFETENSORS_DTYPES)}")
                dtype = SAFETENSORS_DTYPES[info["dtype"]]
                shape = tuple(int(d) for d in info["shape"])
                begin, end = (8 + n + int(o) for o in info["data_offsets"])
                if end - begin != math.prod(shape) * dtype.itemsize or end > size or begin < 8 + n:
                    raise ValueError(f"{shard.name}: {key}'s offsets do not fit its shape and dtype")
                if key in self._index:
                    raise ValueError(f"{key} is in two shards")
                self._index[key] = (len(self._files) - 1, dtype, shape, begin, end)

    def __getitem__(self, key: str) -> torch.Tensor:
        i, dtype, shape, begin, end = self._index[key]
        host = torch.empty(end - begin, dtype=torch.uint8)
        f = self._files[i]
        f.seek(begin)
        view, done = memoryview(host.numpy()), 0
        while done < end - begin:
            got = f.readinto(view[done:])
            if not got:
                raise ValueError(f"{key}: the shard ends before its bytes")
            done += got
        return host.view(dtype).reshape(shape).to(self.device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key) -> bool:
        return key in self._index

    def close(self) -> None:
        for f in self._files:
            f.close()
        self._files = []


_HF_TOWER_FIXED = {
    "patch_embedding.weight": "embeddings.patch_embedding.weight",
    "class_embedding": "embeddings.class_embedding",
    "position_embedding": "embeddings.position_embedding.weight",
    "pre_layrnorm.weight": "pre_layrnorm.weight",
    "pre_layrnorm.bias": "pre_layrnorm.bias",
}
_STC_BLOCK = re.compile(r"^(s[12]\.b\d+)\.(.+)$")
_STC_WITHIN = {f"conv{i}.weight": f"conv{i}.conv.weight" for i in (1, 2, 3)} | {
    f"norm{i}.{x}": f"conv{i}.bn.{x}" for i in (1, 2, 3) for x in ("weight", "bias")} | {
    f"se.fc{i}.{x}": f"se.fc{i}.{x}" for i in (1, 2) for x in ("weight", "bias")} | {
    "downsample_conv.weight": "downsample.conv.weight",
    "downsample_norm.weight": "downsample.bn.weight", "downsample_norm.bias": "downsample.bn.bias"}


def hf_key(key: str) -> str | None:
    """The HF checkpoint key (VideoLLaMA2's names) that state-dict ``key``
    is read from; a quantized base's ``weight_q`` and ``weight_scale`` are
    made from its ``weight``. None for what no HF checkpoint holds: the
    head and the LoRA factors."""
    if key.startswith("head.") or is_lora_path(key):
        return None
    if key.endswith((".weight_q", ".weight_scale")):
        key = key.rsplit(".", 1)[0] + ".weight"
    if key.startswith("model."):
        return key
    if key.startswith("vision_tower."):
        rest = key[len("vision_tower."):]
        if rest in _HF_TOWER_FIXED:
            return HF_VISION_PREFIX + _HF_TOWER_FIXED[rest]
        if rest.startswith("layers."):
            return HF_VISION_PREFIX + "encoder." + rest
    if key.startswith("mm_projector."):
        rest = key[len("mm_projector."):]
        m = _STC_BLOCK.match(rest)
        if m and m.group(2) in _STC_WITHIN:
            return f"{HF_STC_PREFIX}{m.group(1)}.{_STC_WITHIN[m.group(2)]}"
        if rest in ("sampler_conv.weight", "sampler_conv.bias"):
            return f"{HF_STC_PREFIX}sampler.0.{rest.rsplit('.', 1)[1]}"
        m = re.match(r"^readout\.(\d+)\.(weight|bias)$", rest)
        if m:
            return f"{HF_STC_PREFIX}readout.{2 * int(m.group(1))}.{m.group(2)}"
    raise ValueError(f"no HF key is known for {key}")
