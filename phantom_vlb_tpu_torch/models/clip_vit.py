"""CLIP ViT vision tower (ViT-L/14 at 336 px), frozen, in PyTorch.

Counterpart of ``phantom_vlb_tpu/models/clip_vit.py``: ``CLIPVisionConfig``
(:38-83), the dense layers ``_dense`` selects (:94-105), attention (:108-124),
the MLP (:127-135), the pre-LN layer (:138-146) and the tower (:163-227)::

    frames (N, 3, H, W) -> 14x14 / 14 patch conv (no bias) -> (N, P, C)
      -> [CLS] + patches, + position embeddings -> pre_layrnorm
      -> effective_layers x [x + attn(LN1(x)); x + fc2(quick_gelu(fc1(LN2(x))))]
      -> the selected layer's patch features (N, P, C), CLS dropped

The frames come in NCHW and the patch conv takes them so; the reference
transposes to NHWC first (``models/videollama2.py:154-157``), which gives
the same patch order. Only the layers up to ``select_layer`` exist: with
``select_layer=-2`` the 24th layer is never built, and ``post_layernorm``
is not applied, as in the LLaVA/VideoLLaMA2 feature path.

:class:`LayerNorm` is Flax's ``LayerNorm(dtype, param_dtype=f32)``: its
scale and bias stay f32, the statistics and the affine map run in f32 on
the input upcast, and the result is rounded once to the input's dtype.
Every other parameter is stored in the compute dtype, which rounds it as
the reference's cast at each use does. With ``base_quant`` every projection
is a :class:`~phantom_vlb_tpu_torch.models.lora.FrozenQuantDense` with its
bias (``'w8a8'`` and ``'w8a8g8'`` run ``row_quant`` on each projection's
input). Attention is :func:`~phantom_vlb_tpu_torch.ops.flash_attention.attention_noncausal`.
The tower never trains; its caller runs it without recording gradients.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from phantom_vlb_tpu_torch.models.lora import FrozenQuantDense, _check_base_quant
from phantom_vlb_tpu_torch.ops.flash_attention import attention_noncausal

__all__ = ["CLIPVisionConfig", "CLIPVisionTower", "LayerNorm", "quick_gelu"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-5
    select_layer: int = -2         # the penultimate layer (LLaVA/VideoLLaMA2)
    dtype: torch.dtype = torch.bfloat16
    # The frozen projections stored int8: None | 'int8' | 'w8a8' | 'w8a8g8'.
    base_quant: str | None = None

    def __post_init__(self):
        _check_base_quant(self.base_quant)
        if not 0 < self.effective_layers <= self.num_hidden_layers:
            raise ValueError(f"select_layer {self.select_layer} out of range")

    @property
    def effective_layers(self) -> int:
        """Layers actually built and run (up to the selected one)."""
        if self.select_layer < 0:
            return self.num_hidden_layers + self.select_layer + 1
        return self.select_layer

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @staticmethod
    def tiny(**overrides) -> "CLIPVisionConfig":
        """The reference's tiny tower (56 px, 64 wide, 2 layers), in f32."""
        base = dict(image_size=56, patch_size=14, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4, dtype=torch.float32)
        base.update(overrides)
        return CLIPVisionConfig(**base)


class LayerNorm(nn.LayerNorm):
    """Flax ``LayerNorm(dtype=x's, param_dtype=f32)``: f32 weight and bias,
    statistics and affine map in f32, one rounding to x's dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__(width, eps=eps, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _dense(cfg: CLIPVisionConfig, in_features: int, out_features: int) -> nn.Module:
    if cfg.base_quant is not None:
        return FrozenQuantDense(in_features, out_features, cfg.base_quant, cfg.dtype, bias=True)
    return nn.Linear(in_features, out_features, bias=True, dtype=cfg.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        e = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (_dense(cfg, e, e) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape

        def heads(t):
            return t.reshape(b, s, self.heads, e // self.heads).transpose(1, 2)

        out = attention_noncausal(heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, e))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = _dense(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = _dense(cfg, cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionTower(nn.Module):
    """(N, 3, H, W) normalised frames -> the selected layer's patch
    features (N, grid * grid, hidden) in ``cfg.dtype``."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        c, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False, dtype=cfg.dtype)
        self.class_embedding = nn.Parameter(torch.empty(c, dtype=cfg.dtype))
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, c, dtype=cfg.dtype))
        self.pre_layrnorm = LayerNorm(c, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.effective_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values.to(cfg.dtype))
        patches = patches.flatten(2).transpose(1, 2)                      # (N, P, C), (h, w) order
        cls = self.class_embedding.expand(n, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding
        x = self.pre_layrnorm(x)
        for layer in self.layers:
            x = layer(x)
        return x[:, 1:]
