"""Mistral-7B decoder over input embeddings, in PyTorch.

Counterpart of ``phantom_vlb_tpu/models/mistral.py``: RMSNorm in HF order
(:94-113), split-half RoPE on the packed layout (:116-183), GQA attention on
the packed branch (:265-281) through :func:`attention_packed`, the SwiGLU MLP
(:326-340), the pre-norm decoder layer (:343) and the stack (:396-513).
The layers are an unrolled ``nn.ModuleList``: the reference's scan, remat
and layer grouping are XLA compile devices with no counterpart here.

Parameters are stored in the compute dtype (``MistralConfig.dtype``); the
reference keeps f32 parameters and casts them to that dtype at each use,
which rounds them the same way.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from phantom_vlb_tpu_torch.ops.flash_attention import attention_packed

__all__ = ["MistralConfig", "MistralModel", "RMSNorm", "rope_tables", "apply_rope_packed"]


@dataclasses.dataclass(frozen=True)
class MistralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def full(**overrides) -> "MistralConfig":
        """Mistral-7B-v0.2 at full width (the reference's backbone)."""
        return MistralConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "MistralConfig":
        """The reference's tiny test config (``MistralConfig.tiny``), in f32."""
        base = dict(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, dtype=torch.float32,
        )
        base.update(overrides)
        return MistralConfig(**base)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # HF order: normalise in f32, cast back, then multiply by the weight.
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + self.eps)
        return h.to(x.dtype) * self.weight.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) tables (B|1, 1, S, D/2) f32 for int positions (B|1, S)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[:, None, :, None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope_packed(x: torch.Tensor, rope, num_heads: int) -> torch.Tensor:
    """HF split-half rotary embedding on (B, S, H*D), in x's dtype."""
    b, s, hd = x.shape
    d = hd // num_heads
    cos, sin = (t.transpose(1, 2).to(x.dtype) for t in rope)   # (B|1, S, 1, D/2)
    x1, x2 = x.reshape(b, s, num_heads, d).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(b, s, hd)


class MistralAttention(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, h * d, bias=False)
        self.k_proj = nn.Linear(cfg.hidden_size, hkv * d, bias=False)
        self.v_proj = nn.Linear(cfg.hidden_size, hkv * d, bias=False)
        self.o_proj = nn.Linear(h * d, cfg.hidden_size, bias=False)

    def forward(self, x, rope, kv_mask=None):
        cfg = self.cfg
        h, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        q = apply_rope_packed(self.q_proj(x), rope, h)
        k = apply_rope_packed(self.k_proj(x), rope, hkv)
        out, _ = attention_packed(q, k, self.v_proj(x), h, hkv, kv_mask=kv_mask)
        return self.o_proj(out)


class MistralMLP(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MistralDecoderLayer(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MistralAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MistralMLP(cfg)

    def forward(self, x, rope, kv_mask=None):
        h = x + self.self_attn(self.input_layernorm(x), rope, kv_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class MistralModel(nn.Module):
    """Decoder stack over embeddings (the multimodal splice feeds embeds)."""

    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            MistralDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, kv_mask: torch.Tensor | None = None):
        """(B, S, E) embeddings + (B, S) kv mask -> post-final-norm (B, S, E)."""
        cfg = self.cfg
        s = inputs_embeds.shape[1]
        # (1, S) identity positions: the tables broadcast over the batch.
        positions = torch.arange(s, device=inputs_embeds.device)[None]
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x = inputs_embeds.to(cfg.dtype)
        for layer in self.layers:
            x = layer(x, rope, kv_mask)
        return self.norm(x)
