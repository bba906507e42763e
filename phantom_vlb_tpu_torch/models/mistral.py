"""Mistral-7B decoder over input embeddings, in PyTorch.

Counterpart of ``phantom_vlb_tpu/models/mistral.py``: RMSNorm in HF order
(:94-113), split-half RoPE on the packed layout (:116-183), GQA attention on
the packed branch (:265-281) through :func:`attention_packed` or, with a ring
``attention_impl``, context-parallel over the sequence ring (:290-315), the SwiGLU MLP
(:326-340), the pre-norm decoder layer (:343) and the stack (:396-513).
The layers are an unrolled ``nn.ModuleList``; the reference's scan and layer
grouping are XLA compile devices with no counterpart here.

With ``MistralConfig.lora`` every projection is a :class:`LoRALinear`
(``_proj``/``_call_proj`` :206-232); ``base_quant`` (``'int8'``,
``'w8a8'``, ``'w8a8g8'``) makes its frozen base int8, or, without LoRA,
makes every projection a :class:`FrozenQuantDense`; and ``shared_dropout`` gives q/k/v and
gate/up one adapter-input mask each (:234-245). ``remat`` wraps each layer
in ``torch.utils.checkpoint`` (non-reentrant) when gradients are recorded
(:418-455), which keeps each layer's input and replays the layer in the
backward; ``remat_policy`` (:55-60, :185-203; ``core/remat.py``) says what
else the layer keeps from its forward so the replay skips it: ``'nothing'``,
``'attn'``, ``'mids'``, ``'flash'`` or ``'dots'``, named as in JAX at the
same sites (``attn_out`` here, after the packed path or the ring, as at
:280 and :321; ``flash_out``/``flash_lse`` in ``ops/flash_attention.py``,
``lora_mid`` in ``models/lora.py``). Every ring takes every policy: the
rings name nothing inside, as the reference's ``custom_vjp``s do not, so
each policy's replay runs the ring's forward again. The replay must draw the same
dropout masks, so every mask comes from a seed derived before the layer
runs (step seed -> layer -> site), never from a generator's state.

Parameters are stored in the compute dtype (``MistralConfig.dtype``); the
reference keeps f32 parameters and casts them to that dtype at each use,
which rounds them the same way. LoRA adapters stay f32 and are cast at use,
as there.

Split over the ``tensor`` axis of a process mesh (``parallel/tensor.py``;
the projections' ``tensor_split``, set by ``parallel/sharding.py``), a
layer holds its rank's heads (16 q and 4 kv of Mistral-7B's 32 and 8 at
``tensor`` 2) and its block of the MLP's width: the base products of the
column-parallel q/k/v and gate/up read the attention's and the MLP's
input through :func:`copy_to_tensor` (except under w8a8g8, whose int8 dx
sums itself), and o/down sum their products over the ranks. The head
counts follow the projections' widths.

``attention_impl``: ``'auto'`` is the packed flash path; ``'ring'``,
``'ring_flash'`` and ``'ring_fused'`` split the sequence over the ring that
:func:`~phantom_vlb_tpu_torch.core.mesh.set_sequence_ring` set, after RoPE
on the global positions, as the reference does. The per-layer checkpoint
replays the ring, which :func:`~phantom_vlb_tpu_torch.core.mesh.get_sequence_ring`
gives at each call: the ring stays set through the backward. The attention
owns no parameters, so
:func:`set_attention_impl` switches a built model in place, and
:func:`set_remat_policy` its policy.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from phantom_vlb_tpu_torch.core.mesh import get_sequence_ring
from phantom_vlb_tpu_torch.core.remat import check_remat_policy, checkpoint_name, remat_context_fn
from phantom_vlb_tpu_torch.models.lora import (
    FrozenQuantDense,
    LoRAConfig,
    LoRALinear,
    adapter_dropout,
    row_parallel_linear,
    site_seed,
)
from phantom_vlb_tpu_torch.ops.context_parallel import ring_attention, ring_flash_attention
from phantom_vlb_tpu_torch.ops.flash_attention import attention_packed
from phantom_vlb_tpu_torch.ops.quant import sums_own_dx
from phantom_vlb_tpu_torch.ops.ring_fused import ring_flash_fused
from phantom_vlb_tpu_torch.parallel.tensor import ROW, copy_to_tensor

__all__ = ["MistralConfig", "MistralModel", "RMSNorm", "rope_tables", "apply_rope_packed",
           "ATTENTION_IMPLS", "set_attention_impl", "set_remat_policy"]

RING_ATTENTION = {"ring": ring_attention, "ring_flash": ring_flash_attention,
                  "ring_fused": ring_flash_fused}
ATTENTION_IMPLS = ("auto", *RING_ATTENTION)


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
    # Per-layer activation checkpointing while gradients are recorded, and
    # what each layer keeps from its forward (core/remat.py).
    remat: bool = True
    remat_policy: str = "nothing"
    # LoRA on every projection (the reference's targets); None disables.
    lora: LoRAConfig | None = None
    # The frozen base projections stored int8: 'int8' (weight-only), 'w8a8'
    # (int8 activations too, straight-through bf16 dx) or 'w8a8g8' (int8 dx
    # too); None keeps them in ``dtype``.
    base_quant: str | None = None
    # 'auto' (packed flash attention) or a ring: 'ring', 'ring_flash', 'ring_fused'.
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in {ATTENTION_IMPLS}")
        check_remat_policy(self.remat_policy)

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
            num_key_value_heads=2, head_dim=16, dtype=torch.float32, remat=False,
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


# Dropout sites of a layer: one seed each (the shared ones with shared_dropout).
SITES = {name: i for i, name in enumerate(
    ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
     "attn_input", "mlp_input"))}


def _proj(cfg: MistralConfig, in_features: int, out_features: int) -> nn.Module:
    """LoRALinear (adapters), FrozenQuantDense (an int8 base without
    adapters: the frozen-baseline regime) or a plain Linear."""
    if cfg.lora is not None:
        return LoRALinear(in_features, out_features, cfg.lora, cfg.dtype, base_quant=cfg.base_quant)
    if cfg.base_quant is not None:
        return FrozenQuantDense(in_features, out_features, cfg.base_quant, cfg.dtype)
    return nn.Linear(in_features, out_features, bias=False)


def _call_proj(module: nn.Module, name: str, x, seed, adapter_x=None, rows=None, base_x=None):
    """A projection, with its site's seed when it carries adapters;
    ``base_x`` the base product's input where it is not x."""
    if isinstance(module, LoRALinear):
        return module(x, None if seed is None else site_seed(seed, SITES[name]), adapter_x, rows, base_x)
    split = getattr(module, "tensor_split", None)
    if isinstance(module, nn.Linear) and split is not None and split.role == ROW:
        return row_parallel_linear(x, module.weight, split)
    return module(x if base_x is None else base_x)


def _base_input(cfg: MistralConfig, proj: nn.Module, x):
    """The column-parallel base products' input: x through
    :func:`copy_to_tensor` when ``proj`` is split over the ``tensor`` axis
    (and its base does not sum its own dx), else None (x itself)."""
    split = getattr(proj, "tensor_split", None)
    if split is None or sums_own_dx(cfg.base_quant):
        return None
    return copy_to_tensor(x, split)


def _shared_adapter_input(cfg: MistralConfig, training: bool, x, seed, site: str, rows=None):
    """One dropout mask for every adapter reading ``x`` (shared_dropout)."""
    lora = cfg.lora
    if lora is None or not lora.shared_dropout or not lora.dropout or not training or seed is None:
        return None
    return adapter_dropout(x, lora, site_seed(seed, SITES[site]), rows)


class MistralAttention(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = _proj(cfg, cfg.hidden_size, h * d)
        self.k_proj = _proj(cfg, cfg.hidden_size, hkv * d)
        self.v_proj = _proj(cfg, cfg.hidden_size, hkv * d)
        self.o_proj = _proj(cfg, h * d, cfg.hidden_size)

    def forward(self, x, rope, kv_mask=None, seed=None, rows=None):
        cfg = self.cfg
        xa = _shared_adapter_input(cfg, self.training, x, seed, "attn_input", rows)
        xb = _base_input(cfg, self.q_proj, x)
        # This rank's heads (all of them on one card), by the widths.
        q = _call_proj(self.q_proj, "q_proj", x, seed, xa, rows, xb)
        h = q.shape[-1] // cfg.head_dim
        q = apply_rope_packed(q, rope, h)
        k = _call_proj(self.k_proj, "k_proj", x, seed, xa, rows, xb)
        hkv = k.shape[-1] // cfg.head_dim
        k = apply_rope_packed(k, rope, hkv)
        v = _call_proj(self.v_proj, "v_proj", x, seed, xa, rows, xb)
        if cfg.attention_impl == "auto":
            out, _ = attention_packed(q, k, v, h, hkv, kv_mask=kv_mask)
        else:
            ring = RING_ATTENTION[cfg.attention_impl]
            out = ring(q, k, v, h, hkv, get_sequence_ring(), kv_mask=kv_mask)
        out = checkpoint_name(out, "attn_out")
        return _call_proj(self.o_proj, "o_proj", out, seed, rows=rows)


class MistralMLP(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = _proj(cfg, cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, seed=None, rows=None):
        xa = _shared_adapter_input(self.cfg, self.training, x, seed, "mlp_input", rows)
        xb = _base_input(self.cfg, self.gate_proj, x)
        gate = _call_proj(self.gate_proj, "gate_proj", x, seed, xa, rows, xb)
        up = _call_proj(self.up_proj, "up_proj", x, seed, xa, rows, xb)
        return _call_proj(self.down_proj, "down_proj", F.silu(gate) * up, seed, rows=rows)


class MistralDecoderLayer(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MistralAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MistralMLP(cfg)

    def forward(self, x, rope, kv_mask=None, seed=None, rows=None):
        """``seed``: this layer's dropout seed (None: no adapter dropout);
        ``rows``: the global batch rows x holds (``models/lora.py``)."""
        h = x + self.self_attn(self.input_layernorm(x), rope, kv_mask, seed, rows)
        return h + self.mlp(self.post_attention_layernorm(h), seed, rows)


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

    def forward(self, inputs_embeds: torch.Tensor, kv_mask: torch.Tensor | None = None,
                seed: int | None = None, rows: tuple[int, int] | None = None):
        """(B, S, E) embeddings + (B, S) kv mask -> post-final-norm (B, S, E).

        ``seed``: the step's dropout seed; layer i draws from
        ``site_seed(seed, i)``. None (or eval mode) means no adapter dropout.
        ``rows``: the global batch rows the input holds (``models/lora.py``).
        """
        cfg = self.cfg
        s = inputs_embeds.shape[1]
        # (1, S) identity positions: the tables broadcast over the batch.
        positions = torch.arange(s, device=inputs_embeds.device)[None]
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x = inputs_embeds.to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = remat_context_fn(cfg.remat_policy) if remat else None
        for i, layer in enumerate(self.layers):
            layer_seed = None if seed is None else site_seed(seed, i)
            if remat:
                x = checkpoint(layer, x, rope, kv_mask, layer_seed, rows, use_reentrant=False,
                               context_fn=context_fn)
            else:
                x = layer(x, rope, kv_mask, layer_seed, rows)
        return self.norm(x)


def _replace_mistral(model: nn.Module, **changes) -> None:
    """Replace fields of every :class:`MistralConfig` that a module of
    ``model`` carries (as ``.cfg``, or as ``.cfg.mistral``), in place."""
    for module in model.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, MistralConfig):
            module.cfg = dataclasses.replace(cfg, **changes)
        elif isinstance(getattr(cfg, "mistral", None), MistralConfig):
            module.cfg = dataclasses.replace(
                cfg, mistral=dataclasses.replace(cfg.mistral, **changes))


def set_attention_impl(model: nn.Module, impl: str) -> None:
    """Switch every module of ``model`` that carries a :class:`MistralConfig`
    (or a config holding one as ``.mistral``) to ``impl``, in place; the
    weights are untouched."""
    _replace_mistral(model, attention_impl=impl)


def set_remat_policy(model: nn.Module, policy: str) -> None:
    """Switch ``model``'s decoder to the checkpoint ``policy``, in place, as
    :func:`set_attention_impl` does; the weights are untouched."""
    _replace_mistral(model, remat_policy=policy)
