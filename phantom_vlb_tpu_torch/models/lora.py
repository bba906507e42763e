"""LoRA adapters on a frozen bf16 base projection.

Counterpart of ``phantom_vlb_tpu/models/lora.py`` (``LoRAConfig`` :37-78,
``adapter_dropout`` :80-98, ``LoRADense`` :101-221, ``is_lora_path``,
``lora_merge``)::

    y = x @ W^T  (frozen)  +  scaling * (dropout(x) @ A) @ B

``lora_a`` (in, r) is he-uniform and ``lora_b`` (r, out) zeros, both f32
masters cast to the compute dtype at use (the reference's
``param_dtype=f32``). The fused branch (``fused_dropout``, in training,
p > 0) runs :func:`~phantom_vlb_tpu_torch.ops.lora_fused.fused_dropout_matmul`:
its kernels on the card, its plain version on the CPU.

Dropout masks come only from an explicit per-site seed (an int the caller
derives from the step, the layer and the site), never from a global RNG
state: a per-layer ``torch.utils.checkpoint`` replays the layer in the
backward, and a mask drawn from generator state would differ on the replay.
The int8 base modes and the fused epilogue come with a later slice of the
port and raise here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from phantom_vlb_tpu_torch.ops.lora_fused import dropout_threshold, fused_dropout_matmul

__all__ = ["LoRAConfig", "LoRALinear", "adapter_dropout", "is_lora_path", "lora_merge", "site_seed"]

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16          # lora.yaml:28 (r=16)
    alpha: float = 32.0     # lora.yaml:29
    dropout: float = 0.1    # lora.yaml:30
    shared_dropout: bool = False
    dropout_bits: int = 32  # 32: exact Bernoulli; 8: u8 threshold (keep 1 - round(256p)/256)
    fused_dropout: bool = False
    fused_epilogue: str = ""

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @property
    def dropout_keep_prob(self) -> float:
        if self.dropout_bits >= 32:
            return 1.0 - self.dropout
        n = 1 << self.dropout_bits
        return 1.0 - round(self.dropout * n) / n


def site_seed(seed: int, *parts: int) -> int:
    """A 32-bit seed for one dropout site from a step seed and integer parts
    (layer, site, ...): a splitmix-style mix, the same on every call."""
    h = seed & _U32
    for p in parts:
        h = (h ^ ((p + 0x9E3779B9 + (h << 6) + (h >> 2)) & _U32)) & _U32
        h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _U32
        h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _U32
        h ^= h >> 16
    return h


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: multiplying a tensor of that dtype by
    it rounds the exact product once, as the reference's product of two
    values of that dtype does (and needs no tensor on the device)."""
    return float(torch.tensor(value, dtype=dtype))


def adapter_dropout(x: torch.Tensor, cfg: LoRAConfig, seed: int) -> torch.Tensor:
    """Adapter-input dropout from the site ``seed`` (training path).

    ``dropout_bits=32``: keep ~ Bernoulli(1 - p), survivors / (1 - p);
    ``dropout_bits=8``: u8 bytes, keep iff byte >= round(256 p), survivors /
    (1 - round(256 p)/256). The scale is in x's dtype, as the reference's.
    """
    gen = _generator(seed, x.device)
    if cfg.dropout_bits >= 32:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < cfg.dropout_keep_prob
    elif cfg.dropout_bits == 8:
        bits = torch.randint(0, 256, x.shape, generator=gen, device=x.device, dtype=torch.uint8)
        keep = bits >= dropout_threshold(cfg.dropout)[0]
    else:
        raise ValueError(f"dropout_bits must be 8 or 32, not {cfg.dropout_bits}")
    return torch.where(keep, x / _in_dtype(cfg.dropout_keep_prob, x.dtype), 0.0)


class LoRALinear(nn.Module):
    """A frozen ``nn.Linear``-shaped base (``weight`` (out, in), compute
    dtype) with f32 ``lora_a`` (in, r) and ``lora_b`` (r, out)."""

    def __init__(self, in_features: int, out_features: int, lora: LoRAConfig,
                 dtype: torch.dtype = torch.bfloat16, quantized: bool = False):
        super().__init__()
        if quantized or lora.fused_epilogue:
            raise NotImplementedError(
                "the int8 base modes and the fused LoRA epilogue come with slice 3 of the port"
            )
        self.lora = lora
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype),
                                   requires_grad=False)
        self.lora_a = nn.Parameter(torch.empty(in_features, lora.rank, dtype=torch.float32))
        self.lora_b = nn.Parameter(torch.zeros(lora.rank, out_features, dtype=torch.float32))
        if not self.weight.is_meta:
            bound = math.sqrt(6.0 / in_features)            # flax he_uniform, fan_in = in
            nn.init.uniform_(self.lora_a, -bound, bound)

    def forward(self, x: torch.Tensor, seed: int | None = None,
                adapter_x: torch.Tensor | None = None) -> torch.Tensor:
        """``seed`` is the site's dropout seed (None: no dropout);
        ``adapter_x`` a pre-dropped adapter input (shared dropout)."""
        lora, dtype = self.lora, self.weight.dtype
        y = F.linear(x, self.weight)
        a = self.lora_a.to(dtype)
        live = self.training and lora.dropout > 0 and seed is not None
        if adapter_x is None and live and lora.fused_dropout:
            x2d = x.reshape(-1, x.shape[-1])
            z = fused_dropout_matmul(x2d, a, seed, lora.dropout).reshape(*x.shape[:-1], lora.rank)
        else:
            z = x if adapter_x is None else adapter_x
            if adapter_x is None and live:
                z = adapter_dropout(z, lora, seed)
            z = z @ a
        z = z @ self.lora_b.to(dtype)
        return y + z * _in_dtype(lora.scaling, dtype)


def is_lora_path(path: str) -> bool:
    """Adapter selector for trainable parameters and adapter-only exports."""
    return "lora_a" in path or "lora_b" in path


def lora_merge(state_dict: dict, scaling: float) -> dict:
    """Fold adapters into base weights (W^T <- W^T + scaling * A B) for export;
    the result has no ``lora_a``/``lora_b`` entries."""
    out = {k: v for k, v in state_dict.items() if not is_lora_path(k)}
    for key in state_dict:
        if key.endswith(".lora_a"):
            base = key[: -len(".lora_a")]
            a, b = state_dict[key].float(), state_dict[base + ".lora_b"].float()
            w = state_dict[base + ".weight"]
            out[base + ".weight"] = (w.float() + scaling * (a @ b).T).to(w.dtype)
    return out
