"""Brain readout head: LN -> HRF pooling -> LN -> dropout -> ridge, in f32.

Counterpart of ``phantom_vlb_tpu/models/heads.py``. The head runs in f32
whatever the backbone's dtype. Dropout is live in train mode, with its mask
drawn from the seed the caller passes (the VLB model passes one derived
from the step's seed), over the global batch when the input holds a rank's
rows of it (``rows``, :func:`~phantom_vlb_tpu_torch.models.lora.keep_rows`),
and the identity otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from phantom_vlb_tpu_torch.models.lora import keep_rows

__all__ = ["BrainReadoutHead", "RidgeHead"]

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class RidgeHead(nn.Module):
    """Linear map to parcels with an L2 weight penalty."""

    def __init__(self, hidden_size: int, num_target: int, l2_lambda: float = 0.001):
        super().__init__()
        self.l2_lambda = l2_lambda
        self.linear = nn.Linear(hidden_size, num_target, dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        w = self.linear.weight
        return self.linear(x), self.l2_lambda * w.float().square().sum()


class BrainReadoutHead(nn.Module):
    def __init__(self, hidden_size: int, num_target: int, l2_lambda: float = 0.001,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS, dtype=torch.float32)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS, dtype=torch.float32)
        self.dropout_rate = dropout_rate
        self.ridge = RidgeHead(hidden_size, num_target, l2_lambda)

    def forward(self, hidden_states: torch.Tensor, weight_mask: torch.Tensor,
                seed: int | None = None, rows: tuple[int, int] | None = None):
        """(B, S, E) hidden states, (B, S) HRF weights -> (preds (B, P), l2)."""
        h = self.layer_norm1(hidden_states.float())
        pooled = torch.einsum("bse,bs->be", h, weight_mask.float())
        pooled = self.layer_norm2(pooled)
        p = self.dropout_rate
        if self.training and p > 0 and seed is not None:
            gen = torch.Generator(device=pooled.device).manual_seed(seed)
            keep = keep_rows(pooled, rows, lambda shape: torch.rand(
                shape, generator=gen, device=pooled.device) < 1.0 - p)
            pooled = torch.where(keep, pooled / (1.0 - p), 0.0)
        return self.ridge(pooled)
