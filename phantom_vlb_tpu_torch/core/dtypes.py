"""Mixed-precision dtype policy, with torch dtypes.

Counterpart of ``phantom_vlb_tpu/core/dtypes.py``: the backbone's
parameters and activations in bf16, the brain readout head, the loss and
the Pearson metrics in float32.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DtypePolicy", "POLICIES"]


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32      # master params
    compute_dtype: torch.dtype = torch.bfloat16   # backbone matmuls/activations
    head_dtype: torch.dtype = torch.float32       # readout head + loss
    metric_dtype: torch.dtype = torch.float32

    def cast_compute(self, x):
        return torch.as_tensor(x).to(self.compute_dtype)

    def cast_head(self, x):
        return torch.as_tensor(x).to(self.head_dtype)


POLICIES = {
    "bf16_mixed": DtypePolicy(),
    "f32": DtypePolicy(compute_dtype=torch.float32),
    # Fully bf16 (closest to the reference's literal behavior).
    "bf16": DtypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                        head_dtype=torch.bfloat16),
}
