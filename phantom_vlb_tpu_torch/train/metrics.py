"""Streaming per-ROI Pearson r (running moments, batch-merged on the device).

Counterpart of ``pearson_init/update/compute`` in
``phantom_vlb_tpu/train/metrics.py`` (:45-99): a Welford-style batch merge in
f32, aware of padded rows, so no activation-sized host transfer is needed.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PearsonState", "pearson_init", "pearson_update", "pearson_compute"]


@dataclasses.dataclass
class PearsonState:
    """Running first/second moments per ROI (all (P,) except the scalar n)."""

    n: torch.Tensor
    mean_x: torch.Tensor
    mean_y: torch.Tensor
    m2x: torch.Tensor
    m2y: torch.Tensor
    cxy: torch.Tensor


def pearson_init(num_target: int, device="cpu") -> PearsonState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return PearsonState(n=z(), mean_x=z(num_target), mean_y=z(num_target),
                        m2x=z(num_target), m2y=z(num_target), cxy=z(num_target))


def pearson_update(
    state: PearsonState,
    preds: torch.Tensor,                  # (B, P)
    targets: torch.Tensor,                # (B, P)
    row_mask: torch.Tensor | None = None,  # (B,)
) -> PearsonState:
    """Merge one batch into the running moments; an empty batch changes nothing."""
    x = torch.nan_to_num(preds.to(state.mean_x.dtype))
    y = torch.nan_to_num(targets.to(state.mean_y.dtype))
    if row_mask is None:
        row_mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    m = row_mask.to(x.dtype)[:, None]

    nb = m.sum()
    safe_nb = nb.clamp_min(1.0)
    mean_xb = (x * m).sum(0) / safe_nb
    mean_yb = (y * m).sum(0) / safe_nb
    dxb = (x - mean_xb) * m
    dyb = (y - mean_yb) * m

    n_new = state.n + nb
    safe_n_new = n_new.clamp_min(1.0)
    delta_x = mean_xb - state.mean_x
    delta_y = mean_yb - state.mean_y
    corr = state.n * nb / safe_n_new
    merged = PearsonState(
        n=n_new,
        mean_x=state.mean_x + delta_x * nb / safe_n_new,
        mean_y=state.mean_y + delta_y * nb / safe_n_new,
        m2x=state.m2x + (dxb * dxb).sum(0) + delta_x * delta_x * corr,
        m2y=state.m2y + (dyb * dyb).sum(0) + delta_y * delta_y * corr,
        cxy=state.cxy + (dxb * dyb).sum(0) + delta_x * delta_y * corr,
    )
    keep = nb > 0
    return PearsonState(**{
        f.name: torch.where(keep, getattr(merged, f.name), getattr(state, f.name))
        for f in dataclasses.fields(PearsonState)
    })


def pearson_compute(state: PearsonState, eps: float = 1e-12) -> torch.Tensor:
    """Per-ROI correlation r (P,)."""
    return state.cxy / torch.sqrt((state.m2x * state.m2y).clamp_min(eps))
