"""Optimizer, schedule and clip: the reference's recipe.

Counterpart of ``phantom_vlb_tpu/train/optim.py`` (:26-77): AdamW over the
trainable tensors only (lr 1e-4, betas 0.9/0.999, eps 1e-8, weight decay
1e-2), torch's periodic cosine ``lr * (1 + cos(pi t / T_max)) / 2`` stepped
per update and not clamped past ``t_max``, and a global-norm clip at 1.0 by
optax's formula (scale ``max / |g|`` when ``|g| >= max``; no ``+1e-6`` as
``clip_grad_norm_`` adds). :class:`AdamWCosine` is optax's chain as one
object; ``torch.optim.AdamW`` does the update (the JAX side has no Pallas
kernel there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import torch

__all__ = ["OptimConfig", "AdamWCosine", "learning_rate", "clip_by_global_norm_"]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-2
    lr_scheduler_name: str = "CosineAnnealingLR"
    t_max: int = 50_000
    grad_clip: float = 1.0


def learning_rate(config: OptimConfig, step: int) -> float:
    """The rate of update ``step`` (0-based), as the reference's schedule."""
    if config.lr_scheduler_name == "CosineAnnealingLR":
        return config.lr * (1.0 + math.cos(math.pi * step / config.t_max)) / 2.0
    if config.lr_scheduler_name in ("constant", "ConstantLR"):
        return config.lr
    raise ValueError(f"unknown scheduler {config.lr_scheduler_name!r}")


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / |g|`` when the global norm
    ``|g| >= max_norm``; returns ``|g|`` (f32, on the grads' device)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class AdamWCosine:
    """Clip, AdamW and the cosine schedule over ``params``; ``step`` counts
    the updates applied (a skipped update leaves it and the state as they
    were)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: OptimConfig = OptimConfig()):
        self.params = list(params)
        self.config = config
        self.step = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=learning_rate(config, 0), betas=config.betas, eps=config.eps,
            weight_decay=config.weight_decay,
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def clip_(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before it.
        A parameter the loss did not reach gets a zero gradient, so weight
        decay still applies to it, as in the reference."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return clip_by_global_norm_([p.grad for p in self.params], self.config.grad_clip)

    def apply(self) -> float:
        """One AdamW update at this step's rate; returns the rate."""
        lr = learning_rate(self.config, self.step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.step += 1
        return lr

    def state_dict(self) -> dict:
        """The update count and AdamW's state (moments and per-tensor step
        counts), so that a resumed run continues the schedule and the
        moments."""
        return {"step": self.step, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.adamw.load_state_dict(state["adamw"])
