"""Optimizer, schedule and clip: the reference's recipe.

Counterpart of ``phantom_vlb_tpu/train/optim.py`` (:26-77): AdamW over the
trainable tensors only (lr 1e-4, betas 0.9/0.999, eps 1e-8, weight decay
1e-2), torch's periodic cosine ``lr * (1 + cos(pi t / T_max)) / 2`` stepped
per update and not clamped past ``t_max``, and a global-norm clip at 1.0 by
optax's formula (scale ``max / |g|`` when ``|g| >= max``; no ``+1e-6`` as
``clip_grad_norm_`` adds). :class:`AdamWCosine` is optax's chain as one
object; ``torch.optim.AdamW`` does the update (the JAX side has no Pallas
kernel there).

The global norm is optax's ``sqrt(sum of each tensor's sum of squares)``.
Under a sharded mesh the gradients are FSDP2 shards (``DTensor``s): each
rank sums the squares of its shards and the sums are added over the
``fsdp`` axis, and those of tensors split along ``tensor`` over that axis
too (a tensor whole on every ``tensor`` rank counted once), so every rank
clips by the one-card norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import torch

from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.parallel.sharding import shard_like, tensor_split_of, whole

__all__ = ["OptimConfig", "AdamWCosine", "learning_rate", "global_norm", "clip_by_global_norm_", "local_part"]


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


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view that writes through), or
    the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _squares(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([local_part(g).float().contiguous().square().sum() for g in grads]).sum()


def global_norm(grads: list[torch.Tensor], mesh: MeshEnv | None = None,
                split: list[bool] | None = None) -> torch.Tensor:
    """``sqrt`` of the sum over ``grads`` of each one's f32 sum of squares
    (its row-major elements in order, whatever its strides); under a mesh,
    of this rank's shards, summed over the ``fsdp`` axis, and over
    ``tensor`` for the grads that ``split`` marks as split along it."""
    if mesh is None or not split or not any(split):
        squares = _squares(grads)
        return (squares if mesh is None else mesh.shard_sum(squares)).sqrt()
    whole_ = [g for g, s in zip(grads, split) if not s]
    parts = mesh.shard_sum(_squares([g for g, s in zip(grads, split) if s]), over_tensor=True)
    return (parts + mesh.shard_sum(_squares(whole_)) if whole_ else parts).sqrt()


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         mesh: MeshEnv | None = None, split: list[bool] | None = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / |g|`` when the global norm
    ``|g| >= max_norm``; returns ``|g|`` (f32, on the grads' device)."""
    norm = global_norm(grads, mesh, split)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        local_part(g).mul_(scale.to(g.dtype))
    return norm


class AdamWCosine:
    """Clip, AdamW and the cosine schedule over ``params``; ``step`` counts
    the updates applied (a skipped update leaves it and the state as they
    were). ``mesh``: the mesh the parameters are sharded over, if any."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: OptimConfig = OptimConfig(),
                 mesh: MeshEnv | None = None):
        self.params = list(params)
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.sharded else None
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
        return clip_by_global_norm_([p.grad for p in self.params], self.config.grad_clip, self.mesh,
                                    [tensor_split_of(p) is not None for p in self.params])

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
        moments; sharded moments gathered whole on every rank (a
        collective), in the one-process layout."""
        state = self.adamw.state_dict()
        state["state"] = {i: {k: whole(v, self.params[int(i)]) for k, v in s.items()}
                          for i, s in state["state"].items()}
        return {"step": self.step, "adamw": state}

    def load_state_dict(self, state: dict) -> None:
        """Take :meth:`state_dict`'s layout, written at any world size and
        read onto any device: each rank keeps its shard of every moment of a
        sharded parameter, and the per-tensor step counts go to the host,
        where AdamW keeps them."""
        self.step = int(state["step"])
        adamw = dict(state["adamw"])
        adamw["state"] = {int(i): {k: v.cpu() if k == "step" else shard_like(v, self.params[int(i)])
                                   for k, v in s.items()}
                          for i, s in adamw["state"].items()}
        self.adamw.load_state_dict(adamw)

