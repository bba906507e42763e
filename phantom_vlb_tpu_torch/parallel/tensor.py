"""The ``tensor`` axis across processes: the decoder's projections split Megatron's way.

Counterpart of the ``tensor`` entries of the JAX rule table
(``phantom_vlb_tpu/parallel/sharding.py:39-55``), which GSPMD turns into
collectives; here they are written out. A decoder layer's q/k/v/gate/up
projections are column-parallel (each ``tensor`` rank holds a block of
output channels: its heads, its part of the MLP's width) and o/down are
row-parallel (each rank holds the matching block of input channels), so
a layer runs two reductions forward and two backward:

- :func:`copy_to_tensor`, the identity forward whose backward sums the
  gradient over the ranks, at the attention and MLP inputs of the
  column-parallel base products (and on a column-parallel adapter's
  rank-r mid, whose output block B is split: its gradient is a partial sum);
- :func:`reduce_from_tensor`, the sum over the ranks forward whose
  backward is the identity, after the row-parallel products (and on a
  row-parallel adapter's mid, whose input block A is split).

Every tensor rank of a batch coordinate runs the same loss on the same
rows, so each replicated tensor (norms, the head, a column-parallel
``lora_a``, a row-parallel ``lora_b``) gets the one-card gradient on every
rank, and no gradient is reduced over ``tensor`` after the backward.

The collectives are ``torch.distributed._functional_collectives``: out of
place and seen by the dispatcher, so a selective checkpoint policy sees
them (``core/remat.py``) and a layer's replay runs them again, as XLA's
remat does. :func:`all_reduce_max` and :func:`all_reduce_sum` (no
gradient) serve the int8 bases (``ops/quant.py``): a row's quantization
scale is the maximum over its ranks' columns, and int32 partial products
add exactly.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TensorSplit", "copy_to_tensor", "reduce_from_tensor", "all_reduce_max", "all_reduce_sum",
           "gather_along", "mm_f32", "COLUMN", "ROW"]

COLUMN, ROW = "column", "row"


@dataclasses.dataclass(frozen=True, eq=False)
class TensorSplit:
    """How one projection lies over the ``tensor`` ranks: ``role`` COLUMN
    (its output channels split) or ROW (its input channels split), the
    axis's process group, its size and this rank's index along it."""

    role: str
    group: object
    size: int
    rank: int

    def cols(self, k: int) -> tuple[int, int]:
        """(first global input column, global input width) of a row-parallel
        input that holds ``k`` columns on each rank."""
        return self.rank * k, self.size * k


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, group))


def all_reduce_max(t: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """``t``'s maximum over the ``tensor`` ranks (a new tensor)."""
    return _all_reduce(t, "max", split.group)


def all_reduce_sum(t: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """``t`` summed over the ``tensor`` ranks (a new tensor; exact for ints)."""
    return _all_reduce(t, "sum", split.group)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, "sum", ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tensor(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """x itself; its gradient summed over the ``tensor`` ranks."""
    return _CopyToTensor.apply(x, split.group)


def reduce_from_tensor(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """x summed over the ``tensor`` ranks; its gradient passed through."""
    return _ReduceFromTensor.apply(x, split.group)


def gather_along(t: torch.Tensor, dim: int, split: TensorSplit) -> torch.Tensor:
    """Every ``tensor`` rank's ``t`` joined along ``dim``, in rank order (a
    collective)."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t.contiguous(), group=split.group)
    return torch.cat(parts, dim)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., K), b (K, N)) summed and returned in f32: the
    partial product of a row-parallel projection, whose partials are added
    over the ranks in f32 and rounded once. A bf16 pair on the card is one
    cuBLAS product with an f32 output; elsewhere the operands are widened
    (exactly) first."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(*a.shape[:-1], -1)
    return a.float() @ b.float()
