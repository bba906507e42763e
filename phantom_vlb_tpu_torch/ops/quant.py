"""Int8 frozen-base projections: weight quantization and the three int8 matmuls.

Counterpart of ``phantom_vlb_tpu/ops/quant.py`` (``quantize_int8`` :34,
``int8_matmul`` :47, ``int8_matmul_w8a8`` :102-156, ``int8_matmul_w8a8g8``
:159-204, ``quantize_tree`` :207). The frozen base is int8 with one f32
scale per output channel; scales commute out of the contraction, so the
dequantized matrix is never formed:

- ``int8_matmul``: ``(x @ q) * scale`` in the compute dtype (weight-only);
- ``int8_matmul_w8a8``: per-row int8 activations (``row_quant``), an
  int8 x int8 -> int32 product, ``(y * s_x) * scale`` in f32, then the
  dtype; the backward is the straight-through bf16
  ``((dy * scale).bf16) @ q.bf16^T``;
- ``int8_matmul_w8a8g8``: the same forward; the backward quantizes
  ``dy * scale`` per row (``row_quant_scaled``) and runs an int8 dx
  product scaled by ``s_g``.

``q`` is (in, out) at these functions, as in the JAX package; it may be a
transposed view of the (out, in) tensor a module stores (see
``models/lora.py``).

With ``split`` (a :class:`~phantom_vlb_tpu_torch.parallel.tensor.TensorSplit`)
q holds this ``tensor`` rank's block. Column-parallel (q's out columns
split) the products are the one-card ones on the rank's columns, and x's
gradient is a partial sum that the layer's input sums over the ranks,
except under w8a8g8: dy's row scale is the maximum over the ranks'
columns (:func:`~phantom_vlb_tpu_torch.ops.rowquant.row_quant_split`) and
the int32 dx partials are summed before the dequant, so dx is the
one-card dx on every rank. Row-parallel (q's in rows split, x holding the
rank's columns): the weight-only product sums f32 partials and rounds
once; w8a8 quantizes x with the whole row's scale and sums the int32
partials before the dequant, so the product is the one-card product bit
for bit; dx is the rank's columns of the one-card dx. The int32 product is ``torch._int_mm`` on the card (the
JAX package leaves it to ``lax.dot_general``, outside any Pallas kernel)
and an exact float64 product on the CPU: ``14336 * 127^2 < 2^31``, so
nothing overflows, and f64 holds every partial sum exactly.
"""

from __future__ import annotations

import torch

from phantom_vlb_tpu_torch.core.remat import OPAQUE, named
from phantom_vlb_tpu_torch.ops.rowquant import over_127, row_quant, row_quant_scaled, row_quant_split
from phantom_vlb_tpu_torch.parallel.tensor import COLUMN, ROW, all_reduce_max, all_reduce_sum, mm_f32

__all__ = [
    "quantize_int8", "int8_matmul", "int8_matmul_w8a8", "int8_matmul_w8a8g8", "quant_matmul",
    "quantize_state_dict", "is_base_projection", "sums_own_dx", "BASE_QUANT_MODES", "BASE_PROJECTIONS",
    "TOWER_PROJECTIONS",
]

BASE_QUANT_MODES = ("int8", "w8a8", "w8a8g8")
# The projections a quantized config stores as int8: the targets of the JAX
# package's ``load_pretrained_params`` for a quantized Mistral, and for the
# vision tower (``phantom_vlb_tpu/train/builder.py:216-229``).
BASE_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
TOWER_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def quantize_int8(w: torch.Tensor, axis: int = 0):
    """Per-channel symmetric int8 on ``w``'s device: (q int8, scale f32).

    ``axis`` is the contraction (input) axis; scales are per output channel
    (that axis squeezed out), and a zero channel gets scale 1.0. Bit-equal to
    the numpy original on the same f32 values.
    """
    w = w.float()
    scale = over_127(w.abs().amax(dim=axis, keepdim=True))
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (M, K) and (K, N).

    On the card both operands go in K-contiguous (b as the transpose of an
    (N, K) row-major tensor, cuBLAS's "TN" form): ``torch._int_mm`` runs the
    other layouts about 7x slower (``chip_smoke.py`` phase 11 times each
    layout), so b is copied into that form when it is not in it. The
    (out, in) weights a module stores give the forward's b in that form;
    the w8a8g8 dx, which contracts over out, pays one transpose of the
    weight per call (PERF.md, slice 3).
    """
    if a.device.type == "cuda":
        return torch._int_mm(a, b.t().contiguous().t())
    return (a.double() @ b.double()).to(torch.int32)


# The Functions below keep the frozen q and scale on ctx, not as saved
# tensors: the products then save nothing, so a checkpointed layer's replay,
# which stops at the last saved tensor, never runs a base product that only
# the layer's output needs (``models/lora.py``). The int8 backward converts q
# again rather than keep a bf16 copy of the weight.


def _role(split) -> str | None:
    return None if split is None else split.role


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, dtype, split):
        ctx.q, ctx.scale, ctx.x_dtype, ctx.dtype = q, scale, x.dtype, dtype
        if _role(split) == ROW:
            y = all_reduce_sum(mm_f32(x.to(dtype), q.to(dtype)), split).to(dtype)
        else:
            y = x.to(dtype) @ q.to(dtype)
        return y * scale.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        g = dy * ctx.scale.to(ctx.dtype)
        return (g @ ctx.q.to(ctx.dtype).t()).to(ctx.x_dtype), None, None, None, None


def int8_matmul(x, q, scale, dtype=torch.bfloat16, split=None):
    """``x @ dequant(q)``: the product in ``dtype``, then the scale in ``dtype``."""
    return _Int8.apply(x, q, scale, dtype, split)


def _w8a8_forward(x, q, scale, dtype, split):
    """Per-row int8 x, int8 x int8 -> int32, then ``(y * s_x) * scale``;
    in the scope whose products the ``'dots'`` checkpoint policy leaves to
    the replay, as JAX's leaves its ``custom_vjp``'s (``core/remat.py``)."""
    lead, k = x.shape[:-1], x.shape[-1]
    with named(OPAQUE):
        x2 = x.reshape(-1, k).contiguous()
        if _role(split) == ROW:
            x8, s_x = row_quant_split(x2, lambda m: all_reduce_max(m, split))
            y = all_reduce_sum(_int_mm(x8, q), split)
        else:
            x8, s_x = row_quant(x2)
            y = _int_mm(x8, q)
        return (y * s_x).mul_(scale).to(dtype).reshape(*lead, q.shape[1])


class _W8A8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, dtype, split):
        ctx.q, ctx.scale, ctx.x_dtype = q, scale, x.dtype
        return _w8a8_forward(x, q, scale, dtype, split)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        q, scale = ctx.q, ctx.scale
        # Straight-through: round() is the identity, so dx is the exact bf16
        # dequant backward, as the reference's (quant.py:131-145).
        dyb = (dy.float() * scale).to(torch.bfloat16)
        return (dyb @ q.to(torch.bfloat16).t()).to(ctx.x_dtype), None, None, None, None


class _W8A8G8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, dtype, split):
        ctx.q, ctx.scale, ctx.x_dtype, ctx.split = q, scale, x.dtype, split
        return _w8a8_forward(x, q, scale, dtype, split)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        q, scale, split = ctx.q, ctx.scale, ctx.split
        lead, n = dy.shape[:-1], dy.shape[-1]
        # The weight scale rides the contracted axis here, so it is folded
        # into dy before the per-row quant (quant.py:173-179).
        dy2 = dy.reshape(-1, n).contiguous()
        if _role(split) == COLUMN:
            g8, s_g = row_quant_split(dy2, lambda m: all_reduce_max(m, split), scale)
            dx = all_reduce_sum(_int_mm(g8, q.t()), split)
        else:
            g8, s_g = row_quant_scaled(dy2, scale)
            dx = _int_mm(g8, q.t())
        return (dx * s_g).to(ctx.x_dtype).reshape(*lead, q.shape[0]), None, None, None, None


def int8_matmul_w8a8(x, q, scale, dtype=torch.bfloat16, split=None):
    """``dequant(quant(x) @ q)``, differentiable in x (straight-through bf16 dx)."""
    return _W8A8.apply(x, q, scale, dtype, split)


def int8_matmul_w8a8g8(x, q, scale, dtype=torch.bfloat16, split=None):
    """The w8a8 forward with an int8 dx product (``base_quant='w8a8g8'``)."""
    return _W8A8G8.apply(x, q, scale, dtype, split)


def sums_own_dx(mode: str | None) -> bool:
    """Whether a column-parallel base of ``mode`` sums x's gradient over
    the ``tensor`` ranks itself (w8a8g8's int32 dx), so that its input must
    not go through the layer's :func:`copy_to_tensor`."""
    return mode == "w8a8g8"


def quant_matmul(mode: str, x, q, scale, dtype, split=None):
    """The matmul ``base_quant`` selects: ``'int8'``, ``'w8a8'`` or
    ``'w8a8g8'``; ``split`` this rank's block of a ``tensor``-split base."""
    if mode == "int8":
        return int8_matmul(x, q, scale, dtype, split)
    if mode == "w8a8":
        return int8_matmul_w8a8(x, q, scale, dtype, split)
    if mode == "w8a8g8":
        return int8_matmul_w8a8g8(x, q, scale, dtype, split)
    raise ValueError(f"base_quant must be one of {BASE_QUANT_MODES}, not {mode!r}")


def is_base_projection(key: str, w: torch.Tensor) -> bool:
    """The JAX weight loader's predicate: a 2-D projection weight of the
    decoder (``model.``) or of the vision tower (``vision_tower.``)."""
    if not (key.endswith(".weight") and w.dim() == 2):
        return False
    if key.startswith("vision_tower."):
        return any(f".{t}." in key for t in TOWER_PROJECTIONS)
    return key.startswith("model.") and any(t in key for t in BASE_PROJECTIONS)


def quantize_state_dict(sd: dict, should_quantize=is_base_projection) -> dict:
    """Replace each selected ``<name>.weight`` (out, in) by ``<name>.weight_q``
    int8 (out, in) and ``<name>.weight_scale`` f32 (out,), in place, on each
    weight's own device, and return ``sd``.

    Counterpart of ``quantize_tree`` (its ``kernel`` (in, out) becomes
    ``kernel_q``/``kernel_scale``; this package stores the transpose). Each
    weight is popped before the next is quantized, so a dict that holds the
    only reference frees the bf16 weights one by one: a full-width model is
    quantized on its card with one projection's f32 copy of headroom. Pass a
    copy (``dict(sd)``) to keep the original.
    """
    for key in [k for k, v in sd.items() if should_quantize(k, v)]:
        w = sd.pop(key)
        q, s = quantize_int8(w, axis=1)
        del w
        base = key[: -len("weight")]
        sd[base + "weight_q"], sd[base + "weight_scale"] = q, s
    return sd
