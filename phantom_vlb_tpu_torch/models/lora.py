"""LoRA adapters on a frozen bf16 base projection.

Counterpart of ``phantom_vlb_tpu/models/lora.py`` (``LoRAConfig`` :37-78,
``adapter_dropout`` :80-98, ``LoRADense`` :101-221, ``FrozenQuantDense``
:224-272 with its optional bias, ``is_lora_path``, ``lora_merge``)::

    y = x @ W^T  (frozen)  +  scaling * (dropout(x) @ A) @ B

``lora_a`` (in, r) is he-uniform and ``lora_b`` (r, out) zeros, both f32
masters cast to the compute dtype at use (the reference's
``param_dtype=f32``). The fused branch (``fused_dropout``, in training,
p > 0) runs :func:`~phantom_vlb_tpu_torch.ops.lora_fused.fused_dropout_matmul`:
its kernels on the card, its plain version on the CPU. ``fused_epilogue``
(``'pallas'``, or ``'fwd'`` for the kernel forward with library dz and dB)
runs ``y + scaling * (z @ B)`` through
:func:`~phantom_vlb_tpu_torch.ops.lora_epilogue.lora_epilogue`.

With ``base_quant`` (``'int8'``, ``'w8a8'`` or ``'w8a8g8'``) the frozen base
is the buffer ``weight_q`` int8 (out, in) with ``weight_scale`` f32 (out,),
never trainable, and the matmul is the one
:func:`~phantom_vlb_tpu_torch.ops.quant.quant_matmul` selects; the
functions there take the (in, out) transpose, as a view.

The rank-r mid is named ``lora_mid`` as in the reference (:210), around
the product that makes it (``core/remat.py``), so the ``'mids'`` and
``'flash'`` checkpoint policies keep it. The adapter's products run before
the base product, which saves no tensor (:func:`frozen_linear`, the int8
Functions of ``ops/quant.py``): a checkpointed layer's replay stops at its
last saved tensor, so it never runs the last projection's z @ B and base
product, which only the layer's output needs. The fused epilogue saves z
and B before it makes the base product (``lora_epilogue`` takes y as a
function), so its replay runs neither that product nor the kernel forward
for the last projection either.

The 32-bit unfused route on the card (:func:`takes_keep_bytes`: live
dropout, ``dropout_bits`` 32, not fused, not shared, CUDA bf16 x with K a
multiple of 64, r in ``RANKS``, and a drawn shape that PyTorch draws in one
launch) draws the site's mask as the 0/1 bytes
of :func:`~phantom_vlb_tpu_torch.ops.lora_fused.keep_bytes`, one launch
that gives ``torch.rand(...) < keep`` bit for bit, and runs the fused
kernels in their bits mode on them (``dropout_bits=32``): the dropped x is
the eager route's bit for bit, and the products' f32 sums are the kernels'.
The mask is drawn again in a checkpoint's replay, never kept across it.
Every other input keeps :func:`adapter_dropout`. Each site call counts
``lora_dropout32.kernel``, and each 32-bit eager draw
``lora_dropout32.eager``, in ``utils/profiling.py``'s counters.

Dropout masks come only from an explicit per-site seed (an int the caller
derives from the step, the layer and the site), never from a global RNG
state: a per-layer ``torch.utils.checkpoint`` replays the layer in the
backward, and a mask drawn from generator state would differ on the replay.
``rows`` = (first global row, global rows) names the part of a batch split
over ranks that the input holds: the generator paths draw the global
batch's mask and keep these rows, the fused path hashes the global row
indices, so each rank drops what the one-card step drops on its rows.

A projection split over the ``tensor`` axis carries its
:class:`~phantom_vlb_tpu_torch.parallel.tensor.TensorSplit` as
``tensor_split`` (set by ``parallel/sharding.py``; None on one card), and
its tensors hold its block. Column-parallel (the output channels split):
``lora_a`` whole, ``lora_b`` and the base split by output; the mid goes
through :func:`copy_to_tensor` before ``z @ B``, and the base's input
comes in already through it (``base_x``, the layer's). Row-parallel (the
input channels split, x holding the rank's columns [c0, c0 + K/t) of the
whole input): ``lora_a`` and the base split by input, ``lora_b`` whole;
the mid and the base are partial sums reduced over the ranks
(:func:`reduce_from_tensor`; the base's in f32, rounded once), and the
adapter term is added once, after the reduction. Its dropout masks are the
whole input's columns [c0, c0 + K/t): the generator paths draw the whole
width and keep these columns, the fused path hashes from ``col0`` = c0.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from phantom_vlb_tpu_torch.core.remat import named
from phantom_vlb_tpu_torch.ops.lora_epilogue import lora_epilogue
from phantom_vlb_tpu_torch.ops.lora_fused import (
    CHUNK,
    RANKS,
    dropout_threshold,
    fused_dropout_matmul,
    keep_bytes,
    keep_draw_fits,
)
from phantom_vlb_tpu_torch.ops.quant import BASE_QUANT_MODES, quant_matmul
from phantom_vlb_tpu_torch.parallel.tensor import COLUMN, ROW, copy_to_tensor, mm_f32, reduce_from_tensor
from phantom_vlb_tpu_torch.utils.profiling import count

__all__ = ["LoRAConfig", "LoRALinear", "FrozenQuantDense", "adapter_dropout", "keep_rows", "drawn_shape",
           "takes_keep_bytes", "is_lora_path", "lora_merge", "site_seed", "row_parallel_linear", "CODES_DTYPE"]

_U32 = 0xFFFFFFFF
# The dtype whose bytes carry a sharded int8 base's codes (``parallel/sharding.py``).
CODES_DTYPE = torch.float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16          # lora.yaml:28 (r=16)
    alpha: float = 32.0     # lora.yaml:29
    dropout: float = 0.1    # lora.yaml:30
    shared_dropout: bool = False
    dropout_bits: int = 32  # 32: exact Bernoulli; 8: u8 threshold (keep 1 - round(256p)/256)
    fused_dropout: bool = False
    # '' off, 'pallas' the epilogue kernels both ways, 'fwd' the kernel
    # forward with library dz and dB (phantom_vlb_tpu/models/lora.py:61-66).
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


def drawn_shape(x: torch.Tensor, rows: tuple[int, int] | None = None,
                cols: tuple[int, int] | None = None) -> tuple[int, ...]:
    """The shape :func:`keep_rows` draws for x: the global batch's rows and
    the whole width."""
    n = x.shape[0] if rows is None else rows[1]
    width = x.shape[-1] if cols is None else cols[1]
    return (n, *x.shape[1:-1], width)


def keep_rows(x: torch.Tensor, rows: tuple[int, int] | None, draw,
              cols: tuple[int, int] | None = None) -> torch.Tensor:
    """``draw(shape)`` over x's shape, or, when x holds rows [r0, r0 + B) of
    a global batch of ``rows`` = (r0, n) rows, over the global shape with
    x's rows kept: the draw of the one-card step, row for row; likewise
    for the columns [c0, c0 + K) of a whole width ``cols`` = (c0, width)."""
    if rows is None and cols is None:
        return draw(x.shape)
    r0 = 0 if rows is None else rows[0]
    c0 = 0 if cols is None else cols[0]
    return draw(drawn_shape(x, rows, cols))[r0:r0 + x.shape[0], ..., c0:c0 + x.shape[-1]]


def adapter_dropout(x: torch.Tensor, cfg: LoRAConfig, seed: int,
                    rows: tuple[int, int] | None = None,
                    cols: tuple[int, int] | None = None) -> torch.Tensor:
    """Adapter-input dropout from the site ``seed`` (training path).

    ``dropout_bits=32``: keep ~ Bernoulli(1 - p), survivors / (1 - p);
    ``dropout_bits=8``: u8 bytes, keep iff byte >= round(256 p), survivors /
    (1 - round(256 p)/256). The scale is in x's dtype, as the reference's.
    ``rows``, ``cols``: see :func:`keep_rows`.
    """
    gen = _generator(seed, x.device)
    if cfg.dropout_bits >= 32:
        count("lora_dropout32.eager")
        keep = keep_rows(x, rows, lambda shape: torch.rand(
            shape, generator=gen, device=x.device) < cfg.dropout_keep_prob, cols)
    elif cfg.dropout_bits == 8:
        thr = dropout_threshold(cfg.dropout)[0]
        keep = keep_rows(x, rows, lambda shape: torch.randint(
            0, 256, shape, generator=gen, device=x.device, dtype=torch.uint8) >= thr, cols)
    else:
        raise ValueError(f"dropout_bits must be 8 or 32, not {cfg.dropout_bits}")
    return torch.where(keep, x / _in_dtype(cfg.dropout_keep_prob, x.dtype), 0.0)


def takes_keep_bytes(x: torch.Tensor, a: torch.Tensor, rows: tuple[int, int] | None = None,
                     cols: tuple[int, int] | None = None) -> bool:
    """Whether the 32-bit route's kernels take x and adapter A: CUDA bf16,
    K a multiple of 64, r in ``RANKS``, and a drawn shape (:func:`drawn_shape`)
    that PyTorch draws in one launch (:func:`keep_draw_fits`; a larger draw
    it splits, and :func:`adapter_dropout` makes)."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.shape[-1] % CHUNK == 0 and a.shape[1] in RANKS
            and keep_draw_fits(math.prod(drawn_shape(x, rows, cols))))


def _check_base_quant(base_quant: str | None) -> None:
    if base_quant is not None and base_quant not in BASE_QUANT_MODES:
        raise ValueError(f"base_quant must be None or one of {BASE_QUANT_MODES}, not {base_quant!r}")


class _QuantBase(nn.Module):
    """The frozen int8 base: ``weight_q`` (out, in) int8 and ``weight_scale``
    (out,) f32 buffers (frozen parameters once sharded over processes, so
    that FSDP2 shards them; ``parallel/sharding.py``), and the matmul
    ``base_quant`` selects."""

    tensor_split = None

    def _init_quant_base(self, in_features: int, out_features: int, base_quant: str) -> None:
        self.base_quant = base_quant
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))

    @property
    def codes(self) -> torch.Tensor:
        """``weight_q`` as int8 (a view where it rides as float8 bytes)."""
        q = self.weight_q
        return q if q.dtype == torch.int8 else q.view(torch.int8)

    def _base(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return quant_matmul(self.base_quant, x, self.codes.t(), self.weight_scale, dtype, self.tensor_split)


class _FrozenLinear(torch.autograd.Function):
    """``x @ weight^T`` with a frozen ``weight``, which the backward reads
    from the module's tensor rather than from a saved one: the product then
    saves nothing, so a checkpointed layer's replay, which stops at the last
    saved tensor, never runs a base product whose output only the layer's
    output needs (XLA's replay drops it too). dx is the same ``mm`` that
    autograd of ``F.linear`` runs."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = weight
        return F.linear(x, weight)

    @staticmethod
    def backward(ctx, dy):
        return (dy @ ctx.weight if ctx.needs_input_grad[0] else None), None


def frozen_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if weight.requires_grad:
        return F.linear(x, weight)
    return _FrozenLinear.apply(x, weight)


class _FrozenLinearF32(torch.autograd.Function):
    """``x @ weight^T`` summed and returned in f32 (:func:`mm_f32`), with a
    frozen ``weight`` read from the module in the backward as
    :class:`_FrozenLinear` reads it; dx is the compute dtype's ``mm``."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = weight
        return mm_f32(x, weight.t())

    @staticmethod
    def backward(ctx, dy):
        w = ctx.weight
        return (dy.to(w.dtype) @ w if ctx.needs_input_grad[0] else None), None


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, split) -> torch.Tensor:
    """A frozen row-parallel product: this rank's f32 partial, summed over
    the ``tensor`` ranks and rounded once to x's dtype."""
    return reduce_from_tensor(_FrozenLinearF32.apply(x, weight), split).to(x.dtype)


def input_columns(split, x: torch.Tensor) -> tuple[int, int] | None:
    """(first column, whole width) of a row-parallel input's columns, or
    None where x is whole."""
    return split.cols(x.shape[-1]) if split is not None and split.role == ROW else None


class LoRALinear(_QuantBase):
    """A frozen base with f32 ``lora_a`` (in, r) and ``lora_b`` (r, out):
    ``weight`` (out, in) in the compute dtype, or with ``base_quant`` the
    int8 buffers of :class:`FrozenQuantDense`; ``tensor_split`` as the
    module's note says."""

    def __init__(self, in_features: int, out_features: int, lora: LoRAConfig,
                 dtype: torch.dtype = torch.bfloat16, base_quant: str | None = None):
        super().__init__()
        _check_base_quant(base_quant)
        if lora.fused_epilogue not in ("", "pallas", "fwd"):
            raise ValueError(f"fused_epilogue must be '', 'pallas' or 'fwd', not {lora.fused_epilogue!r}")
        self.lora, self.dtype = lora, dtype
        if base_quant is None:
            self.base_quant = None
            self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype),
                                       requires_grad=False)
        else:
            self._init_quant_base(in_features, out_features, base_quant)
        self.lora_a = nn.Parameter(torch.empty(in_features, lora.rank, dtype=torch.float32))
        self.lora_b = nn.Parameter(torch.zeros(lora.rank, out_features, dtype=torch.float32))
        if not self.lora_a.is_meta:
            bound = math.sqrt(6.0 / in_features)            # flax he_uniform, fan_in = in
            nn.init.uniform_(self.lora_a, -bound, bound)

    def forward(self, x: torch.Tensor, seed: int | None = None,
                adapter_x: torch.Tensor | None = None, rows: tuple[int, int] | None = None,
                base_x: torch.Tensor | None = None) -> torch.Tensor:
        """``seed`` is the site's dropout seed (None: no dropout);
        ``adapter_x`` a pre-dropped adapter input (shared dropout); ``rows``
        the global batch rows x holds (:func:`keep_rows`); ``base_x`` the
        base product's input where it is not x (a column-parallel layer's
        input through :func:`copy_to_tensor`)."""
        lora, dtype, split = self.lora, self.dtype, self.tensor_split
        a = self.lora_a.to(dtype)
        live = self.training and lora.dropout > 0 and seed is not None
        cols = input_columns(split, x)
        if adapter_x is None and live and lora.fused_dropout:
            x2d = x.reshape(-1, x.shape[-1])
            row0 = 0 if rows is None else rows[0] * (x2d.shape[0] // x.shape[0])
            with named("lora_mid"):
                z = fused_dropout_matmul(x2d, a, seed, lora.dropout, row0=row0,
                                         col0=0 if cols is None else cols[0])
            z = z.reshape(*x.shape[:-1], lora.rank)
        elif adapter_x is None and live and lora.dropout_bits == 32 and takes_keep_bytes(x, a, rows, cols):
            count("lora_dropout32.kernel")
            keep = keep_rows(x, rows, lambda shape: keep_bytes(shape, seed, lora.dropout_keep_prob, x.device), cols)
            x2d = x.reshape(-1, x.shape[-1]).contiguous()
            with named("lora_mid"):
                z = fused_dropout_matmul(x2d, a, seed, lora.dropout, bits=keep.contiguous().view(x2d.shape),
                                         dropout_bits=32)
            z = z.reshape(*x.shape[:-1], lora.rank)
        else:
            z = x if adapter_x is None else adapter_x
            if adapter_x is None and live:
                z = adapter_dropout(z, lora, seed, rows, cols)
            with named("lora_mid"):
                z = z @ a
        if split is not None:
            z = copy_to_tensor(z, split) if split.role == COLUMN else reduce_from_tensor(z, split)
        base_x = x if base_x is None else base_x
        if lora.fused_epilogue:
            return lora_epilogue(lambda: self._base_product(base_x), z, self.lora_b.to(dtype), lora.scaling,
                                 backward="xla" if lora.fused_epilogue == "fwd" else "pallas")
        z = z @ self.lora_b.to(dtype)
        return self._base_product(base_x) + z * _in_dtype(lora.scaling, dtype)

    def _base_product(self, x: torch.Tensor) -> torch.Tensor:
        if self.base_quant is not None:
            return self._base(x, self.dtype)
        if self.tensor_split is not None and self.tensor_split.role == ROW:
            return row_parallel_linear(x, self.weight, self.tensor_split)
        return frozen_linear(x, self.weight)


class FrozenQuantDense(_QuantBase):
    """The adapter-free frozen int8 base (the frozen-baseline regime with
    ``base_quant``, and the vision tower's projections): no trainable
    parameter. With ``bias`` a frozen ``bias`` (out,) in ``dtype`` is added
    after the product in ``dtype``, as the reference adds
    ``bias.astype(dtype)``."""

    def __init__(self, in_features: int, out_features: int, base_quant: str,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = False):
        super().__init__()
        if base_quant is None:
            raise ValueError("FrozenQuantDense needs a base_quant mode")
        _check_base_quant(base_quant)
        self.dtype = dtype
        self._init_quant_base(in_features, out_features, base_quant)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype), requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._base(x, self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def is_lora_path(path: str) -> bool:
    """Adapter selector for trainable parameters and adapter-only exports."""
    return "lora_a" in path or "lora_b" in path


def _round_once(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f64 ``v`` rounded to ``dtype`` once, to nearest even. torch converts
    f64 to bf16 through f32, two roundings; for bf16 the f64 bits are rounded
    at bf16's last mantissa bit first, so the conversion after is exact
    (weights are far from bf16's overflow and subnormal range)."""
    if dtype != torch.bfloat16:
        return v.to(dtype)
    u = v.view(torch.int64)
    drop = 52 - 7                                     # f64 minus bf16 mantissa bits
    lsb = (u >> drop) & 1
    u = (u + (1 << (drop - 1)) - 1 + lsb) & ~((1 << drop) - 1)
    return u.view(torch.float64).to(dtype)


def lora_merge(state_dict: dict, scaling: float) -> dict:
    """Fold adapters into base weights (W^T <- W^T + scaling * A B) for export.

    Each merged weight is the exact sum rounded once to its dtype (the
    reference adds in its f32 master and rounds at use). Adapters on a
    quantized base (``weight_q``, no ``weight``) stay unmerged, as the
    reference merges only where ``kernel`` is present.
    """
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".lora_a"):
            continue
        base = key[: -len(".lora_a")]
        w = state_dict.get(base + ".weight")
        if w is None:
            continue
        a, b = state_dict[key].double(), state_dict[base + ".lora_b"].double()
        out[base + ".weight"] = _round_once(w.double() + scaling * (a @ b).T, w.dtype)
        del out[key], out[base + ".lora_b"]
    return out
