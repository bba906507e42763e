"""One-pass per-row int8 quantization, plain or with a per-column pre-multiply.

Counterpart of ``phantom_vlb_tpu/ops/rowquant.py`` (``row_quant`` :104,
``row_quant_scaled`` :119, kernels :35 and :45) and of the jnp path it
equals (``phantom_vlb_tpu/ops/quant.py:_act_quant`` :68-77,
``_act_quant_scaled`` :80-89)::

    v = x  (or x * w_scale, in f32)
    s = max(max|v| / 127, 1e-12)                     per row, f32
    q = clip(round_half_even(v / s), -127, 127)      int8

x is (..., N), bf16 or f32; q is (..., N) int8 and s (..., 1) f32. On CUDA
tensors one kernel of ``csrc/rowquant.cu`` runs (two entry points); it
divides as IEEE does and rounds half to even, so its q and s equal
:func:`row_quant_plain`'s bit for bit. On CPU tensors the plain version
runs. There is no fallback on the card, and no switch: the JAX package
keeps its kernel opt-in only because XLA's fusion beat it on the TPU.

Where a row's columns lie on several ranks of the tensor axis,
:func:`row_quant_split` quantizes in three steps: each rank's max|v| over
its columns (:func:`row_absmax`, the kernel's first pass alone), the
maximum over the ranks (the caller's collective), then the rank's columns
quantized with the scale of the whole row (:func:`row_quant_given`, its
second pass alone). Maxima are exact, so q and s equal the one-card
quantization of the whole row bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = ["row_quant", "row_quant_scaled", "row_quant_plain", "over_127", "row_absmax", "row_absmax_plain",
           "row_quant_given", "row_quant_given_plain", "row_quant_split", "ROW_QUANT", "ROW_QUANT_SCALED",
           "ROW_ABSMAX", "ROW_QUANT_GIVEN"]

_SRC = "rowquant.cu"
ROW_QUANT = CudaKernel(
    _SRC, "row_quant_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
ROW_QUANT_SCALED = CudaKernel(
    _SRC, "row_quant_scaled_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
)
ROW_ABSMAX = CudaKernel(
    _SRC, "row_absmax_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
ROW_QUANT_GIVEN = CudaKernel(
    _SRC, "row_quant_given_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` by IEEE division on every device: a CUDA tensor divided by
    a Python number is multiplied by its rounded reciprocal instead, one ulp
    off at some values."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def _values(x, w_scale):
    v = x.float()
    return v if w_scale is None else v * w_scale.float()


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """s of a row's max|v|."""
    return over_127(amax).clamp_min(1e-12)


def row_quant_plain(x: torch.Tensor, w_scale: torch.Tensor | None = None):
    """(q int8, s f32 (..., 1)) of ``x`` (times ``w_scale`` in f32)."""
    s = _scale(row_absmax_plain(x, w_scale))
    return row_quant_given_plain(x, s, w_scale), s


def row_absmax_plain(x: torch.Tensor, w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """max|v| per row, f32 (..., 1)."""
    return _values(x, w_scale).abs().amax(dim=-1, keepdim=True)


def row_quant_given_plain(x: torch.Tensor, s: torch.Tensor, w_scale: torch.Tensor | None = None):
    """q int8 of ``x`` (times ``w_scale``) with the row scales ``s`` (..., 1)."""
    return torch.round(_values(x, w_scale) / s).clamp_(-127, 127).to(torch.int8)


def _check_cuda(x, w_scale):
    n = x.shape[-1]
    if x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 or f32 tensor; got {x.dtype}, "
                         f"contiguous={x.is_contiguous()}")
    if w_scale is not None and (w_scale.shape != (n,) or w_scale.dtype != torch.float32
                                or w_scale.device != x.device or not w_scale.is_contiguous()):
        raise ValueError(f"w_scale must be a contiguous ({n},) f32 tensor on {x.device}; "
                         f"got {tuple(w_scale.shape)} {w_scale.dtype} on {w_scale.device}")
    rows = x.numel() // n if n else 0
    if n == 0 or rows >= 2**31 or n >= 2**31:
        raise ValueError(f"row_quant takes 1 to 2^31 - 1 columns and fewer than 2^31 rows; "
                         f"got ({rows}, {n})")
    return rows, n


def _quant_cuda(x, w_scale):
    rows, n = _check_cuda(x, w_scale)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if w_scale is None:
            ROW_QUANT.launch(x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(), s.data_ptr(),
                             rows, n, stream)
        else:
            ROW_QUANT_SCALED.launch(x.data_ptr(), _DTYPE_CODES[x.dtype], w_scale.data_ptr(),
                                    q.data_ptr(), s.data_ptr(), rows, n, stream)
    return q, s


def _dispatch(x, w_scale):
    if x.device.type == "cpu":
        return row_quant_plain(x, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no row-quant kernel for device {x.device}")
    return _quant_cuda(x, w_scale)


def row_quant(x: torch.Tensor):
    """Per-row symmetric int8: (..., N) -> (q int8 (..., N), s f32 (..., 1))."""
    return _dispatch(x, None)


def row_quant_scaled(x: torch.Tensor, w_scale: torch.Tensor):
    """:func:`row_quant` of ``x * w_scale`` (``w_scale`` (N,) f32), without
    forming the product in device memory: the w8a8g8 backward's
    ``dy * weight_scale``."""
    return _dispatch(x, w_scale)


def _on_card(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no row-quant kernel for device {x.device}")
    return True


def row_absmax(x: torch.Tensor, w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """max|x (times ``w_scale``)| per row, f32 (..., 1): the kernel's first
    pass alone."""
    if not _on_card(x):
        return row_absmax_plain(x, w_scale)
    rows, n = _check_cuda(x, w_scale)
    amax = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            ROW_ABSMAX.launch(x.data_ptr(), _DTYPE_CODES[x.dtype], _ptr(w_scale), amax.data_ptr(), rows, n,
                              torch.cuda.current_stream(x.device).cuda_stream)
    return amax


def row_quant_given(x: torch.Tensor, s: torch.Tensor, w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q int8 of x (times ``w_scale``) with the row scales ``s`` (..., 1)
    f32: the kernel's second pass alone."""
    if not _on_card(x):
        return row_quant_given_plain(x, s, w_scale)
    rows, n = _check_cuda(x, w_scale)
    if s.shape != (*x.shape[:-1], 1) or s.dtype != torch.float32 or s.device != x.device:
        raise ValueError(f"s must be a {(*x.shape[:-1], 1)} f32 tensor on {x.device}; got "
                         f"{tuple(s.shape)} {s.dtype} on {s.device}")
    s = s.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            ROW_QUANT_GIVEN.launch(x.data_ptr(), _DTYPE_CODES[x.dtype], _ptr(w_scale), s.data_ptr(),
                                   q.data_ptr(), rows, n, torch.cuda.current_stream(x.device).cuda_stream)
    return q


def _ptr(t):
    return None if t is None else t.data_ptr()


def row_quant_split(x: torch.Tensor, reduce_max, w_scale: torch.Tensor | None = None):
    """(q, s) of :func:`row_quant` (or :func:`row_quant_scaled`) for rows
    whose columns lie on several ranks, x holding this rank's: the local
    maxima, ``reduce_max`` (their maximum over the ranks, a collective),
    then this rank's columns quantized with the whole row's scale."""
    s = _scale(reduce_max(row_absmax(x, w_scale)))
    return row_quant_given(x, s, w_scale), s
