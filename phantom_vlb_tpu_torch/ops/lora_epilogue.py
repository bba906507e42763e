"""Fused LoRA rank-r epilogue ``y + scaling * (z @ B)``, with its backward.

Counterpart of ``phantom_vlb_tpu/ops/lora_epilogue.py`` (``lora_epilogue``
:96, ``_fwd_kernel`` :45, ``_dz_kernel`` :51, ``_db_kernel`` :69)::

    out  = y + s * (z @ B)        bf16(acc), bf16(. * s), bf16(y + .)
    d(y) = dy                     passed through
    dz   = s * dy @ B^T           f32 sums, one rounding
    dB   = s * z^T @ dy           f32 sums, one rounding

y, dy (..., N); z (..., r); B (r, N), r <= 128. The forward's scaling is
rounded to y's dtype first, as the reference multiplies a bf16 product by
a weakly typed float; the backward's multiplies f32 sums.

On CUDA tensors the kernels of ``csrc/lora_epilogue.cu`` run (bf16,
contiguous, r <= 128; anything else raises). ``backward="xla"`` (the
LoRA flag value ``'fwd'``) keeps the kernel forward and computes dz and dB
with ``torch.addmm`` (the scaling applied to the f32 sums before the one
rounding), as the JAX package leaves them to XLA. On CPU tensors every
part runs its plain version. ``out`` is a new tensor: nothing of the
forward needs y's storage back, and at 80 GB the alias the TPU needs
(:142-146) buys nothing worth an in-place write into an autograd input.
"""

from __future__ import annotations

import ctypes
import math

import torch

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = [
    "lora_epilogue", "lora_epilogue_plain", "lora_epilogue_dz_plain", "lora_epilogue_db_plain",
    "lora_epilogue_fwd", "lora_epilogue_dz", "lora_epilogue_db", "EPI_FWD", "EPI_DZ", "EPI_DB",
    "MAX_RANK",
]

MAX_RANK = 128
CHUNK = 64            # the backward kernels' chunk edge
TARGET_BLOCKS = 528   # 4 blocks per SM of an H100 when splitting a contraction

_SRC = "lora_epilogue.cu"
EPI_FWD = CudaKernel(
    _SRC, "epi_fwd_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
)
EPI_DZ = CudaKernel(
    _SRC, "epi_dz_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
EPI_DB = CudaKernel(
    _SRC, "epi_db_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def lora_epilogue_plain(y, z, b, scaling: float) -> torch.Tensor:
    """Plain forward on 2-D (M, N), (M, r), (r, N): f32 sums, the reference's roundings."""
    acc = (z.float() @ b.float()).to(y.dtype)
    return y + acc * _in_dtype(scaling, y.dtype)


def lora_epilogue_dz_plain(dy, b, scaling: float) -> torch.Tensor:
    """Plain dz (M, r) in dy's dtype."""
    return (scaling * (dy.float() @ b.float().t())).to(dy.dtype)


def lora_epilogue_db_plain(z, dy, scaling: float) -> torch.Tensor:
    """Plain dB (r, N) in dy's dtype."""
    return (scaling * (z.float().t() @ dy.float())).to(dy.dtype)


def _check_cuda(**tensors) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on {dev}; "
                             f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")


def _check_shapes(m, n, r, z_shape, b_shape) -> None:
    if tuple(z_shape) != (m, r) or tuple(b_shape) != (r, n):
        raise ValueError(f"want z ({m}, r) and B (r, {n}); got {tuple(z_shape)}, {tuple(b_shape)}")
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"the epilogue kernels take a rank of 1 to {MAX_RANK}; got {r}")
    if m >= 2**31 or n >= 2**31:
        raise ValueError(f"the epilogue kernels take fewer than 2^31 rows and columns; got ({m}, {n})")


def _padded_rank(r: int) -> int:
    return next(p for p in (16, 32, 64, 128) if r <= p)


def _split(blocks: int, chunks: int) -> int:
    return min(chunks, max(1, math.ceil(TARGET_BLOCKS / blocks)))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def lora_epilogue_fwd(y, z, b, scaling: float) -> torch.Tensor:
    """``y + s * (z @ b)`` on 2-D tensors: the kernel on CUDA, the plain version on the CPU."""
    m, n = y.shape
    r = z.shape[1]
    if y.device.type == "cpu":
        return lora_epilogue_plain(y, z, b, scaling)
    _check_cuda(y=y, z=z, b=b)
    _check_shapes(m, n, r, z.shape, b.shape)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        EPI_FWD.launch(y.data_ptr(), z.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, r,
                       _in_dtype(scaling, y.dtype), _stream(y))
    return out


def lora_epilogue_dz(dy, b, scaling: float) -> torch.Tensor:
    """``s * dy @ b^T`` (M, r) on 2-D tensors: the kernel on CUDA, plain on the CPU."""
    if dy.device.type == "cpu":
        return lora_epilogue_dz_plain(dy, b, scaling)
    m, n = dy.shape
    r = b.shape[0]
    _check_cuda(dy=dy, b=b)
    _check_shapes(m, n, r, (m, r), b.shape)
    rp = _padded_rank(r)
    split = _split(math.ceil(m / CHUNK), math.ceil(n / CHUNK))
    part = torch.empty((split, m, rp), dtype=torch.float32, device=dy.device)
    dz = torch.empty((m, r), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        EPI_DZ.launch(dy.data_ptr(), b.data_ptr(), part.data_ptr(), dz.data_ptr(), m, n, r, rp, split,
                      float(scaling), _stream(dy))
    return dz


def lora_epilogue_db(z, dy, scaling: float) -> torch.Tensor:
    """``s * z^T @ dy`` (r, N) on 2-D tensors: the kernel on CUDA, plain on the CPU."""
    if dy.device.type == "cpu":
        return lora_epilogue_db_plain(z, dy, scaling)
    m, n = dy.shape
    r = z.shape[1]
    _check_cuda(z=z, dy=dy)
    _check_shapes(m, n, r, z.shape, (r, n))
    rp = _padded_rank(r)
    split = _split(math.ceil(n / CHUNK), math.ceil(m / CHUNK))
    part = torch.empty((split, n, rp), dtype=torch.float32, device=dy.device)
    db = torch.empty((r, n), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        EPI_DB.launch(z.data_ptr(), dy.data_ptr(), part.data_ptr(), db.data_ptr(), m, n, r, rp, split,
                      float(scaling), _stream(dy))
    return db


def _addmm_scaled(a, b, scaling: float) -> torch.Tensor:
    """``scaling * (a @ b)`` by one library call: the scale applied to the
    f32 sums before the one rounding (``beta=0`` ignores the output's old
    contents)."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return out.addmm_(a, b, beta=0, alpha=scaling)


class _LoRAEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, z, b, scaling, backward):
        ctx.save_for_backward(z, b)
        ctx.scaling, ctx.backward = scaling, backward
        return lora_epilogue_fwd(y, z, b, scaling)

    @staticmethod
    def backward(ctx, dy):
        z, b = ctx.saved_tensors
        dy = dy.contiguous()
        dz = db = None
        if ctx.backward == "xla":
            if ctx.needs_input_grad[1]:
                dz = _addmm_scaled(dy, b.t(), ctx.scaling)
            if ctx.needs_input_grad[2]:
                db = _addmm_scaled(z.t(), dy, ctx.scaling)
        else:
            if ctx.needs_input_grad[1]:
                dz = lora_epilogue_dz(dy, b, ctx.scaling)
            if ctx.needs_input_grad[2]:
                db = lora_epilogue_db(z, dy, ctx.scaling)
        return (dy if ctx.needs_input_grad[0] else None), dz, db, None, None


def lora_epilogue(y: torch.Tensor, z: torch.Tensor, b: torch.Tensor, scaling: float, *,
                  backward: str = "pallas") -> torch.Tensor:
    """``y + scaling * (z @ b)``, differentiable in y, z and b.

    y (..., N), z (..., r), b (r, N). ``backward``: ``"pallas"`` runs the
    dz and dB kernels, ``"xla"`` the library products (the forward is the
    kernel either way).
    """
    if backward not in ("pallas", "xla"):
        raise ValueError(f"backward must be 'pallas' or 'xla', not {backward!r}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no epilogue kernel for device {y.device}")
    lead, n = y.shape[:-1], y.shape[-1]
    r = b.shape[0]
    out = _LoRAEpilogue.apply(y.reshape(-1, n), z.reshape(-1, r), b, float(scaling), backward)
    return out.reshape(*lead, n)
