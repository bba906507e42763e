"""Fused LoRA adapter-input dropout + rank-r matmul, with its backward.

Counterpart of ``phantom_vlb_tpu/ops/lora_fused.py`` (``fused_dropout_matmul``
:147, ``_fwd_kernel`` :62, ``_dx_kernel`` :92, ``_da_kernel`` :111)::

    mid = (mask * x / keep) @ A                          forward
    dx  = (dmid @ A^T) * mask / keep                     backward
    dA  = (mask * x / keep)^T @ dmid   (f32 sums)        backward

x is (M, K), A is (K, r). The mask is never stored: each kernel regenerates
it. Its rule is the reference's u8 threshold, keep iff byte >= thr with
``thr = round(p * 256)`` and ``keep = 1 - thr / 256``; ``thr == 0`` is a
plain product. Dtypes follow the reference: the forward and dA scale x by
``1/keep`` rounded to x's dtype (and round the product to it), dx scales the
f32 ``dmid @ A^T`` by the f32 ``1/keep``.

The bytes come from ``bits`` (an (M, K) uint8 tensor, the test mode) or from
a counter-based hash of (seed, row0 + row, (col0 + col) >> 2) alone: one
32-bit word masks 4 neighbouring elements, byte ``col & 3`` each, as the
reference's ``_keep_planes`` spreads one word over 4 elements. ``row0`` is
the global index of x's first row, so a rank that holds rows [row0, row0 +
M) of a batch split over ranks draws those rows of the one-card mask;
``col0`` (a multiple of 4) is the global index of x's first column, so a
rank of the tensor axis whose row-parallel projection reads columns [col0,
col0 + K) of the input draws those columns of it. A GPU cannot reproduce
the TPU's hardware stream, so the hash is this port's own; because it does
not depend on tile shapes, forward, dx and dA see the same mask by
construction, and :func:`hash_bytes` (torch int64, masked to 32 bits)
gives the kernels' bytes bit for bit.

On CUDA tensors the three kernels of ``csrc/lora_dropout.cu`` run; on CPU
tensors their plain versions. There is no fallback on the card. The
forward is the dispatcher op ``vlb::lora_dropout_fwd``, so that a
checkpoint policy can keep the mid it makes (``core/remat.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = [
    "fused_dropout_matmul", "fused_dropout_matmul_plain", "fused_dropout_bwd_plain",
    "fused_dropout_bwd", "hash_bytes", "dropout_threshold", "LORA_FWD", "LORA_DX", "LORA_DA",
]

CHUNK = 64            # the kernels' tile edge: K must be a multiple of it
RANKS = (16, 32, 64, 128)
TARGET_BLOCKS = 528   # 4 blocks per SM of an H100 when splitting a reduction
_GOLDEN, _M1, _M2 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35
_U32 = 0xFFFFFFFF

_SRC = "lora_dropout.cu"
LORA_FWD = CudaKernel(
    _SRC, "lora_fwd_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_uint32] + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
)
LORA_DX = CudaKernel(
    _SRC, "lora_dx_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_uint32] + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
)
LORA_DA = CudaKernel(
    _SRC, "lora_da_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_uint32] + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
)


def dropout_threshold(p: float) -> tuple[int, float]:
    """(thr, keep) of the u8 rule: keep iff byte >= thr, keep = 1 - thr/256."""
    thr = int(round(p * 256))
    return thr, 1.0 - thr / 256.0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_bytes(seed: int, m: int, k: int, device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """(m, k) uint8 mask bytes of ``seed`` for global rows [row0, row0 + m)
    and columns [col0, col0 + k), the kernels' exact stream: word(row, w) =
    fmix32(fmix32(seed ^ row * 0x9E3779B1) ^ w) for w = col >> 2, byte
    ``col & 3`` of it for element (row, col)."""
    if k % 4 or col0 % 4:
        raise ValueError(f"k = {k} and col0 = {col0} must be multiples of 4")
    rows = torch.arange(row0, row0 + m, dtype=torch.int64, device=device)
    words = torch.arange(col0 // 4, (col0 + k) // 4, dtype=torch.int64, device=device)
    row_key = _fmix32((seed & _U32) ^ _mul32(rows, _GOLDEN))
    h = _fmix32(row_key[:, None] ^ words[None, :])
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    return ((h[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(m, k)


def _keep_mask(x, seed, thr, bits, row0, col0):
    b = hash_bytes(seed, x.shape[0], x.shape[1], x.device, row0, col0) if bits is None else bits
    return b >= thr


def _inv_keep(thr: int) -> float:
    return 1.0 / (1.0 - thr / 256.0)


def _scale_in_dtype(thr: int, dtype: torch.dtype) -> float:
    """1/keep rounded to ``dtype``: ``x * it`` rounds the exact product once."""
    return float(torch.tensor(_inv_keep(thr), dtype=dtype))


def _dropped(x, keep, thr):
    """mask * x / keep with the scale and the product in x's dtype (reference :71-72)."""
    return torch.where(keep, x * _scale_in_dtype(thr, x.dtype), 0.0)


def fused_dropout_matmul_plain(x, a, seed: int, thr: int, bits=None, row0: int = 0,
                               col0: int = 0) -> torch.Tensor:
    """Plain forward: (M, r) in x's dtype, f32 sums."""
    z = _dropped(x, _keep_mask(x, seed, thr, bits, row0, col0), thr)
    return (z.float() @ a.to(x.dtype).float()).to(x.dtype)


def fused_dropout_bwd_plain(x, a, dmid, seed: int, thr: int, bits=None, row0: int = 0, col0: int = 0):
    """Plain backward: (dx in x's dtype, dA f32)."""
    keep = _keep_mask(x, seed, thr, bits, row0, col0)
    dmid = dmid.to(x.dtype).float()
    g = dmid @ a.to(x.dtype).float().T
    dx = torch.where(keep, g * _inv_keep(thr), 0.0).to(x.dtype)
    da = _dropped(x, keep, thr).float().T @ dmid
    return dx, da


def _check_cuda(x, a, bits, col0=0):
    m, k = x.shape
    if a.shape[0] != k or a.shape[1] not in RANKS:
        raise ValueError(f"A must be ({k}, r) with r in {RANKS}; got {tuple(a.shape)}")
    if k % CHUNK or col0 % 4:
        raise ValueError(f"K = {k} must be a multiple of {CHUNK} and col0 = {col0} one of 4")
    for name, t in (("x", x), ("A", a)):
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on {x.device}; got {t.dtype} on {t.device}")
    if bits is not None and (bits.shape != x.shape or bits.dtype != torch.uint8
                             or bits.device != x.device or not bits.is_contiguous()):
        raise ValueError(f"bits must be a contiguous ({m}, {k}) uint8 tensor on {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_cuda(x, a, seed, thr, bits, row0, col0):
    m, k = x.shape
    r = a.shape[1]
    m_blocks, chunks = math.ceil(m / CHUNK), k // CHUNK
    split = min(chunks, max(1, math.ceil(TARGET_BLOCKS / m_blocks)))
    part = torch.empty((split, m, r), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        LORA_FWD.launch(x.data_ptr(), a.data_ptr(), _ptr(bits), part.data_ptr(),
                        m, k, r, split, seed & _U32, row0, col0, thr, _scale_in_dtype(thr, x.dtype),
                        torch.cuda.current_stream().cuda_stream)
    return part.sum(0).to(x.dtype)


def _dx_cuda(x, a, dmid, seed, thr, bits, row0, col0):
    m, k = x.shape
    dmid = dmid.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        LORA_DX.launch(dmid.data_ptr(), a.data_ptr(), _ptr(bits), dx.data_ptr(),
                       m, k, a.shape[1], seed & _U32, row0, col0, thr, _inv_keep(thr),
                       torch.cuda.current_stream().cuda_stream)
    return dx


def _da_cuda(x, a, dmid, seed, thr, bits, row0, col0):
    m, k = x.shape
    r = a.shape[1]
    dmid = dmid.to(x.dtype).contiguous()
    k_blocks, chunks = k // CHUNK, math.ceil(m / CHUNK)
    split = min(chunks, max(1, math.ceil(TARGET_BLOCKS / k_blocks)))
    part = torch.empty((split, k, r), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        LORA_DA.launch(x.data_ptr(), dmid.data_ptr(), _ptr(bits), part.data_ptr(),
                       m, k, r, split, seed & _U32, row0, col0, thr, _scale_in_dtype(thr, x.dtype),
                       torch.cuda.current_stream().cuda_stream)
    return part.sum(0)


def fused_dropout_bwd(x, a, dmid, seed: int, p: float, *, bits=None, need_dx=True, need_da=True,
                      row0: int = 0, col0: int = 0):
    """(dx, dA f32) of :func:`fused_dropout_matmul` at ``p > 0``: the dx and
    dA kernels on CUDA tensors, :func:`fused_dropout_bwd_plain` on CPU
    tensors. A gradient not asked for comes back as None, unlaunched."""
    thr, _ = dropout_threshold(p)
    if x.device.type == "cpu":
        dx, da = fused_dropout_bwd_plain(x, a, dmid, seed, thr, bits, row0, col0)
        return (dx if need_dx else None), (da if need_da else None)
    _check_cuda(x, a, bits, col0)
    if dmid.shape != (x.shape[0], a.shape[1]):
        raise ValueError(f"dmid {tuple(dmid.shape)} != ({x.shape[0]}, {a.shape[1]})")
    return (_dx_cuda(x, a, dmid, seed, thr, bits, row0, col0) if need_dx else None,
            _da_cuda(x, a, dmid, seed, thr, bits, row0, col0) if need_da else None)


# The forward as a dispatcher op, so that a checkpoint policy can keep the
# mid and the backward's replay does not launch the kernel again
# (``core/remat.py``): the kernel on CUDA tensors, the plain version on CPU
# tensors.
_LIB = torch.library.Library("vlb", "FRAGMENT")
_LIB.define("lora_dropout_fwd(Tensor x, Tensor a, int seed, int thr, Tensor? bits, int row0, int col0) "
            "-> Tensor")
_LIB.impl("lora_dropout_fwd", fused_dropout_matmul_plain, "CPU")
_LIB.impl("lora_dropout_fwd", _fwd_cuda, "CUDA")


class _FusedDropoutMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, seed, p, bits, row0, col0):
        thr, _ = dropout_threshold(p)
        ctx.save_for_backward(x, a, bits)
        ctx.seed, ctx.p, ctx.row0, ctx.col0 = seed, p, row0, col0
        return torch.ops.vlb.lora_dropout_fwd(x, a, seed, thr, bits, row0, col0)

    @staticmethod
    def backward(ctx, dmid):
        x, a, bits = ctx.saved_tensors
        dx, da = fused_dropout_bwd(x, a, dmid, ctx.seed, ctx.p, bits=bits,
                                   need_dx=ctx.needs_input_grad[0],
                                   need_da=ctx.needs_input_grad[1], row0=ctx.row0, col0=ctx.col0)
        return dx, (None if da is None else da.to(a.dtype)), None, None, None, None, None


def fused_dropout_matmul(x: torch.Tensor, a: torch.Tensor, seed: int, p: float, *,
                         bits: torch.Tensor | None = None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """``dropout(x; p) @ a`` with the mask fused into the contraction.

    x (M, K), a (K, r); ``seed`` an integer (its low 32 bits are used),
    ignored when ``bits`` (M, K) uint8 is given; ``row0`` and ``col0`` the
    global indices of x's first row and column in the hash mask (col0 a
    multiple of 4). Returns (M, r) in x's
    dtype, differentiable in x and a. On CUDA tensors: bf16, K a multiple of
    64, r in (16, 32, 64, 128), contiguous; anything else raises.
    """
    thr, _ = dropout_threshold(p)
    if thr == 0:
        return x @ a.to(x.dtype)
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"want x (M, K), a (K, r); got {tuple(x.shape)}, {tuple(a.shape)}")
    if x.device.type == "cuda":
        _check_cuda(x, a, bits, col0)
    elif x.device.type != "cpu":
        raise ValueError(f"no fused dropout kernel for device {x.device}")
    return _FusedDropoutMatmul.apply(x, a, int(seed), p, bits, int(row0), int(col0))
