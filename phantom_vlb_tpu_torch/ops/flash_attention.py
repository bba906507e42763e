"""Causal GQA flash attention, packed (B, S, H*D) layout: the forward pass.

Counterpart of ``phantom_vlb_tpu/ops/flash_attention.py``
(``attention_packed`` :766, ``_fwd_impl`` :412, ``_fwd_kernel`` :93). On a
CUDA tensor :func:`attention_packed` launches the hand-written kernel of
``csrc/flash_fwd.cu``; on a CPU tensor it runs :func:`attention_packed_plain`,
the plain PyTorch version of the same function. There is no fallback: a CUDA
tensor the kernel does not take raises.

Numerics carried over from the reference:

- q is pre-scaled by ``sm_scale`` in its own dtype before the products;
- masking is additive, ``MASK_VALUE = -0.7 * finfo(f32).max``, never -inf:
  the kv-padding bias row first, then the causal mask; a key masked by both
  sums to -inf, and a query row whose keys are all masked averages them
  uniformly;
- ``l == 0`` is guarded, and ``lse = m + log(max(l, 1e-30))``;
- P is cast to v's dtype before the PV product, whose sums are f32.

The statistics come back as (B, H, S) f32; the reference's (B, H, 8, S)
layout is TPU lane padding and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = ["MASK_VALUE", "attention_packed", "attention_packed_plain", "kv_bias", "FLASH_FWD"]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128  # the only head width the kernel is built for

FLASH_FWD = CudaKernel(
    "flash_fwd.cu",
    "flash_fwd_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
)


def kv_bias(kv_mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, S) additive f32 bias: 0 where ``kv_mask > 0``, MASK_VALUE elsewhere."""
    if kv_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=kv_mask.device)
    return torch.where(kv_mask > 0, zero, MASK_VALUE)


def _default_scale(q: torch.Tensor, num_heads: int, sm_scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1] // num_heads) if sm_scale is None else sm_scale


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out (B, S, Hq*D), lse (B, Hq, S) f32).

    Materialises the (B, Hq, S, S) f32 scores, so it is for the CPU and for
    holding the kernel to account on the card, not for speed.
    """
    b, s, _ = q.shape
    d = q.shape[-1] // num_heads
    group = num_heads // num_kv_heads
    scale = _default_scale(q, num_heads, sm_scale)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    # (B, S, Hkv, G, D) -> (B, Hkv, G, S, D): q head h = kv head * G + g.
    qg = qs.reshape(b, s, num_kv_heads, group, d).permute(0, 2, 3, 1, 4).float()
    kh = k.reshape(b, s, num_kv_heads, d).permute(0, 2, 1, 3).float()
    vh = v.reshape(b, s, num_kv_heads, d).permute(0, 2, 1, 3)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kh)
    bias = kv_bias(kv_mask)
    if bias is not None:
        scores = scores + bias[:, None, None, None, :]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    scores = scores + torch.where(causal, MASK_VALUE, 0.0)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vh.float())
    out = pv * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(b, num_heads, s)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, num_heads * d).to(q.dtype)
    return out, lse


def _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"want q (B, S, Hq*D), k = v (B, S, Hkv*D); got {q.shape}, {k.shape}, {v.shape}")
    b, s, width = q.shape
    if num_heads % num_kv_heads or width != num_heads * HEAD_DIM:
        raise ValueError(f"q width {width} != {num_heads} heads x {HEAD_DIM}, or {num_heads} % {num_kv_heads} != 0")
    if k.shape != (b, s, num_kv_heads * HEAD_DIM):
        raise ValueError(f"k/v {tuple(k.shape)} != ({b}, {s}, {num_kv_heads * HEAD_DIM})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on {q.device}; got {x.dtype} on {x.device}")
    if kv_mask is not None and (kv_mask.shape != (b, s) or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be ({b}, {s}) on {q.device}; got {tuple(kv_mask.shape)} on {kv_mask.device}")


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention: (out (B, S, Hq*D) in q's dtype, lse (B, Hq, S) f32).

    CUDA tensors go through ``csrc/flash_fwd.cu`` (bf16, D = 128, contiguous;
    anything else raises); CPU tensors through :func:`attention_packed_plain`.
    """
    if q.device.type == "cpu":
        return attention_packed_plain(
            q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale, kv_mask=kv_mask
        )
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask)
    b, s, _ = q.shape
    # The reference multiplies q by sm_scale cast to q's dtype.
    scale = float(torch.tensor(_default_scale(q, num_heads, sm_scale), dtype=q.dtype))
    bias = kv_bias(kv_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launcher uses the current device
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, s, num_heads, num_kv_heads, scale,
            torch.cuda.current_stream().cuda_stream,
        )
    return out, lse
