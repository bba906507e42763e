"""Causal GQA flash attention, packed (B, S, H*D) layout: forward and backward.

Counterpart of ``phantom_vlb_tpu/ops/flash_attention.py``
(``attention_packed`` :766, ``attention_with_stats`` :798, ``_fwd_impl`` :412,
``_fwd_kernel`` :93; ``_flash_packed_bwd`` :754, ``_bwd_impl`` :490,
``_dq_dkv_kernel`` :284). On
CUDA tensors :func:`attention_packed` is a ``torch.autograd.Function``: its
forward launches ``csrc/flash_fwd.cu`` and saves (q, k, v, kv bias, out,
lse); its backward launches the three kernels of ``csrc/flash_bwd.cu``:
the prep (q pre-scaled, di, padded lse, a zeroed f32 dq accumulator), the
main kernel (dk, dv and dq's f32 sums) and the post (dq in bf16). On CPU
tensors it runs :func:`attention_packed_plain`, the plain PyTorch version of
the forward, and autograd differentiates that. :func:`attention_packed_bwd_plain` is the
plain version of the backward kernel's own arithmetic, which the card holds
the kernel against. There is no fallback: a CUDA tensor the kernels do not
take raises.

``causal_offset`` shifts the causal mask as the ring's steps need it: query
row i sees key j where ``j <= i + causal_offset`` (reference ``_causal_add``
:86-90), and kv tiles that no row of a q tile sees are skipped (:109,
:191). At offset 0 this is plain causal attention. With a negative offset a
row may see no key at all; where a whole q tile sees none, the kernels, as
the reference's, give out 0 and lse -inf (and zero gradients), but a row
that sees nothing inside a tile that runs gets the uniform average over that
tile's masked keys, which depends on the tile size. The ring's callers
therefore never pass an offset at which a row sees nothing: they skip the
steps whose chunk comes from a later rank, whose contribution in the
reference is exactly zero (``ops/context_parallel.py``).

Numerics carried over from the reference:

- q is pre-scaled by ``sm_scale`` in its own dtype before the products;
- masking is additive, ``MASK_VALUE = -0.7 * finfo(f32).max``, never -inf:
  the kv-padding bias row first, then the causal mask; a key masked by both
  sums to -inf, and a query row whose keys are all masked averages them
  uniformly;
- ``l == 0`` is guarded, and ``lse = m + log(max(l, 1e-30))``;
- P is cast to v's dtype before the PV product, whose sums are f32;
- backward: ``p = exp(s - lse)`` from the saved lse (so a row whose keys are
  all masked gets the p its rounded lse implies, 1 per key, not the 1/n its
  forward used), ``di = rowsum(f32(o) * f32(do))`` per head, bf16 p and ds
  as product operands with f32 sums, ``dk = ds^T @ q_scaled`` with no extra
  factor, ``dq`` times ``sm_scale`` once at the end, and GQA dk/dv summed
  over the group in f32 before their one cast.

The statistics come back as (B, H, S) f32; the reference's (B, H, 8, S)
layout is TPU lane padding and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = [
    "MASK_VALUE", "attention_packed", "attention_packed_plain", "attention_packed_bwd",
    "attention_packed_bwd_plain", "attention_with_stats", "kv_bias", "BwdInputs", "bwd_padded_len",
    "flash_bwd_prep", "flash_bwd_prep_plain", "flash_bwd_post", "flash_bwd_post_plain", "FLASH_FWD",
    "FLASH_BWD", "FLASH_BWD_PREP", "FLASH_BWD_POST",
]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128  # the only head width the kernels are built for

FLASH_FWD = CudaKernel(
    "flash_fwd.cu",
    "flash_fwd_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
FLASH_BWD_PREP = CudaKernel(
    "flash_bwd.cu",
    "flash_bwd_prep_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
)
FLASH_BWD = CudaKernel(
    "flash_bwd.cu",
    "flash_bwd_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
FLASH_BWD_POST = CudaKernel(
    "flash_bwd.cu",
    "flash_bwd_post_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
)
BWD_Q_TILE = 64  # q rows per tile of the backward; S_pad is a multiple of it


def kv_bias(kv_mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, S) additive f32 bias: 0 where ``kv_mask > 0``, MASK_VALUE elsewhere."""
    if kv_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=kv_mask.device)
    return torch.where(kv_mask > 0, zero, MASK_VALUE)


def _default_scale(q: torch.Tensor, num_heads: int, sm_scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1] // num_heads) if sm_scale is None else sm_scale


def _scale_in_dtype(q: torch.Tensor, num_heads: int, sm_scale: float | None) -> float:
    """sm_scale rounded to q's dtype: ``q * it`` rounds the exact product
    once, as the reference's ``q * asarray(sm_scale, q.dtype)`` does."""
    return float(torch.tensor(_default_scale(q, num_heads, sm_scale), dtype=q.dtype))


def _heads(x: torch.Tensor, num_kv_heads: int, group: int) -> torch.Tensor:
    """(B, S, Hkv*G*D) -> (B, Hkv, G, S, D): q head h = kv head * G + g."""
    b, s, width = x.shape
    d = width // (num_kv_heads * group)
    return x.reshape(b, s, num_kv_heads, group, d).permute(0, 2, 3, 1, 4)


def _packed(x: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, D) -> (B, S, Hkv*G*D)."""
    b, hkv, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * g * d)


def _masked_scores(qg, kh, kv_mask, causal_offset=0):
    """f32 scores (B, Hkv, G, S, S) + bias row + causal MASK_VALUE (where
    ``col > row + causal_offset``), in that order."""
    s = qg.shape[-2]
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kh.float())
    bias = kv_bias(kv_mask)
    if bias is not None:
        scores = scores + bias[:, None, None, None, :]
    pos = torch.arange(s, device=qg.device)
    causal = pos[None, :] > pos[:, None] + causal_offset
    return scores + torch.where(causal, MASK_VALUE, 0.0)


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    causal_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: (out (B, S, Hq*D), lse (B, Hq, S) f32).

    Materialises the (B, Hq, S, S) f32 scores, so it is for the CPU and for
    holding the kernel to account on the card, not for speed.
    """
    b, s, _ = q.shape
    group = num_heads // num_kv_heads
    qs = q * _scale_in_dtype(q, num_heads, sm_scale)
    scores = _masked_scores(_heads(qs, num_kv_heads, group), _heads(k, num_kv_heads, 1)[:, :, 0],
                            kv_mask, causal_offset)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    vh = _heads(v, num_kv_heads, 1)[:, :, 0]
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vh.float())
    out = pv * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(b, num_heads, s)
    return _packed(out).to(q.dtype), lse


def attention_packed_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    causal_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dq, dk, dv) in q's, k's, v's dtypes.

    The arithmetic of ``_dq_dkv_kernel`` (reference :284-355) written out:
    p from the saved lse, di from out and do, bf16 p and ds as product
    operands, f32 sums, GQA dk/dv summed over the group before the cast.
    """
    b, s, _ = q.shape
    group = num_heads // num_kv_heads
    scale = _default_scale(q, num_heads, sm_scale)
    qg = _heads(q * _scale_in_dtype(q, num_heads, sm_scale), num_kv_heads, group)
    kh = _heads(k, num_kv_heads, 1)[:, :, 0]
    vh = _heads(v, num_kv_heads, 1)[:, :, 0]
    dog = _heads(do, num_kv_heads, group).float()
    og = _heads(out, num_kv_heads, group).float()
    scores = _masked_scores(qg, kh, kv_mask, causal_offset)
    p = torch.exp(scores - lse.reshape(b, num_kv_heads, group, s)[..., None])
    di = (og * dog).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vh.float())
    ds = (p * (dp - di)).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg.float())
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kh.float()) * scale
    return (_packed(dq).to(q.dtype), _packed(dk[:, :, None]).to(k.dtype),
            _packed(dv[:, :, None]).to(v.dtype))


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


def _flash_fwd_cuda(q, k, v, bias, num_heads, num_kv_heads, sm_scale, causal_offset=0):
    b, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launcher uses the current device
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, s, num_heads, num_kv_heads, _scale_in_dtype(q, num_heads, sm_scale),
            int(causal_offset), torch.cuda.current_stream().cuda_stream,
        )
    return out, lse


def bwd_padded_len(s: int) -> int:
    """S rounded up to the backward's q tile: the length of its padded
    statistics rows and of its dq accumulator."""
    return -(-s // BWD_Q_TILE) * BWD_Q_TILE


@dataclasses.dataclass
class BwdInputs:
    """What the main backward kernel reads besides k, v, the bias and do:
    q pre-scaled in its dtype (B, S, Hq*D); lse and di (B, Hq, S_pad) f32,
    zero past S; and the f32 dq accumulator (B, Hq, S_pad, D), zeroed."""

    qs: torch.Tensor
    lse: torch.Tensor
    di: torch.Tensor
    acc: torch.Tensor


def flash_bwd_prep_plain(q, out, do, lse, num_heads, sm_scale=None) -> BwdInputs:
    """Plain version of the prep kernel: ``q * sm_scale`` rounded once in q's
    dtype (reference :509) and ``di = rowsum(f32(o) * f32(do))`` per head
    (:522-529), with lse copied into the padded rows and dq's sums zeroed."""
    b, s, width = q.shape
    d = width // num_heads
    pad = (0, bwd_padded_len(s) - s)
    qs = q * _scale_in_dtype(q, num_heads, sm_scale)
    di = (out.float() * do.float()).view(b, s, num_heads, d).sum(-1).transpose(1, 2)
    acc = torch.zeros(b, num_heads, s + pad[1], d, dtype=torch.float32, device=q.device)
    return BwdInputs(qs, F.pad(lse.float(), pad), F.pad(di, pad), acc)


def flash_bwd_prep(q, out, do, lse, num_heads, sm_scale=None) -> BwdInputs:
    """The backward's inputs from (q, out, do, lse): ``flash_bwd_prep_kernel``
    on CUDA tensors (bf16, D = 128, contiguous), the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_bwd_prep_plain(q, out, do, lse, num_heads, sm_scale)
    b, s, width = q.shape
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 {tuple(q.shape)} tensor on {q.device}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous() or width != num_heads * HEAD_DIM:
        raise ValueError(f"q must be a contiguous bf16 (B, S, {num_heads}*{HEAD_DIM}) tensor")
    if lse.shape != (b, num_heads, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 ({b}, {num_heads}, {s}) tensor")
    s_pad = bwd_padded_len(s)
    inp = BwdInputs(
        torch.empty_like(q),
        torch.empty(b, num_heads, s_pad, dtype=torch.float32, device=q.device),
        torch.empty(b, num_heads, s_pad, dtype=torch.float32, device=q.device),
        torch.empty(b, num_heads, s_pad, HEAD_DIM, dtype=torch.float32, device=q.device),
    )
    with torch.cuda.device(q.device):  # the launchers use the current device
        FLASH_BWD_PREP.launch(
            q.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(), inp.qs.data_ptr(),
            inp.lse.data_ptr(), inp.di.data_ptr(), inp.acc.data_ptr(), b, s, num_heads, s_pad,
            _scale_in_dtype(q, num_heads, sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    return inp


def flash_bwd_post_plain(acc, s, scale, dq32=None):
    """Plain version of the post kernel: ``bf16(acc * scale)`` in the packed
    (B, S, Hq*D) layout; or, given the f32 ``dq32``, ``dq32 += f32(bf16(acc *
    scale))`` (the ring's per-step rounding) with ``acc``'s rows below S
    zeroed, returning ``dq32``. The rows past S hold the prep's zeros: the
    main kernel adds exact zeros there (a padded q row's ds is p * 0)."""
    b, h, _, d = acc.shape
    dq = (acc[:, :, :s].transpose(1, 2).reshape(b, s, h * d) * scale).to(torch.bfloat16)
    if dq32 is None:
        return dq
    dq32.add_(dq)
    acc[:, :, :s].zero_()
    return dq32


def flash_bwd_post(acc, s, scale, dq32=None):
    """dq from the main kernel's f32 sums: ``flash_bwd_post_kernel`` on CUDA
    tensors, the plain version on CPU tensors (see
    :func:`flash_bwd_post_plain`)."""
    if acc.device.type == "cpu":
        return flash_bwd_post_plain(acc, s, scale, dq32)
    b, h, s_pad, d = acc.shape
    if d != HEAD_DIM or acc.dtype != torch.float32 or not acc.is_contiguous() or s_pad != bwd_padded_len(s):
        raise ValueError(f"acc must be a contiguous f32 (B, H, {bwd_padded_len(s)}, {HEAD_DIM}) tensor")
    if dq32 is not None and (dq32.shape != (b, s, h * d) or dq32.dtype != torch.float32
                             or dq32.device != acc.device or not dq32.is_contiguous()):
        raise ValueError(f"dq32 must be a contiguous f32 ({b}, {s}, {h * d}) tensor on {acc.device}")
    dq = torch.empty(b, s, h * d, dtype=torch.bfloat16, device=acc.device) if dq32 is None else None
    with torch.cuda.device(acc.device):
        FLASH_BWD_POST.launch(
            acc.data_ptr(), None if dq is None else dq.data_ptr(),
            None if dq32 is None else dq32.data_ptr(), b, s, h, s_pad, scale,
            torch.cuda.current_stream().cuda_stream,
        )
    return dq32 if dq is None else dq


def _flash_bwd_main(inp: BwdInputs, k, v, bias, do, num_heads, num_kv_heads, causal_offset=0):
    """One launch of the main kernel: (dk, dv), with dq's f32 sums added
    into ``inp.acc``."""
    b, s, _ = inp.qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(inp.qs.device):
        FLASH_BWD.launch(
            inp.qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            do.data_ptr(), inp.lse.data_ptr(), inp.di.data_ptr(),
            inp.acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, num_heads, num_kv_heads, inp.lse.shape[-1], int(causal_offset),
            torch.cuda.current_stream().cuda_stream,
        )
    return dk, dv


def _flash_bwd_cuda(q, k, v, bias, out, lse, do, num_heads, num_kv_heads, sm_scale,
                    causal_offset=0):
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q {tuple(q.shape)} {q.dtype}; got {tuple(do.shape)} {do.dtype}")
    do = do.contiguous()
    inp = flash_bwd_prep(q, out, do, lse, num_heads, sm_scale)
    dk, dv = _flash_bwd_main(inp, k, v, bias, do, num_heads, num_kv_heads, causal_offset)
    # d(s)/d(q_unscaled) carries sm_scale once (reference :351).
    return flash_bwd_post(inp.acc, q.shape[1], _default_scale(q, num_heads, sm_scale)), dk, dv


class _FlashAttention(torch.autograd.Function):
    """CUDA path: flash_fwd.cu forward, flash_bwd.cu backward (prep, main, post)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, causal_offset):
        bias = kv_bias(kv_mask)
        out, lse = _flash_fwd_cuda(q, k, v, bias, num_heads, num_kv_heads, sm_scale, causal_offset)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.heads = (num_heads, num_kv_heads, sm_scale, causal_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_cuda(q, k, v, bias, out, lse, dout, *ctx.heads)
        return dq, dk, dv, None, None, None, None, None


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    causal_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention: (out (B, S, Hq*D) in q's dtype, lse (B, Hq, S) f32).

    CUDA tensors go through ``csrc/flash_fwd.cu`` and, under autograd,
    ``csrc/flash_bwd.cu`` (bf16, D = 128, contiguous; anything else raises);
    CPU tensors through :func:`attention_packed_plain`. lse is not
    differentiable.
    """
    if q.device.type == "cpu":
        return attention_packed_plain(
            q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale, kv_mask=kv_mask,
            causal_offset=causal_offset,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask)
    return _FlashAttention.apply(q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, causal_offset)


def attention_with_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    causal_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only (out, lse) in the packed layout: the partial-result form a
    ring step merges (reference ``attention_with_stats`` :798-821). Nothing
    is recorded for autograd; train through :func:`attention_packed` or the
    ring functions of ``ops/context_parallel.py``."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return attention_packed_plain(q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale,
                                          kv_mask=kv_mask, causal_offset=causal_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask)
    return _flash_fwd_cuda(q, k, v, kv_bias(kv_mask), num_heads, num_kv_heads, sm_scale,
                           causal_offset)


def attention_packed_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    causal_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_packed` from its saved (out, lse).

    CUDA tensors go through the three kernels of ``csrc/flash_bwd.cu`` (what
    the autograd path launches); CPU tensors through
    :func:`attention_packed_bwd_plain`.
    """
    if q.device.type == "cpu":
        return attention_packed_bwd_plain(q, k, v, out, lse, do, num_heads, num_kv_heads,
                                          sm_scale=sm_scale, kv_mask=kv_mask,
                                          causal_offset=causal_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask)
    if out.shape != q.shape or lse.shape != (q.shape[0], num_heads, q.shape[1]):
        raise ValueError(f"out {tuple(out.shape)} / lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    return _flash_bwd_cuda(q, k, v, kv_bias(kv_mask), out.contiguous(), lse.contiguous(), do,
                           num_heads, num_kv_heads, sm_scale, causal_offset)
