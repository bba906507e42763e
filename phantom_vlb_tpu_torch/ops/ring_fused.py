"""Fused ring attention: one kernel per rank owns the whole ring pass.

Counterpart of ``phantom_vlb_tpu/ops/ring_fused.py`` (``_ring_fwd_kernel``
:48, ``ring_fwd_sharded`` :218, ``ring_flash_fused`` :313). The per-step
ring of ``ops/context_parallel.py`` runs one flash forward per step and
merges the partial results; here one launch of ``csrc/ring_fwd.cu`` per rank
folds every chunk into one online softmax held in registers, while the
chunks travel between ranks by copies that the host enqueues on each rank's
copy stream (their transport and flags are described in the source). The
backward is the per-step ring's (:func:`ring_flash_bwd`) on the saved
(out, lse), as the reference's ``rf_bwd`` (:356-365) is.

- :func:`ring_fwd` (out, lse) for the global packed tensors: q (B, S, Hq*D),
  k and v (B, S, Hkv*D), kv_mask (B, S). Chunk i of S goes to rank i; the
  kernel runs once per rank on that rank's compute stream; out and lse come
  back whole on q's device (on one card the ranks write their rows of them
  in place). CUDA tensors launch the kernel (bf16, D = 128, contiguous,
  S divisible by n; anything else raises); CPU tensors run
  :func:`ring_fwd_plain`.
- :func:`ring_fwd_plain`: the kernel's arithmetic in plain PyTorch, on q's
  device: chunks in arrival order, the bias and in-chunk mask in the
  reference's order, one online softmax per rank (m from -inf, l and acc in
  f32, P cast to v's dtype).
- :func:`ring_flash_fused`: trainable; the kernel forward and the per-step
  ring backward. With one rank it is the normal attention, as the
  reference's is (:322-326).

``RING_FWD.launches`` counts kernel launches, one per rank per pass.
"""

from __future__ import annotations

import ctypes

import torch

from phantom_vlb_tpu_torch.core.mesh import SequenceRing
from phantom_vlb_tpu_torch.ops._build import CudaKernel
from phantom_vlb_tpu_torch.ops.context_parallel import (
    check_ring_inputs,
    on_device,
    ring_flash_bwd,
)
from phantom_vlb_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    _check_cuda_inputs,
    _heads,
    _packed,
    _scale_in_dtype,
    attention_packed,
    kv_bias,
)

__all__ = ["ring_fwd", "ring_fwd_plain", "ring_flash_fused", "RING_FWD"]

_SRC = "ring_fwd.cu"
_I = ctypes.c_int
# One ring pass: every send and every rank's kernel (n launches of it).
RING_FWD = CudaKernel(
    _SRC, "ring_pass_launch",
    [_I] * 5 + [ctypes.c_float, ctypes.c_uint32, ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_uint64)],
)
RING_PEER = CudaKernel(_SRC, "ring_enable_peer", [_I, _I])


def ring_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    ring: SequenceRing,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out (B, S, Hq*D), lse (B, Hq, S) f32)."""
    check_ring_inputs(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    n = ring.n
    b, s, _ = q.shape
    s_loc = s // n
    group = num_heads // num_kv_heads
    qg = _heads(q * _scale_in_dtype(q, num_heads, sm_scale), num_kv_heads, group).float()
    kh = _heads(k, num_kv_heads, 1)[:, :, 0].float()
    vh = _heads(v, num_kv_heads, 1)[:, :, 0]
    bias = kv_bias(kv_mask)
    tri = torch.ones(s_loc, s_loc, dtype=torch.bool, device=q.device).triu(1)
    outs, lses = [], []
    for my in range(n):
        rows = slice(my * s_loc, (my + 1) * s_loc)
        qm = qg[:, :, :, rows]
        m = torch.full((*qm.shape[:-1], 1), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qm.shape, device=q.device)
        for r in range(n):
            src = (my - r) % n
            if src > my:                         # wholly above the causal diagonal
                continue
            cols = slice(src * s_loc, (src + 1) * s_loc)
            scores = torch.einsum("bhgqd,bhkd->bhgqk", qm, kh[:, :, cols])
            if bias is not None:
                scores = scores + bias[:, None, None, None, cols]
            if src == my:
                scores = scores + torch.where(tri, MASK_VALUE, 0.0)
            m_next = torch.maximum(m, scores.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(scores - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                                             vh[:, :, cols].float())
            m = m_next
        outs.append(acc * torch.where(l == 0.0, 1.0, 1.0 / l))
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    out = _packed(torch.cat(outs, dim=3)).to(q.dtype)
    lse = torch.cat(lses, dim=3).reshape(b, num_heads, s)
    return out, lse


def _check_cuda(q, k, v, num_heads, num_kv_heads, ring, kv_mask):
    check_ring_inputs(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    _check_cuda_inputs(q, k, v, num_heads, num_kv_heads, kv_mask)     # the flash kernels' terms
    if any(d.type != "cuda" for d in ring.devices):
        raise ValueError(f"a CUDA tensor needs a ring of cards; got {ring}")


def _enable_peers(ring: SequenceRing) -> None:
    for i, dev in enumerate(ring.devices):
        right = ring.devices[(i + 1) % ring.n]
        if right != dev:
            RING_PEER.launch(dev.index, right.index)


def _ring_fwd_cuda(q, k, v, num_heads, num_kv_heads, ring: SequenceRing, sm_scale, kv_mask):
    n = ring.n
    b, s, q_w = q.shape
    kv_w = k.shape[-1]
    s_loc = s // n
    scale = _scale_in_dtype(q, num_heads, sm_scale)
    home = q.device
    if any(dev != home for dev in ring.devices):
        _enable_peers(ring)
    out = torch.empty_like(q)
    lse = torch.empty(b, num_heads, s, dtype=torch.float32, device=home)
    bias = kv_bias(kv_mask)
    if bias is not None:
        # Every rank's bias in arrival order, (n, B, n, S_loc): position r of
        # rank i holds chunk (i - r) mod n (reference :243-246).
        rank = torch.arange(n, device=home)
        order = (rank[:, None] - rank[None, :]) % n
        bias = bias.view(b, n, s_loc)[:, order].transpose(0, 1).contiguous()
    # Per rank: its chunk of q, k, v, out and lse (on q's card, the rows of
    # the global tensors in place; on another card, copies), its bias, its
    # landing slots (2, n - 1, B, S_loc, Hkv*D): k then v, its flags; as
    # pointers and element strides for the pass launcher. The tensors stay
    # referenced until the cards' current streams wait for the ring's.
    slot_bytes = b * s_loc * kv_w * k.element_size()
    ptrs, strides, streams, keep, outs = [], [], [], [], []
    for i, dev in enumerate(ring.devices):
        rows = slice(i * s_loc, (i + 1) * s_loc)
        with on_device(dev):
            if dev == home:
                q_i, k_i, v_i, out_i, lse_i = q[:, rows], k[:, rows], v[:, rows], out[:, rows], lse[:, :, rows]
            else:
                q_i, k_i, v_i = (x[:, rows].to(dev).contiguous() for x in (q, k, v))
                out_i = torch.empty(b, s_loc, q_w, dtype=q.dtype, device=dev)
                lse_i = torch.empty(b, num_heads, s_loc, dtype=torch.float32, device=dev)
            bias_i = None if bias is None else bias[i].to(dev)
            slots = torch.empty(2, max(n - 1, 1), b, s_loc, kv_w, dtype=k.dtype, device=dev)
        flags = ring.flags(i)                    # made (zeroed) before the ready events
        ptrs += [q_i.data_ptr(), k_i.data_ptr(), v_i.data_ptr(), slots.data_ptr(),
                 slots.data_ptr() + max(n - 1, 1) * slot_bytes, flags.data_ptr(),
                 0 if bias_i is None else bias_i.data_ptr(), out_i.data_ptr(), lse_i.data_ptr()]
        strides += [q_i.stride(0), k_i.stride(0), out_i.stride(0), lse_i.stride(1)]
        streams += [stream.cuda_stream for stream in ring.streams(i)]
        keep += [q_i, k_i, v_i, bias_i, slots]
        outs.append((out_i, lse_i))
    for dev in dict.fromkeys(ring.devices):
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        for i in range(n):
            for stream in ring.streams(i):
                stream.wait_event(ready)
    RING_FWD.launch(
        n, b, s_loc, num_heads, num_kv_heads, scale, ring.next_epoch(),
        (ctypes.c_int * n)(*[dev.index for dev in ring.devices]),
        (ctypes.c_uint64 * (9 * n))(*ptrs), (ctypes.c_longlong * (4 * n))(*strides),
        (ctypes.c_uint64 * (2 * n))(*streams), count=n)
    # Landing slots come and go with each pass: the allocator must not hand
    # them to other work before the streams that touch them are done (the
    # left neighbour's copy stream writes them).
    for i in range(n):
        compute, copy = ring.streams(i)
        keep[5 * i + 4].record_stream(compute)
        keep[5 * i + 4].record_stream(copy)
        keep[5 * ((i + 1) % n) + 4].record_stream(copy)

    # Autograd and the checkpoint replay use the outputs (and may reuse the
    # inputs) on each card's current stream: it waits for the ranks there.
    for i, dev in enumerate(ring.devices):
        current = torch.cuda.current_stream(dev)
        for stream in ring.streams(i):
            current.wait_stream(stream)
        if dev != home:
            rows = slice(i * s_loc, (i + 1) * s_loc)
            with on_device(dev):
                out[:, rows].copy_(outs[i][0])
                lse[:, :, rows].copy_(outs[i][1])
    del keep
    return out, lse


def ring_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    ring: SequenceRing,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention over the ring by the fused kernel: (out (B, S,
    Hq*D) in q's dtype, lse (B, Hq, S) f32). Not differentiable: train
    through :func:`ring_flash_fused`."""
    if q.device.type == "cpu":
        if any(d.type != "cpu" for d in ring.devices):
            raise ValueError(f"a CPU tensor needs a ring of CPU ranks; got {ring}")
        return ring_fwd_plain(q, k, v, num_heads, num_kv_heads, ring, sm_scale=sm_scale,
                              kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no ring kernel for device {q.device}")
    _check_cuda(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    return _ring_fwd_cuda(q, k, v, num_heads, num_kv_heads, ring, sm_scale, kv_mask)


class _RingFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring):
        out, lse = ring_fwd(q, k, v, num_heads, num_kv_heads, ring, sm_scale=sm_scale,
                            kv_mask=kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (num_heads, num_kv_heads, ring, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        num_heads, num_kv_heads, ring, sm_scale = ctx.args
        dq, dk, dv = ring_flash_bwd(q, k, v, kv_mask, out, lse, dout.contiguous(), num_heads,
                                    num_kv_heads, ring, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None, None


def ring_flash_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    ring: SequenceRing,
    *,
    sm_scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Trainable fused-ring attention: the kernel forward, the per-step ring
    backward."""
    if ring.n == 1:
        return attention_packed(q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale,
                                kv_mask=kv_mask)[0]
    return _RingFused.apply(q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring)
