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
  k and v (B, S, Hkv*D), kv_mask (B, S), through the ``vlb::ring_fwd``
  dispatcher op, which checkpoint policies see (none keeps it, as none
  keeps the reference's). Chunk i of S goes to rank i; the
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
- :func:`ring_send_plan`: the chunk sends of a pass, (step, sender, slot):
  only the chunks some rank reads, n(n-1)/2 of them.

``RING_FWD.launches`` counts kernel launches, one per rank per pass;
``RING_STATS.sends`` the chunk sends the C launcher enqueued, and
``RING_STATS.launch_s`` the host seconds spent in the C launcher (the rest
of a pass's host time is the Python around it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
import weakref

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
    _default_scale,
    _heads,
    _packed,
    _scale_in_dtype,
    attention_packed,
    kv_bias,
)

__all__ = ["ring_fwd", "ring_fwd_plain", "ring_flash_fused", "ring_send_plan", "RING_FWD", "RING_STATS"]

_SRC = "ring_fwd.cu"
_I, _U64 = ctypes.c_int, ctypes.c_uint64
# One ring pass: every send and every rank's kernel (n launches of it).
RING_FWD = CudaKernel(
    _SRC, "ring_pass_launch",
    [_U64] + [_I] * 5 + [ctypes.c_float, ctypes.c_uint32, ctypes.POINTER(_U64),
                         ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_U64), _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_I)],
)
RING_PEER = CudaKernel(_SRC, "ring_enable_peer", [_I, _I])
RING_STATE_CREATE = CudaKernel(_SRC, "ring_state_create", [_I, ctypes.POINTER(_I), ctypes.POINTER(_U64)])
RING_STATE_DESTROY = CudaKernel(_SRC, "ring_state_destroy", [_U64])


@dataclasses.dataclass
class RingStats:
    """Chunk sends the C launcher enqueued (as it counts them), and host
    seconds spent in it; callers may reset both to 0."""

    sends: int = 0
    launch_s: float = 0.0


RING_STATS = RingStats()


def ring_send_plan(n: int) -> list[tuple[int, int, int]]:
    """The chunk sends of one pass on n ranks, in issue order: (step r,
    sender i, the receiver's slot). At step r rank i forwards the chunk of
    rank i - r to rank i + 1, into its slot r, which rank i + 1 reads at its
    step r + 1. Only chunks some rank reads travel: a chunk goes on while a
    later rank needs it, so r <= i <= n - 2, n(n-1)/2 sends (the reference's
    chain makes n(n-1))."""
    return [(r, i, r) for r in range(n - 1) for i in range(r, n - 1)]


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


class _RingNative:
    """What a ring's passes keep between calls: the C launcher's events, the
    send plan, each rank's streams and flags, the arrival-order index of the
    bias, and the landing slots of the last shape."""

    def __init__(self, ring: SequenceRing):
        n = ring.n
        for i, dev in enumerate(ring.devices):       # the flag writes of a ring over distinct cards
            right = ring.devices[(i + 1) % n]
            if right != dev:
                RING_PEER.launch(dev.index, right.index, count=0)
        self.plan = ring_send_plan(n)
        self.plan_arg = (ctypes.c_int * max(3 * len(self.plan), 1))(*[x for send in self.plan for x in send])
        self.issued = ctypes.c_int()                 # the launcher's count of the sends it enqueued
        handle = ctypes.c_uint64()
        RING_STATE_CREATE.launch(n, (ctypes.c_int * n)(*[d.index for d in ring.devices]),
                                 ctypes.byref(handle), count=0)
        self.handle = handle.value
        self._free = weakref.finalize(self, RING_STATE_DESTROY.launch, self.handle, count=0)
        self._free.atexit = False                    # the driver may be gone by then
        self.streams = [ring.streams(i) for i in range(n)]
        self.flags = [ring.flags(i).data_ptr() for i in range(n)]   # made before the first pass's start
        rank = torch.arange(n)
        self.order = (rank[:, None] - rank[None, :]) % n             # [rank, step] -> chunk
        self.slots_key, self.slots = None, []

    def arrival_bias(self, kv_mask: torch.Tensor, b: int, s_loc: int) -> torch.Tensor:
        """Every rank's bias in arrival order, one gather: (B, rank, step,
        S_loc), step r of rank i holding chunk (i - r) mod n (reference
        :243-246)."""
        if self.order.device != kv_mask.device:
            self.order = self.order.to(kv_mask.device)
        return kv_bias(kv_mask).view(b, -1, s_loc)[:, self.order]

    def slots_for(self, ring: SequenceRing, b: int, s_loc: int, kv_w: int, dtype) -> list:
        """Each rank's landing slots, (max(n - 1, 1), 2, B, S_loc, kv_w): k and
        v of each slot. Made once per shape; slots of another shape are let go
        after the streams that used them (the rank's compute and copy streams
        and its left neighbour's copy stream)."""
        key = (b, s_loc, kv_w, dtype)
        if key != self.slots_key:
            n = ring.n
            for i, old in enumerate(self.slots):
                for stream in (*self.streams[i], self.streams[(i - 1) % n][1]):
                    old.record_stream(stream)
            self.slots = [torch.empty(max(n - 1, 1), 2, b, s_loc, kv_w, dtype=dtype, device=dev)
                          for dev in ring.devices]
            self.slots_key = key
        return self.slots


_NATIVE: "weakref.WeakKeyDictionary[SequenceRing, _RingNative]" = weakref.WeakKeyDictionary()


def _native(ring: SequenceRing) -> _RingNative:
    if ring not in _NATIVE:
        _NATIVE[ring] = _RingNative(ring)
    return _NATIVE[ring]


def _ring_fwd_cuda(q, k, v, num_heads, num_kv_heads, ring: SequenceRing, sm_scale, kv_mask):
    n = ring.n
    b, s, q_w = q.shape
    kv_w = k.shape[-1]
    s_loc = s // n
    home = q.device
    nat = _native(ring)
    slots = nat.slots_for(ring, b, s_loc, kv_w, k.dtype)
    out = torch.empty_like(q)
    lse = torch.empty(b, num_heads, s, dtype=torch.float32, device=home)
    bias = None if kv_mask is None else nat.arrival_bias(kv_mask, b, s_loc)
    # Per rank: its chunk of q, k, v, out and lse (on q's card, the rows of
    # the global tensors in place, as pointers and element strides; on
    # another card, copies made on that card's current stream), its landing
    # slots, flags and bias.
    ptrs, strides, streams, away, caller = [], [], [], [], {}
    for i, dev in enumerate(ring.devices):
        if dev == home:
            ptrs += [q.data_ptr() + 2 * i * s_loc * q_w, k.data_ptr() + 2 * i * s_loc * kv_w,
                     v.data_ptr() + 2 * i * s_loc * kv_w, slots[i].data_ptr(), nat.flags[i],
                     0 if bias is None else bias.data_ptr() + 4 * i * n * s_loc,
                     out.data_ptr() + 2 * i * s_loc * q_w, lse.data_ptr() + 4 * i * s_loc]
            strides += [s * q_w, s * kv_w, s * q_w, n * n * s_loc, s]
        else:
            rows = slice(i * s_loc, (i + 1) * s_loc)
            with on_device(dev):
                q_i, k_i, v_i = (x[:, rows].to(dev).contiguous() for x in (q, k, v))
                bias_i = None if bias is None else bias[:, i].to(dev).contiguous()
                out_i = torch.empty(b, s_loc, q_w, dtype=q.dtype, device=dev)
                lse_i = torch.empty(b, num_heads, s_loc, dtype=torch.float32, device=dev)
            ptrs += [q_i.data_ptr(), k_i.data_ptr(), v_i.data_ptr(), slots[i].data_ptr(), nat.flags[i],
                     0 if bias_i is None else bias_i.data_ptr(), out_i.data_ptr(), lse_i.data_ptr()]
            strides += [s_loc * q_w, s_loc * kv_w, s_loc * q_w, n * s_loc, s_loc]
            away.append((i, dev, out_i, lse_i, (q_i, k_i, v_i, bias_i)))
        if dev not in caller:
            caller[dev] = torch.cuda.current_stream(dev).cuda_stream
        compute, copy = nat.streams[i]
        streams += [compute.cuda_stream, copy.cuda_stream, caller[dev]]
    args = (nat.handle, n, b, s_loc, num_heads, num_kv_heads, _scale_in_dtype(q, num_heads, sm_scale),
            ring.next_epoch(), (ctypes.c_uint64 * (8 * n))(*ptrs), (ctypes.c_longlong * (5 * n))(*strides),
            (ctypes.c_uint64 * (3 * n))(*streams), len(nat.plan), nat.plan_arg, ctypes.byref(nat.issued))
    t0 = time.perf_counter()
    RING_FWD.launch(*args, count=n)
    RING_STATS.launch_s += time.perf_counter() - t0
    RING_STATS.sends += nat.issued.value
    # The caller's stream on each card now waits for the ranks there (the
    # launcher ends the pass so): autograd and the checkpoint replay use the
    # outputs, and may reuse the inputs, on it.
    for i, dev, out_i, lse_i, _ in away:
        rows = slice(i * s_loc, (i + 1) * s_loc)
        with on_device(dev):
            out[:, rows].copy_(out_i)
            lse[:, :, rows].copy_(lse_i)
    return out, lse


# The pass as a dispatcher op (``core/remat.py``: a checkpoint policy sees
# it; as in the reference, which names nothing inside its ring, no policy
# keeps its outputs, so a checkpointed layer's replay runs it again). The
# ring is passed by key (an op takes tensors and scalars); ``sm_scale`` is
# the unrounded scale. A replayed pass is a pass like any other: it takes
# the ring's next epoch and its landing slots for the shape.
_RINGS: "weakref.WeakValueDictionary[int, SequenceRing]" = weakref.WeakValueDictionary()


def _ring_key(ring: SequenceRing) -> int:
    _RINGS[id(ring)] = ring
    return id(ring)


def _ring_op_plain(q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring):
    return ring_fwd_plain(q, k, v, num_heads, num_kv_heads, _RINGS[ring], sm_scale=sm_scale,
                          kv_mask=kv_mask)


def _ring_op_cuda(q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring):
    return _ring_fwd_cuda(q, k, v, num_heads, num_kv_heads, _RINGS[ring], sm_scale, kv_mask)


_LIB = torch.library.Library("vlb", "FRAGMENT")
_LIB.define("ring_fwd(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, int num_heads, int num_kv_heads, "
            "float sm_scale, int ring) -> (Tensor, Tensor)")
_LIB.impl("ring_fwd", _ring_op_plain, "CPU")
_LIB.impl("ring_fwd", _ring_op_cuda, "CUDA")


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
    """Causal GQA attention over the ring by the fused kernel, through the
    ``vlb::ring_fwd`` op: (out (B, S, Hq*D) in q's dtype, lse (B, Hq, S)
    f32). Not differentiable: train through :func:`ring_flash_fused`."""
    if q.device.type == "cpu":
        if any(d.type != "cpu" for d in ring.devices):
            raise ValueError(f"a CPU tensor needs a ring of CPU ranks; got {ring}")
    elif q.device.type == "cuda":
        _check_cuda(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    else:
        raise ValueError(f"no ring kernel for device {q.device}")
    with torch.no_grad():
        return torch.ops.vlb.ring_fwd(q, k, v, kv_mask, num_heads, num_kv_heads,
                                      _default_scale(q, num_heads, sm_scale), _ring_key(ring))


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
