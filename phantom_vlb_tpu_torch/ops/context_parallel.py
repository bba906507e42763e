"""Context-parallel attention over a sequence ring: the plain ring and the per-step flash ring.

Counterpart of ``phantom_vlb_tpu/ops/context_parallel.py``. The sequence is
cut into n contiguous chunks, chunk i on rank i of a
:class:`~phantom_vlb_tpu_torch.core.mesh.SequenceRing`; each rank folds the
kv chunks of every rank into its queries' softmax in ring order (step r
brings the chunk of rank ``(i - r) mod n``). Tensors stay in the port's
packed layout: global q (B, S, Hq*D), k and v (B, S, Hkv*D), kv_mask (B, S);
the result comes back whole on q's device. Moving a chunk to a rank's
device is the counterpart of the reference's ``ppermute``.

- :func:`ring_attention` (reference :56-131): the plain ring, where-mask
  with ``_NEG`` and ``o / max(l, 1e-30)``, over every step. Plain torch ops
  on any device, differentiated by autograd: the reference the kernels are
  held to.
- :func:`ring_flash_attention` (:134-252): each step runs the flash forward
  (:func:`attention_with_stats`, ``csrc/flash_fwd.cu`` on a card) with
  causal offset ``(i - src) * S_loc`` and merges the step's (out, lse) by
  log-sum-exp (:184-210); its backward (:212-252) runs the flash backward
  (``csrc/flash_bwd.cu``) per rank and step against the saved global (out,
  lse), sums dq in f32 per rank and dk, dv in f32 per chunk in the
  reference's order (chunk c takes the contributions of ranks c, c+1, ...
  mod n, in that order), and casts each once. :func:`ring_flash_bwd` is
  that backward, which ``ops/ring_fused.py`` reuses as the reference's
  ``rf_bwd`` does.

Steps whose chunk comes from a later rank (src > i) lie wholly above the
causal diagonal. The reference runs them and they contribute exactly zero:
every kv tile is skipped in its forward (out 0, lse -inf, merge weight
exp(-inf) = 0), and in its backward p = exp(s + MASK_VALUE - lse) = 0 for
every row that sees a valid key. The flash ring here skips them, which
gives the same numbers (x + 0 = x in f32) and calls the kernels only with
offsets at which every row sees a key.

With n == 1 each function is the normal attention, as the reference's is
(:70-74, :159-163).
"""

from __future__ import annotations

import contextlib
import math

import torch

from phantom_vlb_tpu_torch.core.mesh import SequenceRing
from phantom_vlb_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    _check_cuda_inputs,
    _default_scale,
    _flash_bwd_main,
    _heads,
    _packed,
    attention_packed,
    attention_packed_bwd,
    attention_packed_plain,
    attention_with_stats,
    flash_bwd_post,
    flash_bwd_prep,
    kv_bias,
)

__all__ = ["ring_attention", "ring_flash_attention", "ring_flash_fwd", "ring_flash_bwd"]

_NEG = MASK_VALUE


def on_device(dev: torch.device):
    """Make ``dev`` the current card (a no-op context for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def check_ring_inputs(q, k, v, num_heads, num_kv_heads, ring: SequenceRing, kv_mask):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"want q (B, S, Hq*D), k = v (B, S, Hkv*D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if num_heads % num_kv_heads or q.shape[-1] % num_heads \
            or k.shape[-1] != num_kv_heads * (q.shape[-1] // num_heads):
        raise ValueError(f"widths {q.shape[-1]} / {k.shape[-1]} do not split into "
                         f"{num_heads} / {num_kv_heads} heads of one size")
    if q.shape[1] % ring.n:
        raise ValueError(f"sequence {q.shape[1]} does not divide the ring's {ring.n} ranks")
    if kv_mask is not None and kv_mask.shape != q.shape[:2]:
        raise ValueError(f"kv_mask must be {tuple(q.shape[:2])}; got {tuple(kv_mask.shape)}")


class _Chunks:
    """Rank-sized chunks of a global (B, S, ...) tensor, on the devices
    asked for, contiguous, each made once."""

    def __init__(self, x: torch.Tensor | None, n: int):
        self.x, self.s_loc, self._made = x, (0 if x is None else x.shape[1] // n), {}

    def __call__(self, c: int, dev: torch.device) -> torch.Tensor | None:
        if self.x is None:
            return None
        if (c, dev) not in self._made:
            part = self.x[:, c * self.s_loc:(c + 1) * self.s_loc]
            self._made[(c, dev)] = part.to(dev).contiguous()
        return self._made[(c, dev)]


def ring_attention(
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
    """Causal GQA attention over the ring, plain: equal to full attention."""
    if ring.n == 1:
        return attention_packed_plain(q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale,
                                      kv_mask=kv_mask)[0]
    check_ring_inputs(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    n = ring.n
    b, s, _ = q.shape
    d = q.shape[-1] // num_heads
    group = num_heads // num_kv_heads
    s_loc = s // n
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    if kv_mask is None:
        kv_mask = torch.ones(b, s, dtype=torch.int32, device=q.device)
    qc, kc, vc, mc = (_Chunks(x, n) for x in (q, k, v, kv_mask))
    outs = []
    for idx, dev in enumerate(ring.devices):
        qg = _heads(qc(idx, dev), num_kv_heads, group).float()        # (B, Hkv, G, S_loc, D)
        m = torch.full((*qg.shape[:-1], 1), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        o = torch.zeros(qg.shape, dtype=torch.float32, device=dev)
        q_pos = idx * s_loc + torch.arange(s_loc, device=dev)[:, None]
        for step in range(n):
            src = (idx - step) % n
            kb = _heads(kc(src, dev), num_kv_heads, 1)[:, :, 0].float()
            vb = _heads(vc(src, dev), num_kv_heads, 1)[:, :, 0].float()
            scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
            kv_pos = src * s_loc + torch.arange(s_loc, device=dev)[None, :]
            valid = (mc(src, dev)[:, None, None, None, :] > 0) & (kv_pos <= q_pos)
            scores = torch.where(valid, scores, _NEG)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            o = alpha * o + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
            m = m_new
        outs.append(_packed(o / l.clamp_min(1e-30)).to(q.dtype).to(q.device))
    return torch.cat(outs, dim=1)


def _per_row(w: torch.Tensor) -> torch.Tensor:
    """(B, Hq, S) statistics -> (B, S, Hq, 1), to scale packed rows."""
    return w.transpose(1, 2)[..., None]


def ring_flash_fwd(q, k, v, num_heads, num_kv_heads, ring: SequenceRing, *, sm_scale=None,
                   kv_mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-step flash ring's forward: (out (B, S, Hq*D), lse (B, Hq, S) f32)."""
    n = ring.n
    b, s, _ = q.shape
    s_loc = s // n
    d = q.shape[-1] // num_heads
    qc, kc, vc, mc = (_Chunks(x, n) for x in (q, k, v, kv_mask))
    outs, lses = [], []
    for idx, dev in enumerate(ring.devices):
        with on_device(dev):
            q_loc = qc(idx, dev)
            o = torch.zeros(b, s_loc, num_heads, d, dtype=torch.float32, device=dev)
            lse = torch.full((b, num_heads, s_loc), _NEG, dtype=torch.float32, device=dev)
            for step in range(idx + 1):          # src = idx - step; later ranks skipped
                src = idx - step
                o_blk, lse_blk = attention_with_stats(
                    q_loc, kc(src, dev), vc(src, dev), num_heads, num_kv_heads, sm_scale=sm_scale,
                    kv_mask=mc(src, dev), causal_offset=step * s_loc)
                m = torch.maximum(lse, lse_blk)
                w_old, w_new = torch.exp(lse - m), torch.exp(lse_blk - m)
                denom = (w_old + w_new).clamp_min(1e-30)
                o_new = o_blk.float().view(b, s_loc, num_heads, d)
                o = (o * _per_row(w_old) + o_new * _per_row(w_new)) / _per_row(denom)
                lse = m + torch.log(denom)
            outs.append(o.reshape(b, s_loc, num_heads * d).to(q.dtype).to(q.device))
            lses.append(lse.to(q.device))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def ring_flash_bwd(q, k, v, kv_mask, out, lse, do, num_heads, num_kv_heads, ring: SequenceRing,
                   *, sm_scale=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the ring from the saved global (out, lse): the flash
    backward per rank and step with the step's causal offset (reference
    ``bwd_body`` :212-252). On a card each rank runs the backward's prep
    kernel once for all its steps (q pre-scaled and di: the reference forms
    both per step, the same numbers), then per step the main kernel and the
    post kernel's accumulate form, which adds the step's dq, rounded to q's
    dtype as the reference's is, into the rank's f32 sum and zeroes the
    accumulator for the next step."""
    n = ring.n
    s_loc = q.shape[1] // n
    bias = kv_bias(kv_mask)
    qc, kc, vc, mc, bc, oc, dc = (_Chunks(x, n) for x in (q, k, v, kv_mask, bias, out, do))
    lse_chunks = [lse[:, :, c * s_loc:(c + 1) * s_loc] for c in range(n)]
    dk_acc = [torch.zeros(k.shape[0], s_loc, k.shape[2], dtype=torch.float32, device=dev)
              for dev in ring.devices]
    dv_acc = [torch.zeros_like(x) for x in dk_acc]
    dqs = []
    for idx, dev in enumerate(ring.devices):
        with on_device(dev):
            q_loc, o_loc, do_loc = qc(idx, dev), oc(idx, dev), dc(idx, dev)
            lse_loc = lse_chunks[idx].to(dev).contiguous()
            dq = torch.zeros(q_loc.shape, dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                _check_cuda_inputs(q_loc, kc(idx, dev), vc(idx, dev), num_heads, num_kv_heads,
                                   mc(idx, dev))
                inp = flash_bwd_prep(q_loc, o_loc, do_loc, lse_loc, num_heads, sm_scale)
                scale = _default_scale(q_loc, num_heads, sm_scale)
            for step in range(idx + 1):          # src = idx - step; later ranks skipped
                src = idx - step
                if dev.type == "cuda":
                    dk_b, dv_b = _flash_bwd_main(
                        inp, kc(src, dev), vc(src, dev), bc(src, dev), do_loc, num_heads,
                        num_kv_heads, causal_offset=step * s_loc)
                    flash_bwd_post(inp.acc, s_loc, scale, dq32=dq)
                else:
                    dq_b, dk_b, dv_b = attention_packed_bwd(
                        q_loc, kc(src, dev), vc(src, dev), o_loc, lse_loc, do_loc, num_heads,
                        num_kv_heads, sm_scale=sm_scale, kv_mask=mc(src, dev),
                        causal_offset=step * s_loc)
                    dq.add_(dq_b)
                # Ranks run in increasing order, so chunk src takes ranks
                # src, src+1, ... in turn: the reference's order.
                home = ring.devices[src]
                dk_acc[src].add_(dk_b.to(home))
                dv_acc[src].add_(dv_b.to(home))
            dqs.append(dq.to(q.dtype).to(q.device))
    dk = torch.cat([x.to(k.dtype).to(k.device) for x in dk_acc], dim=1)
    dv = torch.cat([x.to(v.dtype).to(v.device) for x in dv_acc], dim=1)
    return torch.cat(dqs, dim=1), dk, dv


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring):
        out, lse = ring_flash_fwd(q, k, v, num_heads, num_kv_heads, ring, sm_scale=sm_scale,
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


def ring_flash_attention(
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
    """Causal GQA attention over the ring through the flash kernels, trainable."""
    if ring.n == 1:
        return attention_packed(q, k, v, num_heads, num_kv_heads, sm_scale=sm_scale,
                                kv_mask=kv_mask)[0]
    check_ring_inputs(q, k, v, num_heads, num_kv_heads, ring, kv_mask)
    return _RingFlash.apply(q, k, v, kv_mask, num_heads, num_kv_heads, sm_scale, ring)
