#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printed with its wall time; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the paths with ``nvcc``, and flash_bwd.cu
   with each of its cost probes, one process each, all at once (registers
   and spills per kernel);
3. each kernel against its plain PyTorch version at the paths' shapes:
   flash forward and backward (prep, main and post kernels) at the serving /
   training shapes, a ragged length and S = 4608 (where the reference takes
   its split backward), GQA groups 1, 2, 4 and 8, and a batch row with every
   key masked, with the prep's q_s and the post's dq bit for bit; the
   three LoRA dropout kernels at M = 6144, K = 4096 and 14336,
   in bits mode and in hash mode (dx exactly 0 where the mask drops; both
   masks read back exactly through dx; keep rate, seed determinism); the row quant (both entry points) at
   (6144, 4096) and (6144, 14336) bf16 with a zero row, and at a row count
   that is not a multiple of 8 (q and s bit for bit); the LoRA epilogue's
   forward, dz and dB at M = 6144, r = 16, N = 1024, 4096 and 14336; the
   fused ring forward against its plain version on rings of 4 and 2 ranks
   on the card at (3, 2048), with and without padded keys, and at S = 1000
   on 2 ranks; the flash kernels with causal offsets S_loc, 64 and 0 at S_loc;
4. the full-width Mistral-7B VLB model (32 layers, bf16), made on the card
   from a seeded generator;
5. ``predict_batches`` over 3 synthetic batches of 5, with every kernel's
   launch count read around that run alone;
6. one more served batch under ``torch.profiler``: device time by kernel
   and by group, and the device's idle share; then (6b) that batch again
   through the fused ring (``attention_impl='ring_fused'`` on 4 ranks of the card,
   switched on the same model), held against phase 5's predictions;
7. the full-width LoRA model (r 16, alpha 32, fused u8 dropout 0.1, remat
   per layer): 3 steps of ``train_batches`` at batch 3, launch counts
   against what the code implies, gradients reaching layer 0's adapters;
8. one more LoRA step under ``torch.profiler``; then, on the same weights,
   3 steps with the fused LoRA epilogue (``fused_epilogue='pallas'``), so
   the step time with the flag off and on come from one run; then (8c)
   phase 7's starting adapters again, for 3 steps through the fused ring
   on 4 ranks of the card (first loss and gradient norm against phase 7's,
   launch counts) and one more under ``torch.profiler``, and 2 steps
   through the per-step flash ring;
8b. the w8a8g8 LoRA step of record: phase 7's weights quantized to int8 on
   the card in place, projection by projection, then 3 steps at batch 3
   with the fused epilogue (launch counts of every kernel but the ring's,
   non-zero adapter gradients, peak device memory), and one more under
   ``torch.profiler``;
9. the frozen-baseline regime: 3 steps at batch 5, only the head trains;
10. narrow models (same geometry, 2 layers, 256 wide) on the card against
    the same weights in f32 on the CPU: served predictions, the LoRA loss
    and adapter gradients of one step (packed, and through the fused ring
    on 2 ranks of the card), and the same for a w8a8g8 LoRA step (the same
    int8 weights on both sides);
11. timings: each kernel's device time (``torch.profiler``), its wrapper's
    (device and CUDA events), its plain version's and a library yardstick's,
    beside the bound; the flash backward as the sum of its three kernels
    against SDPA's whole backward (the kernels it ran named), and SDPA with
    ``is_causal=True``, at (3, 2048) and (1, 4608); one pass of the fused ring (first send to last
    output) and each rank's kernel, beside SDPA over the whole sequence and
    the per-step flash ring's forward; ``torch._int_mm`` in each weight
    layout against bf16 ``F.linear`` at 6144 x 4096 -> 14336; the flash
    backward's main kernel against its cost probes (printed only);
12. peak host RSS (peak device memory is printed in phases 5, 7 and 11).

The last two lines of standard output are the kernels' JSON record and the
device JSON record. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import resource
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from phantom_vlb_tpu_torch.cli.predict import predict_batches, synthetic_batches
from phantom_vlb_tpu_torch.core.geometry import REFERENCE_GEOMETRY
from phantom_vlb_tpu_torch.core.mesh import SequenceRing, set_sequence_ring
from phantom_vlb_tpu_torch.models.convert import init_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, set_attention_impl
from phantom_vlb_tpu_torch.models.videollama2 import (
    VLBConfig,
    VideoLLaMA2VLB,
    trainable_parameters,
    trainable_predicate,
)
from phantom_vlb_tpu_torch.ops._build import CudaKernel, build_all
from phantom_vlb_tpu_torch.ops.context_parallel import ring_flash_fwd
from phantom_vlb_tpu_torch.ops.flash_attention import (
    FLASH_BWD,
    FLASH_BWD_POST,
    FLASH_BWD_PREP,
    FLASH_FWD,
    attention_packed,
    attention_packed_bwd,
    attention_packed_bwd_plain,
    attention_packed_plain,
    attention_with_stats,
    bwd_padded_len,
    flash_bwd_post,
    flash_bwd_post_plain,
    flash_bwd_prep,
    flash_bwd_prep_plain,
    kv_bias,
)
from phantom_vlb_tpu_torch.ops.lora_epilogue import (
    EPI_DB,
    EPI_DZ,
    EPI_FWD,
    lora_epilogue_db,
    lora_epilogue_db_plain,
    lora_epilogue_dz,
    lora_epilogue_dz_plain,
    lora_epilogue_fwd,
    lora_epilogue_plain,
)
from phantom_vlb_tpu_torch.ops.lora_fused import (
    LORA_DA,
    LORA_DX,
    LORA_FWD,
    dropout_threshold,
    fused_dropout_bwd,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
)
from phantom_vlb_tpu_torch.ops.quant import quantize_state_dict
from phantom_vlb_tpu_torch.ops.ring_fused import RING_FWD, ring_fwd, ring_fwd_plain
from phantom_vlb_tpu_torch.ops.rowquant import (
    ROW_QUANT,
    ROW_QUANT_SCALED,
    row_quant,
    row_quant_plain,
    row_quant_scaled,
)
from phantom_vlb_tpu_torch.train.loop import train_batches
from phantom_vlb_tpu_torch.train.optim import AdamWCosine
from phantom_vlb_tpu_torch.train.step import loss_fn

SEED = 0
BATCH = 5                 # configs/experiment/vlb_friends_baseline.yaml
LORA_BATCH = 3            # configs/experiment/vlb_friends_lora.yaml:14
N_BATCHES = 3
HQ, HKV, D = 32, 8, 128
LORA_M, LORA_KS, LORA_R, LORA_P = LORA_BATCH * 2048, (4096, 14336), 16, 0.1
EPI_NS = (1024, 4096, 14336)   # k/v, q/o/down, gate/up output widths
KERNELS = {"flash_fwd": FLASH_FWD, "flash_bwd_prep": FLASH_BWD_PREP, "flash_bwd": FLASH_BWD,
           "flash_bwd_post": FLASH_BWD_POST,
           "lora_fwd": LORA_FWD, "lora_dx": LORA_DX, "lora_da": LORA_DA,
           "row_quant": ROW_QUANT, "row_quant_scaled": ROW_QUANT_SCALED,
           "epi_fwd": EPI_FWD, "epi_dz": EPI_DZ, "epi_db": EPI_DB, "ring_fwd": RING_FWD}
# flash_bwd.cu built with each of its cost probes (see its header): the main
# kernel without a part, or in another block order; timed in phase 11 only.
BWD_PROBES = {name: CudaKernel("flash_bwd.cu", "flash_bwd_launch", FLASH_BWD.argtypes,
                               defines=(f"FLASH_BWD_PROBE_{name.upper()}",))
              for name in ("no_dq_reduce", "no_exp", "grouped")}
REPLACES = {
    "flash_fwd": ("flash_fwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:93"),
    "flash_bwd_prep": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:509"),
    "flash_bwd": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:284"),
    "flash_bwd_post": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:351"),
    "lora_fwd": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:62"),
    "lora_dx": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:92"),
    "lora_da": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:111"),
    "row_quant": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:35"),
    "row_quant_scaled": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:45"),
    "epi_fwd": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:45"),
    "epi_dz": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:51"),
    "epi_db": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:69"),
    "ring_fwd": ("ring_fwd.cu", "phantom_vlb_tpu/ops/ring_fused.py:48"),
}
RING_RANKS = 4            # the sequence ring on one card: S_loc = 512 at S = 2048
# bf16 kernel vs f32 plain on the same bf16 inputs (q pre-scaled in bf16 on
# both sides): out is bf16 (2^-8 relative at |out| <= ~1, plus bf16 P in the
# PV product); lse sums f32 scores that differ only in order.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
# Flash backward vs its plain version, max|err| / max|ref| of dq, dk, dv:
# bf16 outputs (2^-9) and bf16 p and ds, whose roundings may flip where the
# kernel's exp2 and the plain exp differ by an ulp.
BWD_REL_TOL = 2e-2
# The backward's prep kernel's di against its plain version, max|err| /
# max|ref|: f32 sums of 128 products in another order (~128 * 2^-24).
DI_REL_TOL = 1e-5
# Kernels of the backward, by the names the profiler gives them.
BWD_PARTS = {"flash_bwd_prep": "flash_bwd_prep_kernel", "flash_bwd": "flash_bwd_kernel",
             "flash_bwd_post": "flash_bwd_post_kernel"}
# LoRA kernels vs plain, max|err| / max|ref|: mid and dx are bf16 (one
# rounding after f32 sums in another order), dA is f32 (order only).
MID_REL_TOL, DX_REL_TOL, DA_REL_TOL = 1e-2, 1e-2, 1e-3
KEEP_RATE_TOL = 1e-3
# Narrow bf16 model on the card vs the same weights in f32 on the CPU: two
# layers of bf16 activations (2^-8 relative each) ahead of an f32 head whose
# predictions have unit scale.
PRED_TOL = 1e-1
# The same for one LoRA step, as |err| / |ref| of the loss and max|err| /
# max|ref| over all adapter gradients: bf16 activations and gradients
# through two layers, and the dropout scale 1/keep rounded to bf16 on the
# card (1.109375) but not in f32 (1.113043).
LORA_LOSS_TOL, LORA_GRAD_TOL = 1e-3, 5e-2
# Epilogue kernels vs plain, max|err| / max|ref|: bf16 outputs after f32
# sums in another order (the forward also rounds acc and acc * s to bf16).
EPI_REL_TOL = 1e-2
# Narrow w8a8g8 LoRA step, card (bf16) vs CPU (f32) on the same int8
# weights: the loss as |err| / |ref|, each adapter gradient by its cosine
# (the bound of tests/test_quant.py:227-276 for int8 against exact dx): the
# activations' int8 codes differ where bf16 and f32 values straddle a .5.
W8_LOSS_TOL, W8_GRAD_COS = 5e-3, 0.98
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 outside
# them, and HBM3.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 989e12, 67e12, 3.35e12
# Serving through the fused ring against phase 5's predictions for the same
# batch, max|err| / max|pred|: the two attentions sum in another order and
# round their bf16 outputs differently, through 32 bf16 layers ahead of
# the f32 head.
RING_PRED_TOL = 5e-2
# A ring LoRA step's first loss and gradient norm against phase 7's, |err| /
# |ref|: the same weights, batch and dropout masks; only the attention's
# summation order and bf16 roundings differ (and the flash backward's dq
# reduce-adds sum in a run-dependent order).
RING_STEP_TOL = 2e-2
HOST_RSS_LIMIT_GB = 8.0
GEMM_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
INT8_GEMM_MARKERS = ("s8", "i8", "imma", "int8")


def host_rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 1e9


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9   # KiB on Linux


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    yield
    release_host_memory(collect=True)
    peak_gb = peak_rss_gb()
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s (host RSS now {host_rss_gb():.2f} GB, "
          f"peak so far {peak_gb:.2f} GB)", flush=True)


def release_host_memory(collect: bool = False) -> None:
    """Hand freed heap back to the OS (glibc's malloc_trim): profiler
    sessions leave much of it in malloc's free lists, and the phases after
    them would otherwise stack on that for the peak RSS."""
    if collect:
        gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    kernels = [*KERNELS.values(), *BWD_PROBES.values()]
    builds = {}                                          # one kernel per build
    for kernel in kernels:
        builds.setdefault(kernel.target, kernel)
    build_all(list(builds))
    for kernel in kernels:
        kernel.load()
    for target, kernel in builds.items():
        report = [ln.split("info    : ")[-1].strip() for ln in kernel.build_log.splitlines()
                  if ("Used" in ln and "registers" in ln) or "spill" in ln]
        probe = "".join(f" -D{d}" for d in target[1]) if isinstance(target, tuple) else ""
        print(f"  {kernel.source.name}{probe}: " + " | ".join(report or ["cached"]))
        spills = [ln for ln in report
                  if "spill" in ln and not ln.startswith("0 bytes stack frame, 0 bytes spill")]
        if target == FLASH_BWD.target and spills:
            raise AssertionError(f"flash_bwd.cu spills: {spills}")


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def attention_inputs(b: int, s: int, gen: torch.Generator, dev, hq: int = HQ, hkv: int = HKV,
                     valid: list[int] | None = None):
    q = torch.randn(b, s, hq * D, generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, s, hkv * D, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, s, hkv * D, generator=gen, device=dev, dtype=torch.bfloat16)
    # Right padding of varied length per row, as the text padding gives.
    valid = torch.tensor(valid or [s - (s * i) // (2 * b) for i in range(b)], device=dev)
    kv_mask = (torch.arange(s, device=dev)[None] < valid[:, None]).int()
    return q, k, v, kv_mask


def check_bwd_parts(q, out, do, lse, hq: int, label: str) -> tuple[float, float]:
    """The backward's prep kernel (q_s and the padded lse bit for bit, di
    within DI_REL_TOL, the accumulator zeroed) and post kernel (both forms
    bit for bit) against their plain versions; returns their max abs
    errors (q_s and di; dq)."""
    got, want = flash_bwd_prep(q, out, do, lse, hq), flash_bwd_prep_plain(q, out, do, lse, hq)
    acc = torch.randn(want.acc.shape, generator=torch.Generator(device=q.device).manual_seed(5),
                      device=q.device)
    dq32 = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(6), device=q.device)
    scale = D ** -0.5
    acc2, dq32_2 = acc.clone(), dq32.clone()
    post, post_ref = flash_bwd_post(acc, q.shape[1], scale), flash_bwd_post_plain(acc, q.shape[1], scale)
    flash_bwd_post(acc, q.shape[1], scale, dq32=dq32)
    flash_bwd_post_plain(acc2, q.shape[1], scale, dq32=dq32_2)
    torch.cuda.synchronize()
    same = {"q_s": torch.equal(got.qs, want.qs), "lse": torch.equal(got.lse, want.lse),
            "acc zero": bool((got.acc == 0).all()), "post": torch.equal(post, post_ref),
            "post accumulate": torch.equal(dq32, dq32_2) and torch.equal(acc, acc2)}
    di_rel = rel_err(got.di, want.di)
    print(f"  flash_bwd prep/post {label}: bit-equal {same}; di max|err|/max|ref| {di_rel:.3e} "
          f"(tol {DI_REL_TOL})")
    if not (all(same.values()) and di_rel <= DI_REL_TOL):
        raise AssertionError(f"the backward's prep or post kernel disagrees with its plain version at {label}")
    return max(abs_err(got.qs, want.qs), abs_err(got.di, want.di)), abs_err(post, post_ref)


def check_flash(b: int, s: int, gen, dev, causal_offset: int = 0, hq: int = HQ,
                hkv: int = HKV, valid: list[int] | None = None) -> tuple[float, float, tuple[float, float]]:
    """Forward and backward kernels vs plain (f32) on one input; returns the
    forward's out max abs error, the backward's over dq, dk, dv, and the
    prep's and post's (check_bwd_parts)."""
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev, hq, hkv, valid)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=kv_mask, causal_offset=causal_offset)
    do = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    grads = attention_packed_bwd(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask,
                                 causal_offset=causal_offset)
    torch.cuda.synchronize()
    # The kernel pre-scales q in bf16; give the plain version that same q.
    q_s = q * torch.tensor(D ** -0.5, dtype=torch.bfloat16, device=dev)
    out_ref, lse_ref = attention_packed_plain(
        q_s.float(), k.float(), v.float(), hq, hkv, sm_scale=1.0, kv_mask=kv_mask,
        causal_offset=causal_offset,
    )
    out_err, lse_err = abs_err(out, out_ref), abs_err(lse, lse_ref)
    label = f"B={b} S={s}" + (f" heads {hq}/{hkv}" if (hq, hkv) != (HQ, HKV) else "") + (
        f" causal_offset={causal_offset}" if causal_offset else "") + (f" valid {valid}" if valid else "")
    print(f"  flash_fwd {label}: out max|err| {out_err:.3e} (tol {OUT_TOL}), "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL})")
    if not (out_err <= OUT_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"flash_fwd disagrees with its plain version at {label}")
    del out_ref, lse_ref
    refs = attention_packed_bwd_plain(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask,
                                      causal_offset=causal_offset)
    rels = [rel_err(g, r) for g, r in zip(grads, refs)]
    bwd_err = max(abs_err(g, r) for g, r in zip(grads, refs))
    print(f"  flash_bwd {label}: max|err|/max|ref| dq {rels[0]:.3e}, dk {rels[1]:.3e}, "
          f"dv {rels[2]:.3e} (tol {BWD_REL_TOL}); max|err| {bwd_err:.3e}")
    if not max(rels) <= BWD_REL_TOL:
        raise AssertionError(f"flash_bwd disagrees with its plain version at {label}")
    del refs, grads
    return out_err, bwd_err, check_bwd_parts(q, out, do, lse, hq, label)


def check_ring(gen, dev) -> float:
    """The fused ring kernel vs its plain version (the same bf16 roundings:
    q pre-scaled and P cast to bf16; sums in another order) on rings of
    RING_RANKS and 2 ranks of the card at (3, 2048), with the right padding
    of attention_inputs and without a kv mask, and at S = 1000 on 2 ranks
    (S_loc 500, not a multiple of 64). Tolerances are the flash forward's:
    out 2e-2 absolute and as max|err| / max|ref| (bf16 out, 2^-8 relative at
    |out| <= ~1, and bf16 P), lse 1e-3 (f32, order only). Returns the out's
    max abs error."""
    worst = 0.0
    for n, s, masked in ((RING_RANKS, 2048, True), (RING_RANKS, 2048, False), (2, 2048, True),
                         (2, 2048, False), (2, 1000, True)):
        q, k, v, kv_mask = attention_inputs(LORA_BATCH, s, gen, dev)
        kv_mask = kv_mask if masked else None
        ring = SequenceRing([dev] * n)
        out, lse = ring_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)
        torch.cuda.synchronize()
        out_ref, lse_ref = ring_fwd_plain(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)
        rel, err, lse_err = rel_err(out, out_ref), abs_err(out, out_ref), abs_err(lse, lse_ref)
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        print(f"  ring_fwd n={n} B={LORA_BATCH} S={s} {'padded' if masked else 'no mask'}: out "
              f"max|err|/max|ref| {rel:.3e}, max|err| {err:.3e} (tol {OUT_TOL}), lse max|err| "
              f"{lse_err:.3e} (tol {LSE_TOL}), finite {finite}")
        if not (rel <= OUT_TOL and err <= OUT_TOL and lse_err <= LSE_TOL and finite):
            raise AssertionError(f"ring_fwd disagrees with its plain version at n={n} S={s}")
        worst = max(worst, err)
        del q, k, v, out, lse, out_ref, lse_ref
    return worst


def lora_inputs(k: int, gen, dev):
    x = torch.randn(LORA_M, k, generator=gen, device=dev, dtype=torch.bfloat16)
    a = (k ** -0.5 * torch.randn(k, LORA_R, generator=gen, device=dev)).to(torch.bfloat16)
    dmid = torch.randn(LORA_M, LORA_R, generator=gen, device=dev, dtype=torch.bfloat16)
    return x, a, dmid


def check_lora(k: int, gen, dev) -> dict[str, float]:
    """The three kernels vs plain at (6144, k), r 16, p 0.1, in bits mode and
    in hash mode; returns each kernel's max abs error (bits mode)."""
    thr, keep = dropout_threshold(LORA_P)
    x, a, dmid = lora_inputs(k, gen, dev)
    bits = torch.randint(0, 256, x.shape, generator=gen, device=dev, dtype=torch.uint8)
    errs = {}
    for mode, b, seed in (("bits", bits, 0), ("hash", None, 1234)):
        mid = fused_dropout_matmul(x, a, seed, LORA_P, bits=b)
        dx, da = fused_dropout_bwd(x, a, dmid, seed, LORA_P, bits=b)
        torch.cuda.synchronize()
        mid_ref = fused_dropout_matmul_plain(x, a, seed, thr, b)
        dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, seed, thr, b)
        rels = (rel_err(mid, mid_ref), rel_err(dx, dx_ref), rel_err(da, da_ref))
        # dx is exactly 0 wherever the mask drops (bits or hash bytes below
        # thr); both masks are also read back exactly below.
        drops = (hash_bytes(seed, LORA_M, k, dev) if b is None else b) < thr
        zero_drops = bool((dx[drops] == 0).all())
        print(f"  lora K={k} {mode}: max|err|/max|ref| fwd {rels[0]:.3e} (tol {MID_REL_TOL}), "
              f"dx {rels[1]:.3e} (tol {DX_REL_TOL}), dA {rels[2]:.3e} (tol {DA_REL_TOL}); "
              f"dx exactly 0 at the {int(drops.sum())} dropped elements: {zero_drops}")
        if not (rels[0] <= MID_REL_TOL and rels[1] <= DX_REL_TOL and rels[2] <= DA_REL_TOL and zero_drops):
            raise AssertionError(f"LoRA kernels disagree with their plain versions ({mode}, K={k})")
        if mode == "bits":
            errs = {"lora_fwd": abs_err(mid, mid_ref), "lora_dx": abs_err(dx, dx_ref),
                    "lora_da": abs_err(da, da_ref)}
        del mid_ref, dx_ref, da_ref
    # The hash and bits masks read back exactly: dmid = e0 rows and A = e0
    # columns make dmid @ A^T all ones, so dx = mask / keep.
    e_a = torch.zeros_like(a)
    e_a[:, 0] = 1
    e_d = torch.zeros_like(dmid)
    e_d[:, 0] = 1
    masks = {}
    for seed in (1234, 1234, 99):
        dx, _ = fused_dropout_bwd(x, e_a, e_d, seed, LORA_P, need_da=False)
        masks.setdefault(seed, []).append(dx != 0)
    plain = hash_bytes(1234, LORA_M, k, dev) >= thr
    mismatches = int((masks[1234][0] != plain).sum())
    dx, _ = fused_dropout_bwd(x, e_a, e_d, 0, LORA_P, bits=bits, need_da=False)
    bits_mismatches = int(((dx != 0) != (bits >= thr)).sum())
    rate = masks[1234][0].float().mean().item()
    same = bool(torch.equal(masks[1234][0], masks[1234][1]))
    differ = (masks[1234][0] != masks[99][0]).float().mean().item()
    print(f"  lora K={k} hash mask via dx: {mismatches} mismatches with the plain hash, keep rate "
          f"{rate:.6f} (want {keep:.6f} +- {KEEP_RATE_TOL}), same seed same mask {same}, "
          f"another seed differs in {differ:.4f} of elements; bits mask via dx: "
          f"{bits_mismatches} mismatches")
    if (mismatches or bits_mismatches or abs(rate - keep) > KEEP_RATE_TOL or not same
            or differ < 0.1):
        raise AssertionError(f"LoRA dropout mask is not exact, at its rate or deterministic (K={k})")
    return errs


def check_row_quant(gen, dev) -> dict[str, float]:
    """Both entry points vs plain, bit for bit: bf16 at (6144, 4096) and
    (6144, 14336) with a zero row, and 6141 rows (not a multiple of 8);
    returns each entry point's max abs error over q (as float)."""
    errs = {"row_quant": 0.0, "row_quant_scaled": 0.0}
    for rows, n in ((LORA_M, LORA_KS[0]), (LORA_M, LORA_KS[1]), (LORA_M - 3, LORA_KS[0])):
        x = (3 * torch.randn(rows, n, generator=gen, device=dev)).to(torch.bfloat16)
        x[rows // 3] = 0
        w = torch.rand(n, generator=gen, device=dev) * 2 + 0.01
        for name, got, want in (("row_quant", row_quant(x), row_quant_plain(x)),
                                ("row_quant_scaled", row_quant_scaled(x, w), row_quant_plain(x, w))):
            torch.cuda.synchronize()
            q_mis = int((got[0] != want[0]).sum())
            s_same = bool(torch.equal(got[1], want[1]))
            floor = got[1][rows // 3].item()
            print(f"  {name} ({rows}, {n}) bf16: {q_mis} q mismatches, s bit-equal {s_same}, "
                  f"zero row's s {floor:.3e}")
            if q_mis or not s_same or floor != torch.tensor(1e-12).item():
                raise AssertionError(f"{name} disagrees with its plain version at ({rows}, {n})")
            errs[name] = max(errs[name], abs_err(got[0], want[0]))
    return errs


def epilogue_inputs(n: int, gen, dev):
    y = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
    z = torch.randn(LORA_M, LORA_R, generator=gen, device=dev, dtype=torch.bfloat16)
    b = (0.05 * torch.randn(LORA_R, n, generator=gen, device=dev)).to(torch.bfloat16)
    dy = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
    return y, z, b, dy


def check_epilogue(gen, dev) -> dict[str, float]:
    """Forward, dz and dB vs plain at M = 6144, r = 16, N = 1024, 4096,
    14336; returns each kernel's max abs error."""
    errs = {"epi_fwd": 0.0, "epi_dz": 0.0, "epi_db": 0.0}
    scaling = 32.0 / LORA_R
    for n in EPI_NS:
        y, z, b, dy = epilogue_inputs(n, gen, dev)
        got = {"epi_fwd": lora_epilogue_fwd(y, z, b, scaling), "epi_dz": lora_epilogue_dz(dy, b, scaling),
               "epi_db": lora_epilogue_db(z, dy, scaling)}
        torch.cuda.synchronize()
        want = {"epi_fwd": lora_epilogue_plain(y, z, b, scaling),
                "epi_dz": lora_epilogue_dz_plain(dy, b, scaling),
                "epi_db": lora_epilogue_db_plain(z, dy, scaling)}
        rels = {k: rel_err(got[k], want[k]) for k in got}
        print(f"  epilogue N={n}: max|err|/max|ref| " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (tol {EPI_REL_TOL})")
        if max(rels.values()) > EPI_REL_TOL or not all(torch.isfinite(g).all() for g in got.values()):
            raise AssertionError(f"the epilogue kernels disagree with their plain versions at N={n}")
        for k in got:
            errs[k] = max(errs[k], abs_err(got[k], want[k]))
    return errs


def check_predictions(res: dict, rows: int, num_target: int) -> None:
    pred = res["predicted"]
    if pred.shape != (rows, num_target) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions {pred.shape}, finite={np.isfinite(pred).all()}")
    if not (np.isfinite(res["brain_loss"]).all() and np.isfinite(res["val_corr_roi"]).all()):
        raise AssertionError("non-finite loss or correlation")


def kernel_group(name: str) -> str:
    for group in ("flash_fwd", "flash_bwd", "ring_fwd"):
        if group in name:
            return group
    if "lora_" in name:
        return "lora"
    if "row_quant" in name:
        return "row_quant"
    if "epi_" in name:
        return "epilogue"
    low = name.lower()
    if any(m in low for m in GEMM_MARKERS):
        return "gemm_int8" if any(m in low for m in INT8_GEMM_MARKERS) else "gemm"
    return "other"


def traced(fn, label: str) -> None:
    """Trace ``fn()`` on a warm model: device time by kernel and by group,
    and the idle share of its wall time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels),
                       key=lambda x: -x[1])
    groups: dict[str, float] = {}
    for name, ms, _ in by_kernel:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    busy_ms = sum(groups.values())
    print(f"  traced {label} wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          + (f"{1.0 - busy_ms / wall_ms:.4f}" if busy_ms else "not measured (no device events)"))
    for name, ms, count in by_kernel[:14]:
        print(f"  {ms:10.3f} ms  x{count:<5d} ({ms / count:.4f} ms each) {name[:100]}")
    for group, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  group {group:9s} {ms:10.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device time)")
    del prof, kernels
    release_host_memory(collect=True)


def serve_through_the_ring(model, batch: dict, want: np.ndarray, dev) -> None:
    """Phase 5's last batch again on the same model switched to the fused
    ring on RING_RANKS ranks of the card: launch counts and predictions."""
    set_sequence_ring(SequenceRing([dev] * RING_RANKS))
    set_attention_impl(model, "ring_fused")
    try:
        torch.cuda.synchronize()
        reset_launches()
        res = predict_batches(model, [batch], dev)
        launches = read_launches()
    finally:
        set_attention_impl(model, "auto")
        set_sequence_ring(None)
    check_predictions(res, BATCH, model.cfg.num_target)
    err = np.abs(res["predicted"] - want).max() / np.abs(want).max()
    print(f"  batch ms {[round(float(x), 3) for x in res['batch_ms']]}, launches {launches}; "
          f"predictions max|ring - phase 5| / max|phase 5| {err:.3e} (tol {RING_PRED_TOL})")
    layers = model.cfg.mistral.num_hidden_layers
    want_launches = {n: (layers * RING_RANKS if n == "ring_fwd" else 0) for n in KERNELS}
    if launches != want_launches:
        raise AssertionError(f"serving through the ring launched {launches}, want {want_launches}")
    if not err <= RING_PRED_TOL:
        raise AssertionError("predictions through the fused ring disagree with the flash path's")


def lora_train_config(mistral: MistralConfig | None = None, fused_epilogue: str = "",
                      base_quant: str | None = None, **overrides) -> VLBConfig:
    """The reference's LoRA recipe with the fused u8 dropout the bench runs."""
    lora = LoRAConfig(rank=16, alpha=32.0, dropout=LORA_P, dropout_bits=8, fused_dropout=True,
                      fused_epilogue=fused_epilogue)
    if mistral is None:
        mistral = MistralConfig.full(lora=lora, remat=True, base_quant=base_quant)
    return VLBConfig.full(use_lora=True, mistral=mistral, **overrides)


def expected_train_launches(layers: int, steps: int, epilogue: bool = False,
                            int8: bool = False, ring: str | None = None) -> dict[str, int]:
    """What one LoRA step launches with remat per layer: every layer's forward
    runs twice (the pass and its replay in the backward), so 2 flash forwards
    and 2 x 7 LoRA forwards (and, with the int8 base, row quants; with the
    fused epilogue, epilogue forwards); one flash backward; 7 dA (7 dz and
    7 dB); and 7 dx (7 scaled row quants) except for layer 0's q, k and v,
    whose input (the normed embeddings) needs no gradient. A flash backward
    is a prep, a main kernel and a post. Through a ring of n = RING_RANKS
    ranks a layer's attention pass is n ring kernels ('ring_fused') or
    n(n+1)/2 offset flash forwards ('ring_flash': the steps from later ranks
    are skipped), and its backward one prep per rank and a main kernel and a
    post (accumulate form) per step, n(n+1)/2 of each."""
    pairs = RING_RANKS * (RING_RANKS + 1) // 2
    ring_bwd = {"flash_bwd_prep": RING_RANKS * layers, "flash_bwd": pairs * layers,
                "flash_bwd_post": pairs * layers}
    attn = {None: {"flash_fwd": 2 * layers, "flash_bwd_prep": layers, "flash_bwd": layers,
                   "flash_bwd_post": layers, "ring_fwd": 0},
            "ring_fused": {"flash_fwd": 0, **ring_bwd, "ring_fwd": 2 * RING_RANKS * layers},
            "ring_flash": {"flash_fwd": 2 * pairs * layers, **ring_bwd, "ring_fwd": 0}}[ring]
    per_step = {**attn,
                "lora_fwd": 14 * layers, "lora_dx": 7 * layers - 3, "lora_da": 7 * layers,
                "row_quant": 14 * layers if int8 else 0,
                "row_quant_scaled": 7 * layers - 3 if int8 else 0,
                "epi_fwd": 14 * layers if epilogue else 0, "epi_dz": 7 * layers if epilogue else 0,
                "epi_db": 7 * layers if epilogue else 0}
    return {name: per_step[name] * steps for name in KERNELS}


def grad_of(model, name: str) -> torch.Tensor:
    return dict(model.named_parameters())[name].grad


@dataclasses.dataclass
class LoraRun:
    launches: dict
    step_ms: list
    loss: list
    norm: list
    one_more_step: object


def train_lora_steps(cfg: VLBConfig, sd: dict, batches: list, dev, fresh: bool,
                     steps: int = N_BATCHES) -> LoraRun:
    """``steps`` steps of ``train_batches`` at batch 3 on ``sd``'s tensors
    (assigned, not copied), with the launch counts the code implies and
    gradients on layer 0's adapters: from fresh adapters (lora_b = 0)
    lora_b's is non-zero and lora_a's exactly 0 at step 1 and non-zero at
    step 2; otherwise both are non-zero from step 1. The run's record holds
    a closure that runs one more step."""
    model = VideoLLaMA2VLB.from_state_dict(cfg, sd)
    optimizer = AdamWCosine(trainable_parameters(model))
    n_train = sum(p.numel() for p in optimizer.params)
    mcfg = cfg.mistral
    ring = None if mcfg.attention_impl == "auto" else mcfg.attention_impl
    print(f"  {mcfg.num_hidden_layers} layers, base {mcfg.base_quant or 'bf16'}, fused epilogue "
          f"{mcfg.lora.fused_epilogue or 'off'}, attention {mcfg.attention_impl}"
          + (f" on {RING_RANKS} ranks of the card" if ring else "")
          + f", {n_train / 1e6:.3f} M trainable ({len(optimizer.params)} tensors), batch {LORA_BATCH}")
    seeds = torch.Generator().manual_seed(SEED)
    q_a, q_b = (f"model.layers.0.self_attn.q_proj.lora_{x}" for x in "ab")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for step in range(steps):
        runs.append(train_batches(model, [batches[step]], device=dev, generator=seeds,
                                  optimizer=optimizer))
        ga, gb = grad_of(model, q_a), grad_of(model, q_b)
        print(f"  step {step + 1}: |grad| layer 0 q_proj lora_a {ga.norm().item():.4e}, "
              f"lora_b {gb.norm().item():.4e}")
        if not (gb.abs().max() > 0 and torch.isfinite(gb).all() and torch.isfinite(ga).all()):
            raise AssertionError(f"step {step + 1}: layer 0's lora_b needs a non-zero finite gradient")
        if fresh and step == 0 and ga.abs().max() != 0:
            raise AssertionError("step 1: with lora_b = 0, layer 0's lora_a gradient must be exactly 0")
        if (step >= 1 or not fresh) and not ga.abs().max() > 0:
            raise AssertionError(f"step {step + 1}: layer 0's lora_a needs a non-zero gradient")
    launches = read_launches()
    step_ms = [float(r["step_ms"][0]) for r in runs]
    loss = [float(r["brain_loss"][0]) for r in runs]
    norm = [float(r["grad_norm"][0]) for r in runs]
    print(f"  step ms {[round(x, 3) for x in step_ms]}, brain_loss {[round(x, 5) for x in loss]}, "
          f"grad norm {[round(x, 5) for x in norm]}, launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not np.isfinite(loss + norm).all():
        raise AssertionError("non-finite LoRA training loss or gradient norm")
    expected = expected_train_launches(mcfg.num_hidden_layers, steps,
                                       epilogue=bool(mcfg.lora.fused_epilogue),
                                       int8=mcfg.base_quant is not None, ring=ring)
    if launches != expected:
        raise AssertionError(f"LoRA training launched {launches}, want {expected}")
    if steps > 1:
        print(f"  clips/s at batch {LORA_BATCH} (steps 2-{steps}): "
              f"{[round(LORA_BATCH / (x / 1e3), 3) for x in step_ms[1:]]}")

    def one_more_step():
        train_batches(model, [batches[-1]], device=dev, generator=seeds, optimizer=optimizer)

    return LoraRun(launches, step_ms, loss, norm, one_more_step)


def lora_batches(cfg: VLBConfig, gen, dev) -> list:
    return synthetic_batches(cfg, N_BATCHES + 1, LORA_BATCH, np.random.default_rng(SEED), gen, dev)


def train_through_the_ring(sd: dict, start: dict, batches: list, first: LoraRun, dev) -> dict[str, int]:
    """Phase 7's starting adapters and head again (``start``), on the same
    bf16 weights and batches: 3 steps through the fused ring (and one more
    under ``torch.profiler``) and 2 through the per-step flash ring on
    RING_RANKS ranks of the card. Each first step's loss and gradient norm
    are held against phase 7's. Returns the fused ring run's launch
    counts."""
    set_sequence_ring(SequenceRing([dev] * RING_RANKS))
    runs = {}
    try:
        for impl, steps in (("ring_fused", N_BATCHES), ("ring_flash", 2)):
            with phase(f"8c LoRA train through the {impl} ring at full width"):
                for key, t in start.items():
                    sd[key].copy_(t)
                mistral = dataclasses.replace(lora_train_config().mistral, attention_impl=impl)
                run = train_lora_steps(lora_train_config(mistral), sd, batches, dev, fresh=True,
                                       steps=steps)
                loss_rel = abs(run.loss[0] - first.loss[0]) / abs(first.loss[0])
                norm_rel = abs(run.norm[0] - first.norm[0]) / abs(first.norm[0])
                print(f"  step 1 against phase 7's: brain_loss {run.loss[0]:.6f} vs {first.loss[0]:.6f} "
                      f"(|err|/|ref| {loss_rel:.3e}), grad norm {run.norm[0]:.6f} vs {first.norm[0]:.6f} "
                      f"({norm_rel:.3e}); tol {RING_STEP_TOL}")
                print(f"  step ms {[round(x, 3) for x in run.step_ms]} through the ring, "
                      f"{[round(x, 3) for x in first.step_ms[:steps]]} in phase 7 (flash, one run)")
                if not (loss_rel <= RING_STEP_TOL and norm_rel <= RING_STEP_TOL):
                    raise AssertionError(f"the {impl} LoRA step disagrees with the flash step")
                if impl == "ring_fused":
                    traced(run.one_more_step, "LoRA train step through the fused ring")
                run.one_more_step = None
                runs[impl] = run
                torch.cuda.empty_cache()
    finally:
        set_sequence_ring(None)
    return runs["ring_fused"].launches


def train_lora_full(gen, dev) -> tuple[dict[str, int], dict[str, int]]:
    """Phases 7, 8, 8c and 8b on one set of full-width weights: bf16 without
    and with the fused epilogue, through the rings, then quantized in place
    for the w8a8g8 step. Returns the w8a8g8 run's launch counts (every
    kernel but the ring's) and the fused ring run's."""
    cfg = lora_train_config()
    sd = init_params(cfg, dev, gen)
    start = {key: t.clone() for key, t in sd.items() if trainable_predicate(key)}
    batches = lora_batches(cfg, gen, dev)
    first = train_lora_steps(cfg, sd, batches, dev, fresh=True)
    with phase("8 profile one LoRA step"):
        traced(first.one_more_step, "LoRA train step")
        first.one_more_step = None
        torch.cuda.empty_cache()
    with phase("8 LoRA train with the fused epilogue"):
        on = train_lora_steps(lora_train_config(fused_epilogue="pallas"), sd, lora_batches(cfg, gen, dev),
                              dev, fresh=False)
        print(f"  step ms with the fused epilogue off {[round(x, 3) for x in first.step_ms[1:]]}, "
              f"on {[round(x, 3) for x in on.step_ms[1:]]} (steps 2-3, one run)")
        del on
        torch.cuda.empty_cache()
    ring_launches = train_through_the_ring(sd, start, batches, first, dev)
    del start, batches
    with phase("8b w8a8g8 LoRA train at full width"):
        t0 = time.perf_counter()
        quantize_state_dict(sd)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = [t for k, t in sd.items() if k.endswith((".weight_q", ".weight_scale"))]
        print(f"  quantized {len(base) // 2} projections on the card in place in "
              f"{time.perf_counter() - t0:.2f} s: int8 base {sum(t.numel() * t.element_size() for t in base) / 1e9:.2f} GB, "
              f"device memory now {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        del base
        cfg8 = lora_train_config(fused_epilogue="pallas", base_quant="w8a8g8")
        w8 = train_lora_steps(cfg8, sd, lora_batches(cfg, gen, dev), dev, fresh=False)
    with phase("8b profile one w8a8g8 LoRA step"):
        traced(w8.one_more_step, "w8a8g8 LoRA train step")
    return w8.launches, ring_launches


def train_baseline_full(gen, dev) -> None:
    cfg = VLBConfig.full()
    model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
    batches = synthetic_batches(cfg, N_BATCHES, BATCH, np.random.default_rng(SEED), gen, dev)
    torch.cuda.synchronize()
    reset_launches()
    res = train_batches(model, batches, device=dev, generator=torch.Generator().manual_seed(SEED))
    launches = read_launches()
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  {n_train} trainable (head only), step ms {[round(float(x), 3) for x in res['step_ms']]}, "
          f"brain_loss {[round(float(x), 5) for x in res['brain_loss']]}, launches {launches}")
    want = {n: (cfg.mistral.num_hidden_layers * N_BATCHES if n == "flash_fwd" else 0) for n in KERNELS}
    if launches != want or not np.isfinite(res["brain_loss"]).all():
        raise AssertionError(f"baseline training: launches {launches} (want {want}), "
                             f"loss {res['brain_loss']}")


def narrow_mistral(dtype, lora=None) -> MistralConfig:
    return MistralConfig.tiny(
        vocab_size=32000, hidden_size=256, intermediate_size=512, num_attention_heads=2,
        num_key_value_heads=1, head_dim=D, dtype=dtype, lora=lora, remat=lora is not None,
    )


def narrow_reference_check(gen, dev) -> None:
    """A 2-layer, 256-wide model at the serving geometry: card (bf16, kernels)
    against the same weights in f32 on the CPU (plain versions)."""
    cfg = VLBConfig.full(mistral=narrow_mistral(torch.bfloat16))
    sd = init_params(cfg, dev, gen)
    batches = synthetic_batches(cfg, 1, 2, np.random.default_rng(SEED), gen, dev)
    card = predict_batches(VideoLLaMA2VLB.from_state_dict(cfg, sd), batches, dev)
    cfg32 = dataclasses.replace(cfg, mistral=narrow_mistral(torch.float32))
    cpu_model = VideoLLaMA2VLB.from_state_dict(cfg32, sd, device="cpu")
    cpu_batches = [{k: torch.as_tensor(v).cpu() for k, v in bt.items()} for bt in batches]
    ref = predict_batches(cpu_model, cpu_batches, "cpu")
    check_predictions(card, 2, cfg.num_target)
    err = np.abs(card["predicted"] - ref["predicted"]).max()
    scale = np.abs(ref["predicted"]).max()
    print(f"  narrow model: preds max|card - cpu f32| {err:.3e} (tol {PRED_TOL}), max|pred| {scale:.3f}")
    if not err <= PRED_TOL:
        raise AssertionError("narrow model on the card disagrees with its f32 CPU reference")


def narrow_lora_check(gen, dev, base_quant: str | None = None, attention_impl: str = "auto") -> None:
    """One LoRA step's loss and adapter gradients of the narrow model (fused
    hash dropout at p 0.1, which the CPU's plain version reproduces bit for
    bit; head dropout off, whose mask comes from a device generator). With
    ``base_quant`` the projections are int8 (the same codes and scales on
    both sides) and the epilogue fused, so every kernel of the w8a8g8 path
    runs on the card. With a ring ``attention_impl`` the card's model runs
    it on 2 ranks of the card, against plain attention on the CPU."""
    lora = LoRAConfig(rank=16, alpha=32.0, dropout=LORA_P, dropout_bits=8, fused_dropout=True,
                      fused_epilogue="pallas" if base_quant else "")

    def mistral(dtype, impl="auto"):
        return dataclasses.replace(narrow_mistral(dtype, lora), base_quant=base_quant,
                                   attention_impl=impl)

    cfg = lora_train_config(mistral(torch.bfloat16, attention_impl), dropout_rate=0.0)
    sd = init_params(cfg, dev, gen)
    for key in sd:
        if key.endswith("lora_b"):       # non-zero, so lora_a's gradient is too
            sd[key] = 0.05 * torch.randn(sd[key].shape, generator=gen, device=dev)
    batch = synthetic_batches(cfg, 1, 1, np.random.default_rng(SEED), gen, dev)[0]
    results = []
    set_sequence_ring(SequenceRing([dev] * 2))
    for device, mcfg in ((dev, cfg), ("cpu", dataclasses.replace(cfg, mistral=mistral(torch.float32)))):
        model = VideoLLaMA2VLB.from_state_dict(mcfg, sd, device=device)
        trainable_parameters(model)
        model.train()
        loss = loss_fn(model, {k: torch.as_tensor(v).to(device) for k, v in batch.items()}, seed=77)[0]
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if "lora_" in n}
        results.append((loss.item(), grads))
        del model
    set_sequence_ring(None)
    (loss_c, g_c), (loss_r, g_r) = results
    loss_rel = abs(loss_c - loss_r) / abs(loss_r)
    flat_c = torch.cat([g_c[n].flatten() for n in sorted(g_r)])
    flat_r = torch.cat([g_r[n].flatten() for n in sorted(g_r)])
    grad_rel = rel_err(flat_c, flat_r)
    cos = min(F.cosine_similarity(g_c[n].flatten().double(), g_r[n].flatten().double(), dim=0).item()
              for n in g_r)
    label = f"narrow {base_quant or 'bf16'} LoRA step" + (
        f" through the {attention_impl} ring on 2 ranks" if attention_impl != "auto" else "")
    print(f"  {label}: loss card {loss_c:.6f} cpu f32 {loss_r:.6f} (|err|/|ref| {loss_rel:.3e}); adapter "
          f"grads max|err|/max|ref| {grad_rel:.3e}, least cosine {cos:.6f} over {len(g_r)} tensors, "
          f"max|ref| {flat_r.abs().max().item():.4e}")
    if base_quant:
        ok = loss_rel <= W8_LOSS_TOL and cos >= W8_GRAD_COS
        print(f"  tolerances: loss {W8_LOSS_TOL}, cosine >= {W8_GRAD_COS} for every tensor")
    else:
        ok = loss_rel <= LORA_LOSS_TOL and grad_rel <= LORA_GRAD_TOL
        print(f"  tolerances: loss {LORA_LOSS_TOL}, gradients {LORA_GRAD_TOL}")
    if not (ok and flat_c.abs().max() > 0 and all(g_c[n].abs().max() > 0 for n in g_c)):
        raise AssertionError(f"{label} on the card disagrees with its f32 CPU reference")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_bwd_probes(dev) -> None:
    """The flash backward's main kernel alone, as built and with each cost
    probe, at the training shape and at the ring's step (S_loc, offset
    S_loc): CUDA events over 20 launches on the same inputs, the builds
    taken in turns twice and the lower kept; printed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_loc = REFERENCE_GEOMETRY.feature_len // RING_RANKS
    builds = {"as built": FLASH_BWD, **BWD_PROBES}
    for b, s, offset in ((LORA_BATCH, REFERENCE_GEOMETRY.feature_len, 0), (LORA_BATCH, s_loc, s_loc)):
        q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
        o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=offset)
        do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        bias, inp = kv_bias(kv_mask), flash_bwd_prep(q, o, do, lse, HQ)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for _ in range(2):
            for name, kernel in builds.items():
                times.setdefault(name, []).append(cuda_ms(lambda kernel=kernel: kernel.launch(
                    inp.qs.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                    inp.lse.data_ptr(), inp.di.data_ptr(), inp.acc.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, s, HQ, HKV, inp.lse.shape[-1], offset, stream), 20, warmup=3))
        base = min(times["as built"])
        print(f"  flash_bwd main kernel B={b} S={s} causal_offset={offset}, cost probes (CUDA events): "
              + ", ".join(f"{name} {min(t):.4f} ms ({min(t) - base:+.4f})" for name, t in times.items()))
        del q, k, v, o, lse, do, bias, inp, dk, dv


def traced_kernels(fn, iters: int, kernel: str = "", warmup: int = 2, tries: int = 3) -> dict[str, float]:
    """Device time per call of every kernel ``fn`` launches, by kernel name
    (``torch.profiler``). A session that recorded no device time for the
    kernels whose name holds ``kernel`` (the tracer does drop sessions now
    and then) is measured again, and after ``tries`` such sessions this
    raises."""
    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        del prof
        release_host_memory()
        if kernel_ms(times, kernel) > 0:
            return times
    raise RuntimeError(f"torch.profiler recorded no device time for {kernel or 'the call'} in {tries} sessions")


def kernel_ms(times: dict[str, float], name: str) -> float:
    return sum(t for key, t in times.items() if name in key)


def device_ms(fn, iters: int, kernel: str = "", warmup: int = 2, tries: int = 3) -> tuple[float, float]:
    """Device time per call of the kernels whose name holds ``kernel``, and
    of every kernel the call launches (traced_kernels)."""
    times = traced_kernels(fn, iters, kernel, warmup, tries)
    return kernel_ms(times, kernel), sum(times.values())


def timed(kernel_fn, kernel: str, plain_fn, library_fn, iters: int) -> dict:
    """The kernel's own device time, the device time of everything its
    wrapper, the plain version and the library call launch, and the
    wrapper's CUDA-event time per call (which includes host gaps)."""
    ms, wrapper_ms = device_ms(kernel_fn, iters, kernel)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "wrapper_event_ms": cuda_ms(kernel_fn, iters),
            "plain_ms": device_ms(plain_fn, 2, warmup=1)[1],
            "library_ms": device_ms(library_fn, iters)[1]}


def report(name: str, shape: str, rec: dict, flops: float, nbytes: float,
           peak_flops: float = PEAK_BF16_FLOPS) -> None:
    rec.update(bound(flops, nbytes, peak_flops))
    print(f"  {name} {shape}: kernel {rec['ms']:.4f} ms (wrapper {rec['wrapper_ms']:.4f} ms on the device, "
          f"{rec['wrapper_event_ms']:.4f} ms by CUDA events), plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); {flops / rec['ms'] / 1e9:.1f} TFLOP/s, "
          f"{nbytes / rec['ms'] / 1e6:.1f} GB/s achieved")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_flash(gen, dev) -> dict[str, dict]:
    """Flash forward at the serving shape, backward at the training shape;
    the library is SDPA with the same causal + padding mask (timed only)."""
    out = {}
    s = REFERENCE_GEOMETRY.feature_len

    def keep_mask(kv_mask):
        n = kv_mask.shape[1]
        return torch.ones(n, n, dtype=torch.bool, device=dev).tril()[None, None] & (kv_mask > 0)[:, None, None, :]

    b = BATCH
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2) for t in (q, k, v))
    keep = keep_mask(kv_mask)
    out["flash_fwd"] = timed(
        lambda: attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask), "flash_fwd_kernel",
        lambda: attention_packed_plain(q, k, v, HQ, HKV, kv_mask=kv_mask),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep, enable_gqa=True), 10)
    # q, k, v and the bias row read once; out and lse written once.
    report("flash_fwd", f"B={b} S={s}", out["flash_fwd"], 4 * b * HQ * D * s * (s + 1) // 2,
           (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * HQ * s + b * s) * 4)
    del q, k, v, q4, k4, v4, keep

    b = LORA_BATCH
    out.update(time_flash_bwd(b, s, gen, dev, keep_mask, 10, json_record=True))
    # Where the reference takes its split backward (_dq_kernel + _dkv_kernel,
    # skv > 4096): printed, not in the JSON line.
    time_flash_bwd(1, 4608, gen, dev, keep_mask, 5)
    # A step of the per-step ring: a chunk of S_loc = 512 against an earlier
    # rank's whole chunk (offset S_loc, no mask), by CUDA events; printed.
    b, s = LORA_BATCH, REFERENCE_GEOMETRY.feature_len // RING_RANKS
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=s)
    do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    fwd_ms = cuda_ms(lambda: attention_with_stats(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=s), 20)

    def ring_step_bwd():
        return attention_packed_bwd(q, k, v, o, lse, do, HQ, HKV, kv_mask=kv_mask, causal_offset=s)

    bwd_ms = cuda_ms(ring_step_bwd, 20)
    parts = traced_kernels(ring_step_bwd, 20)
    print(f"  flash_fwd / flash_bwd B={b} S={s} causal_offset={s}: {fwd_ms:.4f} / {bwd_ms:.4f} ms per "
          f"call (CUDA events, wrappers included); backward device time: "
          + ", ".join(f"{name} {kernel_ms(parts, kernel):.4f}" for name, kernel in BWD_PARTS.items())
          + f"; bounds {2 * 2 * b * HQ * D * s * s / PEAK_BF16_FLOPS * 1e3:.4f}"
          f" / {5 * 2 * b * HQ * D * s * s / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)")
    return out


def top_kernels(times: dict[str, float], n: int = 4) -> str:
    return "; ".join(f"{key[:72]} {t:.4f}" for key, t in sorted(times.items(), key=lambda x: -x[1])[:n])


def time_flash_bwd(b: int, s: int, gen, dev, keep_mask, iters: int,
                   json_record: bool = False) -> dict[str, dict]:
    """The port's whole backward (prep + main + post, each kernel's device
    time and their sum) at (b, s) with padding, beside its plain version,
    SDPA's backward with the same boolean causal + padding mask (the
    library yardstick; the kernels it ran are printed) and SDPA's backward
    with ``is_causal=True`` and no mask (PyTorch's flash backend, printed).
    Returns the records of the three kernels when ``json_record``."""
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask)
    do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    do4 = do.view(b, s, -1, D).transpose(1, 2)
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep_mask(kv_mask), enable_gqa=True)
    sdpa = traced_kernels(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters)
    del o4
    o4c = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)
    sdpa_causal = traced_kernels(lambda: torch.autograd.grad(o4c, (q4, k4, v4), do4, retain_graph=True),
                                 iters)
    del o4c, q4, k4, v4, do4

    def whole():
        return attention_packed_bwd(q, k, v, o, lse, do, HQ, HKV, kv_mask=kv_mask)

    parts = traced_kernels(whole, iters)
    ms = {name: kernel_ms(parts, kernel) for name, kernel in BWD_PARTS.items()}
    s_pad = bwd_padded_len(s)
    inp = flash_bwd_prep(q, o, do, lse, HQ)
    rec = {"ms": sum(ms.values()), "main_ms": ms["flash_bwd"], "wrapper_ms": sum(parts.values()),
           "wrapper_event_ms": cuda_ms(whole, iters),
           "plain_ms": device_ms(lambda: attention_packed_bwd_plain(q, k, v, o, lse, do, HQ, HKV,
                                                                    kv_mask=kv_mask), 2, warmup=1)[1],
           "library_ms": sum(sdpa.values())}
    prep = {"ms": ms["flash_bwd_prep"], "library_ms": None,
            "plain_ms": device_ms(lambda: flash_bwd_prep_plain(q, o, do, lse, HQ), iters)[1],
            # q, o, do and lse read once; q_s, the padded lse and di, and the
            # zeroed accumulator written once.
            **bound(3 * q.numel(), 4 * q.numel() * 2 + b * HQ * s * 4 + 2 * b * HQ * s_pad * 4
                    + b * HQ * s_pad * D * 4, PEAK_F32_FLOPS)}
    post = {"ms": ms["flash_bwd_post"], "library_ms": None,
            "plain_ms": device_ms(lambda: flash_bwd_post_plain(inp.acc, s, D ** -0.5), iters)[1],
            # The accumulator's rows below S read once, dq written once.
            **bound(q.numel(), b * HQ * s * D * 4 + q.numel() * 2, PEAK_F32_FLOPS)}
    del inp
    # Five products over the causal half. q, o, do read and dq written (Hq
    # wide); k, v read and dk, dv written (Hkv wide); lse and bias read.
    flops = 10 * b * HQ * D * s * (s + 1) // 2
    rec.update(bound(flops, 4 * q.numel() * 2 + 4 * k.numel() * 2 + (b * HQ * s + b * s) * 4))
    print(f"  flash_bwd B={b} S={s}: whole backward {rec['ms']:.4f} ms of device time (prep "
          f"{prep['ms']:.4f} + main {rec['main_ms']:.4f} + post {post['ms']:.4f}; everything the wrapper "
          f"launches {rec['wrapper_ms']:.4f}, {rec['wrapper_event_ms']:.4f} by CUDA events); SDPA backward "
          f"with the boolean mask {rec['library_ms']:.4f} ms [{top_kernels(sdpa)}]; SDPA is_causal without "
          f"padding {sum(sdpa_causal.values()):.4f} ms [{top_kernels(sdpa_causal)}]; plain "
          f"{rec['plain_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP -> bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}): whole {rec['bound_ms'] / rec['ms']:.1%} of it, main kernel "
          f"{rec['bound_ms'] / rec['main_ms']:.1%}, {flops / rec['main_ms'] / 1e9:.1f} TFLOP/s in the main "
          f"kernel")
    for name, r in (("flash_bwd_prep", prep), ("flash_bwd_post", post)):
        print(f"  {name} B={b} S={s}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return {"flash_bwd_prep": prep, "flash_bwd": rec, "flash_bwd_post": post} if json_record else {}


def time_lora(gen, dev) -> dict[str, dict]:
    """The three kernels (hash mode) at M = 6144, K = 4096 and 14336; the
    library is the unfused torch sequence on a precomputed mask (timed
    only). The JSON carries K = 4096, the input width of 6 of a layer's 7
    sites."""
    thr, _ = dropout_threshold(LORA_P)
    out = {}
    m, r = LORA_M, LORA_R
    for k in LORA_KS:
        x, a, dmid = lora_inputs(k, gen, dev)
        scale = torch.tensor(1.0 / (1.0 - thr / 256.0), dtype=torch.bfloat16, device=dev)
        mask_scale = (hash_bytes(7, m, k, dev) >= thr).to(torch.bfloat16) * scale
        cases = {
            "lora_fwd": (lambda: fused_dropout_matmul(x, a, 7, LORA_P), "lora_fwd_kernel",
                         lambda: fused_dropout_matmul_plain(x, a, 7, thr),
                         lambda: (x * mask_scale) @ a, (m * k + k * r + m * r) * 2),
            "lora_dx": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_da=False), "lora_dx_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr),
                        lambda: (dmid @ a.T) * mask_scale, (m * r + k * r + m * k) * 2),
            "lora_da": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_dx=False), "lora_da_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr),
                        lambda: (x * mask_scale).T @ dmid, (m * k + m * r) * 2 + k * r * 4),
        }
        for name, (kernel_fn, kernel, plain_fn, library_fn, nbytes) in cases.items():
            rec = timed(kernel_fn, kernel, plain_fn, library_fn, 20)
            report(name, f"M={m} K={k}", rec, 2 * m * k * r, nbytes)
            if k == LORA_KS[0]:
                out[name] = rec
        del x, a, dmid, mask_scale
    return out


def eager_row_quant(x, w=None):
    """The row quant as the obvious eager torch sequence (library yardstick)."""
    v = x.float() if w is None else x.float() * w
    s = (v.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(v / s).clamp(-127, 127).to(torch.int8), s


def time_row_quant(gen, dev) -> dict[str, dict]:
    """Both entry points at (6144, 4096) and (6144, 14336) bf16; the JSON
    carries N = 4096, the input width of 6 of a layer's 7 projections."""
    out = {}
    for n in LORA_KS:
        x = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        cases = {
            "row_quant": (lambda: row_quant(x), lambda: row_quant_plain(x), lambda: eager_row_quant(x), 0),
            "row_quant_scaled": (lambda: row_quant_scaled(x, w), lambda: row_quant_plain(x, w),
                                 lambda: eager_row_quant(x, w), n * 4),
        }
        for name, (kernel_fn, plain_fn, library_fn, extra) in cases.items():
            rec = timed(kernel_fn, "row_quant_kernel", plain_fn, library_fn, 20)
            # x read once; q and s written once (w_scale read once).
            report(name, f"({LORA_M}, {n})", rec, 0.0, LORA_M * n * 3 + LORA_M * 4 + extra)
            if n == LORA_KS[0]:
                out[name] = rec
        del x, w
    return out


def time_epilogue(gen, dev) -> dict[str, dict]:
    """Forward, dz and dB at M = 6144, r = 16, N = 1024, 4096, 14336; the
    library is one PyTorch call each (``addmm`` with the scaling as alpha),
    timed only. The JSON carries N = 4096 (q, o and down)."""
    out = {}
    s, m, r = 32.0 / LORA_R, LORA_M, LORA_R
    for n in EPI_NS:
        y, z, b, dy = epilogue_inputs(n, gen, dev)
        dz_out = torch.empty(m, r, device=dev, dtype=torch.bfloat16)
        db_out = torch.empty(r, n, device=dev, dtype=torch.bfloat16)
        cases = {
            # y, z, B read once, out written once; r f32 FMAs an element on
            # the CUDA cores.
            "epi_fwd": (lambda: lora_epilogue_fwd(y, z, b, s), lambda: lora_epilogue_plain(y, z, b, s),
                        lambda: torch.addmm(y, z, b, alpha=s), (2 * m * n + m * r + r * n) * 2,
                        PEAK_F32_FLOPS),
            # dy and B (z) read once, dz (dB) written once; mma.sync bf16.
            "epi_dz": (lambda: lora_epilogue_dz(dy, b, s), lambda: lora_epilogue_dz_plain(dy, b, s),
                       lambda: torch.addmm(dz_out, dy, b.t(), beta=0, alpha=s),
                       (m * n + r * n + m * r) * 2, PEAK_BF16_FLOPS),
            "epi_db": (lambda: lora_epilogue_db(z, dy, s), lambda: lora_epilogue_db_plain(z, dy, s),
                       lambda: torch.addmm(db_out, z.t(), dy, beta=0, alpha=s),
                       (m * n + m * r + r * n) * 2, PEAK_BF16_FLOPS),
        }
        for name, (kernel_fn, plain_fn, library_fn, nbytes, peak) in cases.items():
            rec = timed(kernel_fn, "epi_", plain_fn, library_fn, 20)
            report(name, f"M={m} N={n} r={r}", rec, 2 * m * n * r, nbytes, peak)
            if n == 4096:
                out[name] = rec
        del y, z, b, dy, dz_out, db_out
    return out


def per_stream_ms(fn, iters: int, kernel: str) -> list[float]:
    """Mean device time per launch of the kernels named ``kernel``, by the
    stream they ran on (``torch.profiler`` kernel events), sorted; empty
    when the tracer recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_stream: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name:
            by_stream.setdefault(e.device_resource_id, []).append(e.time_range.elapsed_us())
    return sorted(sum(x) / len(x) / 1e3 for x in by_stream.values())


def time_ring(gen, dev) -> dict[str, dict]:
    """The fused ring on RING_RANKS ranks of the card at the training shape
    (B 3, S 2048; the JSON's) and the serving one (B 5). ``ms`` is one pass:
    CUDA events on the caller's stream around ``ring_fwd``, from before the
    first send to after the last rank's output, the sends and the ranks'
    concurrent kernels included. Beside it each rank's kernel (by stream;
    rank i folds i + 1 chunks), the plain version, the library (SDPA causal
    with the padding mask over the whole (B, S) on the card: the same
    output) and the per-step flash ring's forward (timed only). The bound is
    the causal work's (tiles above each diagonal chunk's diagonal skipped),
    against q, k, v, bias read and out, lse written once; the sends' bytes
    are printed beside it."""
    out = {}
    s = REFERENCE_GEOMETRY.feature_len
    s_loc = s // RING_RANKS
    ring = SequenceRing([dev] * RING_RANKS)
    for b in (LORA_BATCH, BATCH):
        q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
        q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2) for t in (q, k, v))
        keep = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
                & (kv_mask > 0)[:, None, None, :])

        def fused():
            return ring_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)

        rec = {"ms": cuda_ms(fused, 20),
               "plain_ms": device_ms(lambda: ring_fwd_plain(q, k, v, HQ, HKV, ring, kv_mask=kv_mask),
                                     2, warmup=1)[1],
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=keep, enable_gqa=True), 10)[1]}
        # Few traced passes: each holds ~20 host API events per pass, and the
        # host's RSS peaks in this phase.
        kernels_ms, pass_device_ms = device_ms(fused, 5, "ring_fwd_kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fused()
        host_ms = (time.perf_counter() - t0) * 1e2           # per call, before the card is waited for
        torch.cuda.synchronize()
        ranks_ms = per_stream_ms(fused, 5, "ring_fwd_kernel")
        per_step_ms = cuda_ms(lambda: ring_flash_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask), 10)
        flops = 4 * b * HQ * D * s * (s + 1) // 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * HQ * s + b * s) * 4
        rec.update(bound(flops, nbytes))
        sent = 2 * RING_RANKS * (RING_RANKS - 1) * b * s_loc * HKV * D * 2
        print(f"  ring_fwd n={RING_RANKS} B={b} S={s}: pass {rec['ms']:.4f} ms (CUDA events; the host "
              f"takes {host_ms:.4f} ms to issue one), kernels "
              f"{kernels_ms:.4f} ms summed over ranks, each rank "
              f"{[round(x, 4) for x in ranks_ms] or 'not measured'} ms (by stream, sorted); "
              f"everything it launches {pass_device_ms:.4f} ms device time; plain {rec['plain_ms']:.4f} ms, "
              f"SDPA {rec['library_ms']:.4f} ms, per-step flash ring {per_step_ms:.4f} ms; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {flops / rec['ms'] / 1e9:.1f} TFLOP/s achieved; sends "
              f"{sent / 1e6:.1f} MB read and written ({2 * sent / PEAK_BYTES_PER_S * 1e3:.4f} ms at the "
              f"HBM rate)")
        if b == LORA_BATCH:
            out["ring_fwd"] = rec
        del q, k, v, q4, k4, v4, keep
    return out


def time_int_mm(gen, dev) -> None:
    """``torch._int_mm`` at 6144 x 4096 -> 14336 and its dx (6144 x 14336
    -> 4096), each with the weight stored (out, in) and (in, out), beside
    bf16 ``F.linear`` on the same shapes: what decides the int8 base's
    worth and the layout it is stored in. Printed, not in the JSON line."""
    m, k, n = LORA_M, LORA_KS[0], LORA_KS[1]
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    g8 = torch.randint(-127, 128, (m, n), generator=gen, device=dev, dtype=torch.int8)
    w_oi = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    w_io = w_oi.t().contiguous()
    xb, gb = x8.to(torch.bfloat16), g8.to(torch.bfloat16)
    wb = w_oi.to(torch.bfloat16)
    cases = {
        "forward, weight (out, in)": (lambda: torch._int_mm(x8, w_oi.t()), 2 * m * k * n),
        "forward, weight (in, out)": (lambda: torch._int_mm(x8, w_io), 2 * m * k * n),
        "dx, weight (out, in)": (lambda: torch._int_mm(g8, w_oi), 2 * m * k * n),
        "dx, weight (in, out)": (lambda: torch._int_mm(g8, w_io.t()), 2 * m * k * n),
        "dx, weight (out, in) transposed per call": (lambda: torch._int_mm(g8, w_oi.t().contiguous().t()),
                                                     2 * m * k * n),
        "bf16 F.linear forward": (lambda: F.linear(xb, wb), 2 * m * k * n),
        "bf16 dx (dy @ W)": (lambda: gb @ wb, 2 * m * k * n),
    }
    for label, (fn, flops) in cases.items():
        ms = cuda_ms(fn, 20)
        print(f"  {label}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TOP/s)")
    del x8, g8, w_oi, w_io, xb, gb, wb


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    with phase("1 card"):
        card = card_name_and_power()
        print(card)
    with phase("2 build kernels"):
        build_kernels()
    with phase("3 kernels vs plain"):
        max_abs_err = {}
        max_abs_err["flash_fwd"], max_abs_err["flash_bwd"], parts = check_flash(
            LORA_BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev)
        max_abs_err["flash_bwd_prep"], max_abs_err["flash_bwd_post"] = parts
        fwd_err, _, _ = check_flash(BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev)
        max_abs_err["flash_fwd"] = max(max_abs_err["flash_fwd"], fwd_err)
        check_flash(2, 1000, gen, dev)                 # S not a multiple of 64 or 128
        # Past skv 4096 the reference switches to its split backward
        # (_dq_kernel + _dkv_kernel, flash_attention.py:583); one kernel here.
        check_flash(1, 4608, gen, dev)
        # The ring's steps: a whole chunk back (S_loc), a tile (64), and none.
        s_loc = REFERENCE_GEOMETRY.feature_len // RING_RANKS
        for offset in (s_loc, 64, 0):
            check_flash(LORA_BATCH, s_loc, gen, dev, causal_offset=offset)
        # GQA groups 1, 2 and 8 (4 above) at lengths off the 128-row kv tile.
        for b, s, hq, hkv in ((2, 200, 8, 8), (2, 1000, 16, 8), (1, 4608, 32, 4)):
            check_flash(b, s, gen, dev, hq=hq, hkv=hkv)
        check_flash(2, 256, gen, dev, hq=16, hkv=4, valid=[0, 256])   # a row with every key masked
        max_abs_err["ring_fwd"] = check_ring(gen, dev)
        torch.cuda.empty_cache()
        for k in LORA_KS:
            for name, err in check_lora(k, gen, dev).items():
                max_abs_err[name] = max(max_abs_err.get(name, 0.0), err)
        torch.cuda.empty_cache()
        max_abs_err.update(check_row_quant(gen, dev))
        max_abs_err.update(check_epilogue(gen, dev))
        torch.cuda.empty_cache()
    with phase("4 full-width model"):
        cfg = VLBConfig.full()
        model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
        n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        n_params = sum(p.numel() for p in model.parameters())
        print(f"  {cfg.mistral.num_hidden_layers} layers, {n_params / 1e9:.3f} B parameters, "
              f"{n_bytes / 1e9:.2f} GB on {torch.cuda.get_device_name(0)}")
    with phase("5 serve"):
        batches = synthetic_batches(cfg, N_BATCHES, BATCH, np.random.default_rng(SEED), gen, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = predict_batches(model, batches, dev)
        serve_launches = read_launches()
        check_predictions(res, N_BATCHES * BATCH, cfg.num_target)
        print(f"  batch ms {[round(float(x), 3) for x in res['batch_ms']]}, "
              f"brain_loss {[round(float(x), 5) for x in res['brain_loss']]}, "
              f"corr avg {float(np.nanmean(res['val_corr_roi'])):.5f}, launches {serve_launches}, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        want = {n: (cfg.mistral.num_hidden_layers * N_BATCHES if n == "flash_fwd" else 0) for n in KERNELS}
        if serve_launches != want:
            raise AssertionError(f"serving launched {serve_launches}, want {want}")
    with phase("6 profile one served batch"):
        traced(lambda: predict_batches(model, [batches[-1]], dev), "served batch")
    with phase("6b serve through the fused ring"):
        serve_through_the_ring(model, batches[-1], res["predicted"][-BATCH:], dev)
        del model, batches
        torch.cuda.empty_cache()
    with phase("7 LoRA train at full width"):
        launches, ring_launches = train_lora_full(gen, dev)
        launches["ring_fwd"] = ring_launches["ring_fwd"]
        torch.cuda.empty_cache()
    with phase("9 frozen-baseline train at full width"):
        train_baseline_full(gen, dev)
        torch.cuda.empty_cache()
    with phase("10 narrow models vs f32 CPU"):
        narrow_reference_check(gen, dev)
        narrow_lora_check(gen, dev)
        narrow_lora_check(gen, dev, attention_impl="ring_fused")
        narrow_lora_check(gen, dev, base_quant="w8a8g8")
    with phase("11 timing"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timing = {**time_flash(gen, dev), **time_lora(gen, dev), **time_row_quant(gen, dev),
                  **time_epilogue(gen, dev), **time_ring(gen, dev)}
        time_bwd_probes(dev)
        time_int_mm(gen, dev)
        print(f"  peak device memory in timing {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    with phase("12 host"):
        rss_gb = peak_rss_gb()
        print(f"  peak host RSS {rss_gb:.2f} GB (limit {HOST_RSS_LIMIT_GB}), "
              f"total wall {time.perf_counter() - t_start:.1f} s")
        if rss_gb > HOST_RSS_LIMIT_GB:
            raise AssertionError("peak host RSS over its limit")

    records = [
        {"name": name, "route": "cuda", "source": f"phantom_vlb_tpu_torch/csrc/{REPLACES[name][0]}",
         "replaces": REPLACES[name][1], "launches": launches[name],
         "max_abs_err": max_abs_err[name],
         **{key: timing[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name in KERNELS
    ]
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
