#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printed with its wall time; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernel of the path with ``nvcc``;
3. each kernel against its plain PyTorch version at the serving shapes, plus
   a ragged length;
4. the full-width Mistral-7B VLB model (32 layers, bf16), made on the card
   from a seeded generator;
5. ``predict_batches`` over 3 synthetic batches of 5, with every kernel's
   launch count read around that run alone;
6. one more batch through the same model under ``torch.profiler``: device
   time by kernel and by group (flash kernel, GEMMs, the rest) and the
   device's idle share over the batch;
7. a narrow model (same geometry, 2 layers) on the card against the same
   weights in f32 on the CPU;
8. kernel, plain and library timings with CUDA events, and the bound;
9. peak host RSS (peak device memory is printed in phases 5 and 8).

The last two lines of standard output are the kernels' JSON record and the
device JSON record. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from phantom_vlb_tpu_torch.models.convert import init_params
from phantom_vlb_tpu_torch.models.mistral import MistralConfig
from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig, VideoLLaMA2VLB
from phantom_vlb_tpu_torch.ops.flash_attention import (
    FLASH_FWD,
    attention_packed,
    attention_packed_plain,
)

SEED = 0
BATCH = 5                 # configs/experiment/vlb_friends_baseline.yaml
N_BATCHES = 3
HQ, HKV, D = 32, 8, 128
# bf16 kernel vs f32 plain on the same bf16 inputs (q pre-scaled in bf16 on
# both sides): out is bf16 (2^-8 relative rounding at |out| <= ~1, plus bf16
# P in the PV product); lse sums f32 scores that differ only in order.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
# Narrow bf16 model on the card vs the same weights in f32 on the CPU: two
# layers of bf16 activations (2^-8 relative each) ahead of an f32 head whose
# predictions have unit scale.
PRED_TOL = 1e-1
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
HOST_RSS_LIMIT_GB = 8.0
GEMM_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    yield
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s (peak host RSS so far {rss_gb:.2f} GB)",
          flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernel() -> None:
    FLASH_FWD.load()
    report = [ln.strip() for ln in FLASH_FWD.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"  {FLASH_FWD.source.name}: " + " | ".join(report or ["cached"]))


def attention_inputs(b: int, s: int, gen: torch.Generator, dev):
    q = torch.randn(b, s, HQ * D, generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, s, HKV * D, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, s, HKV * D, generator=gen, device=dev, dtype=torch.bfloat16)
    # Right padding of varied length per row, as the text padding gives.
    valid = torch.tensor([s - (s * i) // (2 * b) for i in range(b)], device=dev)
    kv_mask = (torch.arange(s, device=dev)[None] < valid[:, None]).int()
    return q, k, v, kv_mask


def check_flash(b: int, s: int, gen, dev) -> float:
    """Kernel vs plain (f32) on one input; returns out's max abs error."""
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    out, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask)
    torch.cuda.synchronize()
    # The kernel pre-scales q in bf16; give the plain version that same q.
    q_s = q * torch.tensor(D ** -0.5, dtype=torch.bfloat16, device=dev)
    out_ref, lse_ref = attention_packed_plain(
        q_s.float(), k.float(), v.float(), HQ, HKV, sm_scale=1.0, kv_mask=kv_mask
    )
    out_err = (out.float() - out_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  flash_fwd B={b} S={s}: out max|err| {out_err:.3e} (tol {OUT_TOL}), "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL})")
    if not (out_err <= OUT_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"flash_fwd disagrees with its plain version at B={b} S={s}")
    return out_err


def check_predictions(res: dict, rows: int, num_target: int) -> None:
    pred = res["predicted"]
    if pred.shape != (rows, num_target) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions {pred.shape}, finite={np.isfinite(pred).all()}")
    if not (np.isfinite(res["brain_loss"]).all() and np.isfinite(res["val_corr_roi"]).all()):
        raise AssertionError("non-finite loss or correlation")


def kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd"
    return "gemm" if any(m in name.lower() for m in GEMM_MARKERS) else "other"


def profile_batch(model, batch, dev) -> None:
    """Trace one batch of a warm model: device time by kernel and by group."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_batches(model, [batch], dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels),
                       key=lambda x: -x[1])
    groups: dict[str, float] = {}
    for name, ms, _ in by_kernel:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    busy_ms = sum(groups.values())
    print(f"  traced batch wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          + (f"{1.0 - busy_ms / wall_ms:.4f}" if busy_ms else "not measured (no device events)"))
    for name, ms, count in by_kernel[:12]:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name[:110]}")
    for group, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  group {group:9s} {ms:10.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device time)")


def narrow_reference_check(gen, dev) -> None:
    """A 2-layer, 256-wide model at the serving geometry: card (bf16, kernel)
    against the same weights in f32 on the CPU (plain attention)."""
    mistral = MistralConfig.tiny(
        vocab_size=32000, hidden_size=256, intermediate_size=512,
        num_attention_heads=2, num_key_value_heads=1, head_dim=D, dtype=torch.bfloat16,
    )
    cfg = VLBConfig.full(mistral=mistral)
    sd = init_params(cfg, dev, gen)
    batches = synthetic_batches(cfg, 1, 2, np.random.default_rng(SEED), gen, dev)
    card = predict_batches(VideoLLaMA2VLB.from_state_dict(cfg, sd), batches, dev)
    cfg32 = dataclasses.replace(cfg, mistral=dataclasses.replace(mistral, dtype=torch.float32))
    cpu_model = VideoLLaMA2VLB.from_state_dict(cfg32, sd, device="cpu")
    cpu_batches = [{k: torch.as_tensor(v).cpu() for k, v in bt.items()} for bt in batches]
    ref = predict_batches(cpu_model, cpu_batches, "cpu")
    check_predictions(card, 2, cfg.num_target)
    err = np.abs(card["predicted"] - ref["predicted"]).max()
    scale = np.abs(ref["predicted"]).max()
    print(f"  narrow model: preds max|card - cpu f32| {err:.3e} (tol {PRED_TOL}), max|pred| {scale:.3f}")
    if not err <= PRED_TOL:
        raise AssertionError("narrow model on the card disagrees with its f32 CPU reference")


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


def time_flash(gen, dev) -> dict:
    b, s = BATCH, REFERENCE_GEOMETRY.feature_len
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    ms = cuda_ms(lambda: attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask), 20)
    plain_ms = cuda_ms(lambda: attention_packed_plain(q, k, v, HQ, HKV, kv_mask=kv_mask), 3, 1)
    # Library yardstick, timed only: the same causal + kv-padding attention.
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2) for t in (q, k, v))
    keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None] & (kv_mask > 0)[:, None, None, :]
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep, enable_gqa=True), 10
    )
    flops = 4 * b * HQ * D * s * (s + 1) // 2      # causal QK^T + PV
    # q, k, v and the bias row read once; out and lse written once.
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * HQ * s + b * s) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"  flash_fwd B={b} S={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms; {flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    with phase("2 build kernel"):
        build_kernel()
    with phase("3 kernels vs plain"):
        max_abs_err = check_flash(BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev)
        check_flash(2, 1000, gen, dev)                 # S not a multiple of 64
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
        FLASH_FWD.launches = 0
        res = predict_batches(model, batches, dev)
        launches = {FLASH_FWD.symbol: FLASH_FWD.launches}
        check_predictions(res, N_BATCHES * BATCH, cfg.num_target)
        print(f"  batch ms {[round(float(x), 3) for x in res['batch_ms']]}, "
              f"brain_loss {[round(float(x), 5) for x in res['brain_loss']]}, "
              f"corr avg {float(np.nanmean(res['val_corr_roi'])):.5f}, launches {launches}, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        expected = cfg.mistral.num_hidden_layers * N_BATCHES
        if launches["flash_fwd_launch"] != expected:
            raise AssertionError(f"flash_fwd launched {launches} times, want {expected}")
    with phase("6 profile one batch"):
        profile_batch(model, batches[-1], dev)
        del model, batches
    with phase("7 narrow model vs f32 CPU"):
        narrow_reference_check(gen, dev)
    with phase("8 timing"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timing = time_flash(gen, dev)
        print(f"  peak device memory in timing {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    with phase("9 host"):
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"  peak host RSS {rss_gb:.2f} GB (limit {HOST_RSS_LIMIT_GB}), "
              f"total wall {time.perf_counter() - t_start:.1f} s")
        if rss_gb > HOST_RSS_LIMIT_GB:
            raise AssertionError("peak host RSS over its limit")

    record = {
        "name": "flash_fwd", "route": "cuda",
        "source": "phantom_vlb_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "phantom_vlb_tpu/ops/flash_attention.py:93",
        "launches": launches["flash_fwd_launch"], "max_abs_err": max_abs_err, **timing,
    }
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
