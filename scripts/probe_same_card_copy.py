#!/usr/bin/env python3
"""Does a copy between two buffers of one card need a free SM?

    python3 scripts/probe_same_card_copy.py      # on a CUDA card; builds with nvcc

The fused ring (``phantom_vlb_tpu_torch/csrc/ring_fwd.cu``) lets kernel
blocks wait on a ready flag that a copy stream writes after a copy. That
cannot deadlock only if the copy makes progress while spinning blocks hold
every SM. This fills each SM with blocks that spin (for at most 2 s) on a
flag, then, from another stream, makes a 6 MiB device-to-device copy and
writes the flag with ``cuStreamWriteValue32``, and counts the blocks that
gave up. Modes: the flag write alone; ``cudaMemcpyAsync``; and
``cudaMemcpyBatchAsync`` with its hint to overlap the copy with compute;
each from a stream of default and of high priority. It prints the card's
name and power limit, one line per case, and exits non-zero if a case
fails to launch.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from phantom_vlb_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = r"""
#include <cuda.h>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__global__ void spin(const unsigned* flag, unsigned* gave_up, unsigned long long limit_ns) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(flag) < 1u) {
      __nanosleep(256);
      if (global_ns() - t0 > limit_ns) { atomicAdd(gave_up, 1u); break; }
    }
  }
  __syncthreads();
}
extern "C" int probe_spin(const void* flag, void* gave_up, int blocks, long long limit_ns, void* stream) {
  spin<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(flag), static_cast<unsigned*>(gave_up),
      static_cast<unsigned long long>(limit_ns));
  return static_cast<int>(cudaGetLastError());
}
// mode 0: the flag alone; 1: cudaMemcpyAsync; 2: cudaMemcpyBatchAsync
// preferring overlap with compute. Then the flag by cuStreamWriteValue32.
extern "C" int probe_copy(void* dst, const void* src, long long bytes, void* flag, int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (mode == 1) {
    err = cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes), cudaMemcpyDeviceToDevice, st);
  } else if (mode == 2) {
#if CUDART_VERSION >= 12080
    void* dsts[1] = {dst};
    void* srcs[1] = {const_cast<void*>(src)};
    size_t sizes[1] = {static_cast<size_t>(bytes)};
    cudaMemcpyAttributes attr = {};
    attr.srcAccessOrder = cudaMemcpySrcAccessOrderStream;
    attr.flags = cudaMemcpyFlagPreferOverlapWithCompute;
    size_t idx[1] = {0};
    size_t fail = 0;
    err = cudaMemcpyBatchAsync(dsts, srcs, sizes, 1, &attr, idx, 1, &fail, st);
#else
    return -1;
#endif
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUresult r = cuStreamWriteValue32(st, reinterpret_cast<CUdeviceptr>(flag), 1u, 0);
  if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_same_card_copy: no CUDA device", file=sys.stderr)
        return 1
    source, path = BUILD_DIR / "probe_same_card_copy.cu", BUILD_DIR / "probe_same_card_copy.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source.write_text(SOURCE)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-lcuda", "-o", str(path), str(source)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_spin.argtypes, lib.probe_spin.restype = [P, P, I, LL, P], I
    lib.probe_copy.argtypes, lib.probe_copy.restype = [P, P, LL, P, I, P], I
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * 32                     # 16 resident per SM, the rest queued behind them
    src = torch.randn((6 << 20) // 4, device=dev)
    dst = torch.empty_like(src)
    spinner = torch.cuda.Stream(dev)
    failed = False
    for mode, label in ((0, "flag write alone"), (1, "cudaMemcpyAsync"),
                        (2, "cudaMemcpyBatchAsync, overlap hint")):
        for priority in (0, -1):
            copy = torch.cuda.Stream(dev, priority=priority)
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            gave_up = torch.zeros(1, dtype=torch.int32, device=dev)
            dst.zero_()
            torch.cuda.synchronize()
            err = lib.probe_spin(flag.data_ptr(), gave_up.data_ptr(), blocks, int(2e9), spinner.cuda_stream)
            time.sleep(0.05)                  # the spinners hold every SM by now
            err2 = lib.probe_copy(dst.data_ptr(), src.data_ptr(), src.numel() * 4, flag.data_ptr(), mode,
                                  copy.cuda_stream)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            waited = time.perf_counter() - t0
            copied = "-" if mode == 0 else bool(torch.equal(dst, src))
            print(f"{label}, {'high' if priority else 'default'} priority: {int(gave_up.item())} of "
                  f"{blocks} spinning blocks gave up, host waited {waited:.3f} s, copy right {copied} "
                  f"(launch {err}, copy {err2})")
            failed |= err != 0 or err2 != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
