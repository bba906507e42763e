// Causal GQA flash-attention forward for Hopper (sm_90a), packed layout.
//
// Replaces phantom_vlb_tpu/ops/flash_attention.py:_fwd_kernel (line 93),
// reached through _fwd_impl / attention_packed. Same function:
//   out = softmax(q*s K^T + bias + causal) V,  lse = m + log(l)
// with q, out (B, S, Hq*128) bf16, k, v (B, S, Hkv*128) bf16, kv head =
// h / (Hq/Hkv), bias (B, S) f32 additive (0 or MASK_VALUE) or null,
// lse (B, Hq, S) f32. The causal mask is col > row + offset (the reference's
// causal_offset, which the ring's steps pass; 0 is plain causal attention),
// and kv tiles that no row of a q tile sees are skipped, as the reference's
// tile skip (:109) does. q is pre-scaled in bf16 (q*s rounded to bf16, as the
// reference multiplies in the input dtype before its kernel). Masking adds
// MASK_VALUE = -0.7*FLT_MAX (never -inf): a masked key on the diagonal
// gets it twice and sums to -inf; a row whose keys are all masked averages
// them uniformly; the l == 0 guard is kept. Keys past S (the zero fill of
// the last kv tile) get MASK_VALUE twice and weigh exactly nothing.
//
// Bound at the serving shape (B=5, S=2048, Hq=32, Hkv=8, D=128, causal):
// 4*B*Hq*D*S(S+1)/2 = 171.9 GFLOP -> 0.174 ms at 989 TFLOP/s (bf16 dense),
// against 211 MB of traffic (q, k, v, out, lse, bias once) -> 0.063 ms at
// 3.35 TB/s. So it is bound by operations: the tensor cores set the limit.
//
// Design: the Hopper core of attn_fwd.cuh, which answers that bound with
// wgmma (the only route to the full tensor-core rate), operands that reach
// the tensor cores from shared memory by TMA without passing through
// registers, a producer warpgroup keeping three K/V stages in flight, and
// two consumer warpgroups that take turns at their products (one's softmax
// runs while the other's products do) and, inside each, issue a tile's
// Q K^T beside the previous tile's P V. A persistent grid, one block an SM,
// walks the (128-row q tile, q head, batch row) items longest first, so
// that one item's epilogue overlaps the next item's first K/V loads; for
// each the producer walks the kv tiles up to the last one the q tile's last
// row sees. A consumer warpgroup masks a tile only where some key of it may
// lie past its first row's reach or past S; the other tiles take the
// unmasked step.
//
// Left on the table: items handed out at run time (an atomic counter) in
// place of the static snake order, and the upper half of each diagonal
// tile, which the lower consumer warpgroup computes and masks. The previous
// design (mma.sync, 64 x 64 tiles, cp.async, one block of 4 warps per 64 q
// rows) took 0.82 ms at the serving shape (PERF.md).

#include "attn_fwd.cuh"

namespace {

using namespace attn_fwd;

// kOffset = false is plain causal attention (offset 0). The ring's steps
// take kOffset = true.
template <bool kOffset>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,     // q   (B, S, Hq*128), 64-row boxes
                 const __grid_constant__ CUtensorMap tm_k,     // k   (B, S, Hkv*128), 128-row boxes
                 const __grid_constant__ CUtensorMap tm_v,     // v   (B, S, Hkv*128)
                 const __grid_constant__ CUtensorMap tm_o,     // out (B, S, Hq*128), 64-row boxes
                 const float* __restrict__ bias,               // (B, S) or null
                 float* __restrict__ lse,                      // (B, Hq, S)
                 int B, int S, int Hq, int Hkv, float scale, int offset) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_init(smem_raw);

  const int nq = (S + BM - 1) / BM;
  const int items = nq * Hq * B;
  const int off = kOffset ? offset : 0;
  const int nk = (S + BN - 1) / BN;
  // Tiles past the last key the q tile's last row sees are skipped (all of
  // them when that row sees none: out 0 and lse -inf, as the reference
  // gives for a q tile whose kv tiles are all skipped).
  auto ntiles = [&](int qi) {
    const int last_key = qi * BM + BM - 1 + off;
    return last_key < 0 ? 0 : min(last_key / BN + 1, nk);
  };

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int r = 0, w; (w = item_at(r)) < items; ++r) {
        const Item t = item_of(w, nq, Hq, B);
        const int n = ntiles(t.qi), hkv = t.h / (Hq / Hkv);
        auto load_kv = [&](int it) {
          const int st = claim_stage(blk, g + it);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            tma_load_3d(blk.k(st) + half * Smem::HALF, &tm_k, hkv * D + half * 64, it * BN, t.b, blk.full(st));
            tma_load_3d(blk.v(st) + half * Smem::HALF, &tm_v, hkv * D + half * 64, it * BN, t.b, blk.full(st));
          }
        };
        // The item's first tiles go out while the consumers finish the
        // previous item; its Q once they have stored that item's output.
        const int pre = min(n, NST - 1);
        for (int it = 0; it < pre; ++it) load_kv(it);
        for (int wg = 0; wg < 2; ++wg) load_q(blk, wg, r, &tm_q, t.h * D, t.qi * BM + 64 * wg, t.b);
        for (int it = pre; it < n; ++it) load_kv(it);
        g += n;
      }
    } else if ((threadIdx.x >> 5) == 1) {
      int g = 0;
      for (int r = 0, w; (w = item_at(r)) < items; ++r) {
        const Item t = item_of(w, nq, Hq, B);
        const int n = ntiles(t.qi);
        const float* row = bias != nullptr ? bias + static_cast<size_t>(t.b) * S : nullptr;
        for (int it = 0; it < n; ++it) put_bias(blk, g + it, row, it * BN, S);
        g += n;
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const Consumer c;
    if (item_at(0) < items && ntiles(item_of(item_at(0), nq, Hq, B).qi) > 0) seed_turns(c);
    int g = 0;
    for (int r = 0, w; (w = item_at(r)) < items; ++r) {
      const Item t = item_of(w, nq, Hq, B);
      const int n = ntiles(t.qi);
      const int next = item_at(r + 1);
      const bool more = next < items && ntiles(item_of(next, nq, Hq, B).qi) > 0;
      const int q_row0 = t.qi * BM + c.wg * 64;
      scale_q(blk, c, scale, r);
      Softmax sm;
      sm.init();
      // A tile is masked where some key of it lies past the reach of the
      // warpgroup's first row, or past S.
      run_tiles(blk, c, sm, g, n, more, q_row0, S, [&](int it) {
        const int key0 = it * BN;
        return TileInfo{key0, off, key0 + BN - 1 > q_row0 + off || key0 + BN > S};
      });
      finish(blk, c, sm, &tm_o, t.h * D, q_row0, t.b, lse + (static_cast<size_t>(t.b) * Hq + t.h) * S, S);
      g += n;
    }
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Launches on the caller's current
// device and stream; the caller makes the tensors' device current. Returns
// cudaGetLastError() after the launch (a refused launch never runs, and a
// later synchronize would not say so), or ENCODE_ERROR + a CUresult.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse,
                                int B, int S, int Hq, int Hkv, float scale,
                                int offset, void* stream) {
  // The dynamic shared-memory opt-in is per device: set it once on each.
  static bool smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  err = bind_context();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Kernel = decltype(&flash_fwd_kernel<false>);
  const Kernel kernels[2] = {flash_fwd_kernel<false>, flash_fwd_kernel<true>};
  if (!smem_set[device]) {
    for (const Kernel kernel : kernels) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Smem::BYTES));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    smem_set[device] = true;
  }
  const long long q_bs = static_cast<long long>(S) * Hq * D, kv_bs = static_cast<long long>(S) * Hkv * D;
  CUtensorMap tq, tk, tv, to;
  CUresult r = encode_rows(&tq, q, Hq * D, S, B, q_bs, 64);
  if (r == CUDA_SUCCESS) r = encode_rows(&tk, k, Hkv * D, S, B, kv_bs, BN);
  if (r == CUDA_SUCCESS) r = encode_rows(&tv, v, Hkv * D, S, B, kv_bs, BN);
  if (r == CUDA_SUCCESS) r = encode_rows(&to, out, Hq * D, S, B, q_bs, 64);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  int blocks = 0;
  err = persistent_blocks((S + BM - 1) / BM * Hq * B, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[offset != 0 ? 1 : 0]<<<blocks, NTHREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, static_cast<const float*>(bias), static_cast<float*>(lse), B, S, Hq, Hkv, scale,
      offset);
  return static_cast<int>(cudaGetLastError());
}
