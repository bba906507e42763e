// Causal GQA flash-attention backward for Hopper (sm_90a), packed layout.
//
// Replaces phantom_vlb_tpu/ops/flash_attention.py:_dq_dkv_kernel (line 284),
// reached through _bwd_impl (:490) from _flash_packed_bwd (:754). It also
// computes what the split _dq_kernel (:177) + _dkv_kernel (:227) compute,
// which the reference takes for long kv: this design has no length limit.
// Same function, from the forward's saved (out, lse):
//   s  = q_s K^T + bias + causal,  p = exp(s - lse),  di = rowsum(o * do)
//   dv = sum_g p^T do,  dp = do V^T,  ds = p (dp - di),
//   dk = sum_g ds^T q_s,  dq = (ds K) * sm_scale
// where the causal mask is col > row + offset (the reference's causal_offset;
// 0 is plain causal attention; q tiles that see no key of a kv tile skip
// it, as the reference's tile skip :313 does), with q_s = q pre-scaled in
// bf16 by the caller, k, v, dk, dv
// (B, S, Hkv*128) bf16, do (B, S, Hq*128) bf16, bias (B, S) f32 additive
// (0 or MASK_VALUE) or null, lse and di (B, Hq, S) f32, and dq written as
// f32 partial sums into a zeroed (B, S, Hq*128) buffer that the caller
// scales by sm_scale and casts. p and ds are bf16 product operands, every
// sum is f32, and GQA dk/dv are summed over the group in f32 registers
// before their one cast to bf16, as the reference's fused scratch does.
//
// Bound at the training shape (B=3, S=2048, Hq=32, Hkv=8, D=128, causal):
// five products over the causal half, 10*B*Hq*D*S(S+1)/2 = 257.9 GFLOP
// -> 0.261 ms at 989 TFLOP/s (bf16 dense), against ~252 MB of traffic
// (q, k, v, o, do, dq, dk, dv once) -> 0.075 ms at 3.35 TB/s. Bound by
// operations.
//
// Design (simple and right first): one block of 4 warps per (64-row kv
// tile, kv head, batch row). K and V of the tile sit in shared memory; each
// warp owns 16 kv rows and keeps their dk and dv (16 x 128 f32 each) in
// registers for the whole block. The block loops over the group's q heads
// and, for each, over the 32-row q tiles at or below the diagonal; Q, dO,
// lse and di tiles are double-buffered with cp.async (zero-filled past S,
// which makes every term of a padded row vanish). Per q tile each warp
// computes s^T = K Q^T (16 x 32) with kv rows as the MMA's M, so p^T and
// ds^T feed the dV and dK products straight from the accumulators; ds^T
// goes through shared memory once to form dQ = ds K (each warp 32 columns
// of d), which is added to the f32 dq buffer with atomicAdd.
// mma.sync.m16n8k16 bf16 with f32 sums throughout; ldmatrix fragments from
// padded rows (136 elements), free of bank conflicts. Blocks of the
// longest kv tiles (j = 0 sees every q tile) launch first.
//
// Left on the table: wgmma + TMA, a persistent schedule, dq without
// atomics (a separate dq pass, as the reference's split form), and K/V
// fragments held in registers across q tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // head dim
constexpr int BK = 64;                 // kv rows per block: 4 warps x 16
constexpr int BQ = 32;                 // q rows per inner step
constexpr int NTHREADS = 128;
constexpr int SROW = D + 8;            // padded shared row, elements (272 B)
constexpr int DSROW = BQ + 8;          // padded ds^T row, elements (80 B)
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t KV_BYTES = BK * SROW * sizeof(__nv_bfloat16);
constexpr size_t Q_BYTES = BQ * SROW * sizeof(__nv_bfloat16);
constexpr size_t SMEM_BYTES = 2 * KV_BYTES + 4 * Q_BYTES
                              + BK * DSROW * sizeof(__nv_bfloat16)
                              + 4 * BQ * sizeof(float) + BK * sizeof(float);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 bytes read -> 16 bytes of zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// c += a(16x16, row) * b(16x8, col); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of a 16x16 tile held as the C fragments of two 8-wide n-tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,     // pre-scaled
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ di,
                 float* __restrict__ dq,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv,
                 int S, int Hq, int Hkv, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[SROW]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16 (*)[SROW]>(smem + KV_BYTES);
  auto Qs = reinterpret_cast<__nv_bfloat16 (*)[BQ][SROW]>(smem + 2 * KV_BYTES);
  auto Os = reinterpret_cast<__nv_bfloat16 (*)[BQ][SROW]>(smem + 2 * KV_BYTES + 2 * Q_BYTES);
  auto DSs = reinterpret_cast<__nv_bfloat16 (*)[DSROW]>(smem + 2 * KV_BYTES + 4 * Q_BYTES);
  float* stats = reinterpret_cast<float*>(smem + 2 * KV_BYTES + 4 * Q_BYTES
                                          + BK * DSROW * sizeof(__nv_bfloat16));
  auto Ls = reinterpret_cast<float (*)[BQ]>(stats);             // [2][BQ] lse
  auto Ds = reinterpret_cast<float (*)[BQ]>(stats + 2 * BQ);    // [2][BQ] di
  float* Bs = stats + 4 * BQ;                                   // [BK] bias

  const int j = blockIdx.x;            // kv tile; j = 0 has the most work
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int kv0 = j * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;        // mma fragment row group / column pair
  const int mat = lane >> 3, mr = lane & 7;     // ldmatrix: matrix / row this lane addresses
  const int r0 = warp * 16;                     // this warp's kv rows within the tile
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;

  // K and V of this tile, and its bias row (MASK_VALUE past S, as the forward).
#pragma unroll
  for (int it = 0; it < (BK * D / 8) / NTHREADS; ++it) {
    const int c = tid + it * NTHREADS;
    const int r = c >> 4, col = (c & 15) * 8;
    const int kv = kv0 + r;
    const bool ok = kv < S;
    const size_t off = (static_cast<size_t>(b) * S + (ok ? kv : 0)) * kv_stride
                       + static_cast<size_t>(hkv) * D + col;
    cp_async16(&Ks[r][col], k + off, ok);
    cp_async16(&Vs[r][col], v + off, ok);
  }
  if (tid < BK) {
    const int kv = kv0 + tid;
    Bs[tid] = kv >= S ? MASK_VALUE
            : (bias != nullptr ? bias[static_cast<size_t>(b) * S + kv] : 0.0f);
  }

  const int nq = (S + BQ - 1) / BQ;
  // q tiles whose last row does not reach kv0 never see the tile: the first
  // q tile that does is i0 (kv0 / BQ at offset 0).
  const int need = kv0 - offset - (BQ - 1);
  const int i0 = need <= 0 ? 0 : (need + BQ - 1) / BQ;
  const int per_head = max(nq - i0, 0);
  const int n_iter = G * per_head;

  // Q, dO, lse and di of step `it` into buffer `buf`.
  auto load_q_tile = [&](int it, int buf) {
    const int h = hkv * G + it / per_head;
    const int qt = i0 + it % per_head;
#pragma unroll
    for (int u = 0; u < (BQ * D / 8) / NTHREADS; ++u) {
      const int c = tid + u * NTHREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      const int row = qt * BQ + r;
      const bool ok = row < S;
      const size_t off = (static_cast<size_t>(b) * S + (ok ? row : 0)) * q_stride
                         + static_cast<size_t>(h) * D + col;
      cp_async16(&Qs[buf][r][col], q + off, ok);
      cp_async16(&Os[buf][r][col], dout + off, ok);
    }
    if (tid < 2 * BQ) {
      const int r = tid & (BQ - 1);
      const int row = qt * BQ + r;
      const bool ok = row < S;
      const size_t off = (static_cast<size_t>(b) * Hq + h) * S + (ok ? row : 0);
      if (tid < BQ) cp_async4(&Ls[buf][r], lse + off, ok);
      else cp_async4(&Ds[buf][r], di + off, ok);
    }
  };

  if (n_iter > 0) load_q_tile(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) load_q_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();                // step `it` (and K/V) have landed
    __syncthreads();

    const int h = hkv * G + it / per_head;
    const int qt = i0 + it % per_head;
    const bool diag = kv0 + BK - 1 > qt * BQ + offset;   // some key lies past some query's reach

    // s^T = K Q^T: 16 kv rows x 32 q columns per warp.
    float st[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, &Ks[r0 + (mat & 1) * 8 + mr][kk * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qb[4];
        ldmatrix_x4(qb, &Qs[buf][np * 16 + (mat >> 1) * 8 + mr][kk * 16 + (mat & 1) * 8]);
        mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
      }
    }

    // p^T = exp(s^T + bias + causal - lse), the bias and mask added in the
    // reference's order; the difference is taken before the log2(e) scaling.
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = r0 + g + ((e >> 1) << 3);
        const int qc = n * 8 + 2 * t + (e & 1);
        float x = st[n][e] + Bs[kr];
        if (diag && kv0 + kr > qt * BQ + qc + offset) x += MASK_VALUE;
        st[n][e] = exp2f((x - Ls[buf][qc]) * LOG2E);
      }
    }

    // dv += p^T dO (p bf16).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t ob[4];
        ldmatrix_x4_trans(ob, &Os[buf][kk * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(dv_acc[2 * np], pa, ob[0], ob[1]);
        mma_bf16(dv_acc[2 * np + 1], pa, ob[2], ob[3]);
      }
    }

    // dp^T = V dO^T, then ds^T = p^T (dp^T - di) in f32.
    float dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t va[4];
      ldmatrix_x4(va, &Vs[r0 + (mat & 1) * 8 + mr][kk * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t ob[4];
        ldmatrix_x4(ob, &Os[buf][np * 16 + (mat >> 1) * 8 + mr][kk * 16 + (mat & 1) * 8]);
        mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
        mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = st[n][e] * (dpt[n][e] - Ds[buf][n * 8 + 2 * t + (e & 1)]);
      }
    }

    // dk += ds^T q_s (ds bf16); ds^T also to shared memory for dq.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t qb[4];
        ldmatrix_x4_trans(qb, &Qs[buf][kk * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(dk_acc[2 * np], da, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * np + 1], da, qb[2], qb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&DSs[r0 + g][n * 8 + 2 * t]) = pack_bf16(st[n][0], st[n][1]);
      *reinterpret_cast<uint32_t*>(&DSs[r0 + g + 8][n * 8 + 2 * t]) = pack_bf16(st[n][2], st[n][3]);
    }
    __syncthreads();

    // dq (32 q x 128 d) += ds (32 x 64 kv) K (64 x 128): this warp's 32
    // columns of d; A from ds^T by a transposing ldmatrix.
    float dqa[BQ / 16][4][4];
#pragma unroll
    for (int mt = 0; mt < BQ / 16; ++mt) {
#pragma unroll
      for (int n = 0; n < 4; ++n) dqa[mt][n][0] = dqa[mt][n][1] = dqa[mt][n][2] = dqa[mt][n][3] = 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t da[BQ / 16][4];
#pragma unroll
      for (int mt = 0; mt < BQ / 16; ++mt) {
        ldmatrix_x4_trans(da[mt], &DSs[ks * 16 + (mat >> 1) * 8 + mr][mt * 16 + (mat & 1) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, &Ks[ks * 16 + (mat & 1) * 8 + mr][warp * 32 + np * 16 + (mat >> 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < BQ / 16; ++mt) {
          mma_bf16(dqa[mt][2 * np], da[mt], kb[0], kb[1]);
          mma_bf16(dqa[mt][2 * np + 1], da[mt], kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < BQ / 16; ++mt) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = qt * BQ + mt * 16 + g + 8 * e2;
        if (row < S) {
          float* dst = dq + (static_cast<size_t>(b) * S + row) * q_stride
                       + static_cast<size_t>(h) * D + warp * 32 + 2 * t;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            atomicAdd(dst + n * 8, dqa[mt][n][2 * e2]);
            atomicAdd(dst + n * 8 + 1, dqa[mt][n][2 * e2 + 1]);
          }
        }
      }
    }
    __syncthreads();                     // buffers `buf` and DSs are refilled next step
  }

  // dk, dv: one cast to bf16 of the group's f32 sums.
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int kv = kv0 + r0 + g + 8 * e2;
    if (kv < S) {
      const size_t off = (static_cast<size_t>(b) * S + kv) * kv_stride
                         + static_cast<size_t>(hkv) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
            pack_bf16(dk_acc[n][2 * e2], dk_acc[n][2 * e2 + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
            pack_bf16(dv_acc[n][2 * e2], dv_acc[n][2 * e2 + 1]);
      }
    }
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Launches on the caller's current
// device and stream; the caller makes the tensors' device current and
// zeroes dq. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, const void* lse,
                                const void* di, void* dq, void* dk, void* dv,
                                int B, int S, int Hq, int Hkv, int offset,
                                void* stream) {
  static bool smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const dim3 grid((S + BK - 1) / BK, Hkv, B);
  flash_bwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Hq, Hkv, offset);
  return static_cast<int>(cudaGetLastError());
}
