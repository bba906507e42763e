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
// them uniformly; the l == 0 guard is kept.
//
// Bound at the serving shape (B=5, S=2048, Hq=32, Hkv=8, D=128, causal):
// 4*B*Hq*D*S(S+1)/2 = 171.9 GFLOP -> 0.174 ms at 989 TFLOP/s (bf16 dense),
// against 211 MB of traffic (q, k, v, out, lse, bias once) -> 0.063 ms at
// 3.35 TB/s. So it is bound by operations: the tensor cores set the limit.
//
// Design (simple and right first): one block of 4 warps per (64-row q tile,
// q head, batch row); each warp owns 16 q rows, held as mma.sync A
// fragments in registers. K/V tiles of 64x128 bf16 are double-buffered in
// shared memory with cp.async (rows padded to 136 elements, so the ldmatrix
// reads are free of bank conflicts); out-of-range rows are zero-filled in
// the copy and masked in-kernel, with no padding copies on the host. QK^T and PV are mma.sync.m16n8k16 bf16 with f32 sums; the
// online softmax keeps m, l and the 16x128 accumulator in f32 registers
// (exp as exp2 of the scaled difference); P goes from the QK^T accumulators
// to PV A fragments without touching shared memory; K's and V's B fragments
// come from ldmatrix (V's transposed), four 8x8 matrices per instruction.
// kv tiles above the diagonal are skipped, and the longest q tiles are
// launched first.
//
// Left on the table: wgmma (the only route to the full tensor-core rate,
// which mma.sync does not reach), TMA loads with mbarriers, a
// producer warp and ping-pong consumer warpgroups, a persistent schedule
// over tiles, 32 q rows per warp (each K/V fragment read from shared
// memory now feeds one 16-row MMA), occupancy (210 registers a thread fit
// two blocks, 8 warps, on an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // head dim
constexpr int BQ = 64;                 // q rows per block: 4 warps x 16
constexpr int BK = 64;                 // kv rows per tile (== BQ: tile j is
                                       // causal-partial only when j == q tile)
constexpr int NTHREADS = 128;
constexpr int SROW = D + 8;            // padded shared row, elements (272 B)
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_BYTES =
    2 * 2 * BK * SROW * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 bytes read -> 16 bytes of zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

// kOffset = false is plain causal attention (offset 0): the diagonal tile is
// j == qi. The ring's steps take kOffset = true.
template <bool kOffset>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse,
                 int S, int Hq, int Hkv, float scale, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[BK][SROW]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16 (*)[BK][SROW]>(
      smem + 2 * BK * SROW * sizeof(__nv_bfloat16));
  auto Bs = reinterpret_cast<float (*)[BK]>(
      smem + 4 * BK * SROW * sizeof(__nv_bfloat16));

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const int row_a = qi * BQ + warp * 16 + g;   // this thread's rows: row_a, row_a + 8

  // One 64x128 K/V tile (+ its bias row) into buffer `buf`.
  auto load_tile = [&](int j, int buf) {
#pragma unroll
    for (int i = 0; i < (BK * D / 8) / NTHREADS; ++i) {
      const int c = tid + i * NTHREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      const int kv = j * BK + r;
      const bool ok = kv < S;
      const size_t off = (static_cast<size_t>(b) * S + (ok ? kv : 0)) * kv_stride
                         + static_cast<size_t>(hkv) * D + col;
      cp_async16(&Ks[buf][r][col], k + off, ok);
      cp_async16(&Vs[buf][r][col], v + off, ok);
    }
    if (tid < BK) {
      const int kv = j * BK + tid;
      Bs[buf][tid] = kv >= S ? MASK_VALUE
                   : (bias != nullptr ? bias[static_cast<size_t>(b) * S + kv] : 0.0f);
    }
  };

  const int nk = (S + BK - 1) / BK;
  // Causal: tiles past the last key the q tile's last row sees are skipped
  // (all of them when that row sees none: out 0 and lse -inf, as the
  // reference gives for a q tile whose kv tiles are all skipped).
  int ntiles = min(qi + 1, nk);
  if constexpr (kOffset) {
    const int last_key = qi * BQ + BQ - 1 + offset;
    ntiles = last_key < 0 ? 0 : min(last_key / BK + 1, nk);
  }
  if (!kOffset || ntiles > 0) load_tile(0, 0);
  cp_async_commit();

  // Q fragments for the 8 k-steps over d, pre-scaled in bf16.
  uint32_t qf[D / 16][4];
  {
    auto load_q = [&](int row, int col) -> uint32_t {
      if (row >= S) return 0u;
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          q + (static_cast<size_t>(b) * S + row) * q_stride + static_cast<size_t>(h) * D + col);
      const float2 f = __bfloat1622float2(x);
      return pack_bf16(f.x * scale, f.y * scale);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = load_q(row_a, kk * 16 + 2 * t);
      qf[kk][1] = load_q(row_a + 8, kk * 16 + 2 * t);
      qf[kk][2] = load_q(row_a, kk * 16 + 8 + 2 * t);
      qf[kk][3] = load_q(row_a + 8, kk * 16 + 8 + 2 * t);
    }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};             // this thread's share of the row sums
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) load_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();                  // tile j has landed
    __syncthreads();

    // s = q K^T for this warp's 16 rows x 64 keys. One ldmatrix.x4 gives the
    // B fragments of two 8-key n-tiles: matrices (keys +0, d +0), (keys +0,
    // d +8), (keys +8, d +0), (keys +8, d +8).
    const int mat = lane >> 3, mr = lane & 7;
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[buf][np * 16 + (mat >> 1) * 8 + mr][kk * 16 + (mat & 1) * 8]);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // + bias, then + causal mask, as the reference adds them; only a tile
    // whose last key lies past the q tile's first row holds masked keys
    // (at offset 0 the diagonal tile, j == qi).
    const bool diag = kOffset ? (j + 1) * BK - 1 > qi * BQ + offset : j == qi;
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int row = row_a + ((e >> 1) << 3);
        float x = s[n][e] + Bs[buf][col];
        if (diag && j * BK + col > row + (kOffset ? offset : 0)) x += MASK_VALUE;
        s[n][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_next = fmaxf(m_r[r], mc[r]);
      alpha[r] = exp2f((m_r[r] - m_next) * LOG2E);
      m_r[r] = m_next;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Subtract before scaling: MASK_VALUE * log2(e) would overflow.
        const float p = exp2f((s[n][e] - m_r[e >> 1]) * LOG2E);
        s[n][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // o += P V, P (bf16) straight from the s accumulators.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[buf][kk * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                       // buffer `buf` is refilled next iteration
  }

  // Epilogue: normalise, store out (bf16) and lse (f32).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = (l == 0.0f) ? 1.0f : 1.0f / l;
    const int row = row_a + 8 * r;
    if (row < S) {
      __nv_bfloat16* op = out + (static_cast<size_t>(b) * S + row) * q_stride
                          + static_cast<size_t>(h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(op + n * 8) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
      if (t == 0) {
        lse[(static_cast<size_t>(b) * Hq + h) * S + row] = m_r[r] + logf(fmaxf(l, 1e-30f));
      }
    }
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Launches on the caller's current
// device and stream; the caller makes the tensors' device current. Returns
// cudaGetLastError() after the launch: a refused launch never runs, and a
// later synchronize would not say so.
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
  using Kernel = decltype(&flash_fwd_kernel<false>);
  const Kernel kernels[2] = {flash_fwd_kernel<false>, flash_fwd_kernel<true>};
  if (!smem_set[device]) {
    for (const Kernel kernel : kernels) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(SMEM_BYTES));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    smem_set[device] = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernels[offset != 0 ? 1 : 0]<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, Hq, Hkv, scale, offset);
  return static_cast<int>(cudaGetLastError());
}
