// Fused LoRA adapter-input dropout + rank-r matmul for Hopper (sm_90a):
// forward, dx and dA.
//
// Replaces phantom_vlb_tpu/ops/lora_fused.py:_fwd_kernel (line 62),
// _dx_kernel (:92) and _da_kernel (:111), reached through
// fused_dropout_matmul (:147):
//   mid = (mask * x * s) @ A            s = 1/keep rounded to bf16, the
//                                       product rounded to bf16, f32 sums
//   dx  = (dmid @ A^T) * mask * inv     f32 product, f32 inv = 1/keep
//   dA  = (mask * x * s)^T @ dmid       f32 sums
// with x (M, K) bf16, A (K, R) bf16, R in {16, 32, 64, 128}, dmid (M, R)
// bf16. The mask is regenerated in every kernel and never stored: keep iff
// byte >= thr, the byte taken from `bits` (M, K) uint8 when given, else from
// a counter-based hash of (seed, row0 + row, (col0 + col) >> 2) alone:
//   word = fmix32(fmix32(seed ^ (row0 + row) * 0x9E3779B1) ^ ((col0 + col) >> 2)),
//   byte = (word >> 8 * (col & 3)) & 0xFF
// (fmix32 is MurmurHash3's finaliser), so one 32-bit word masks 4
// neighbouring elements and the mask depends on no tile shape: the three
// kernels agree on it by construction, and the port's plain version
// (ops/lora_fused.py:hash_bytes) computes the same bytes. row0 is the
// global index of x's first row: a rank that holds rows [row0, row0 + M)
// of a batch split over ranks draws those rows of the one-card mask. col0
// (a multiple of 4) is the global index of x's first column: a rank of the
// tensor axis whose row-parallel projection reads columns [col0, col0 + K)
// of the input draws those columns of it.
//
// Bound: rank-R contractions move far more bytes than they compute
// (2R = 32 FLOP per 2-byte element of x at R = 16). At M = 6144 one pass
// over x is 50.3 MB at K = 4096 (15.0 us at 3.35 TB/s) and 176.2 MB at
// K = 14336 (52.6 us). Each kernel reads or writes x once.
//
// Design (simple and right first), blocks of 4 warps, mma.sync.m16n8k16
// bf16 with f32 sums:
// - forward: a block owns 64 rows and a contiguous share of the 64-column
//   chunks of K; per chunk it loads x (16 bytes a thread, prefetched into
//   registers one chunk ahead), masks and scales it while storing it to
//   shared memory, loads A's 64 x R chunk beside it, and each warp
//   multiplies its 16 rows. Partial sums per share go to an f32
//   (split, M, R) buffer that the caller sums (deterministic).
// - dA: a block owns 64 columns of K and a share of the 64-row chunks of M;
//   the masked x chunk and dmid's chunk go to shared memory, and a
//   transposing ldmatrix gives each warp 16 columns of K as the MMA's M.
//   Partials go to (split, K, R) f32.
// - dx: a warp owns 16 rows x 64 columns; dmid's fragment is loaded once
//   and A's fragments straight from global memory, with the product's
//   columns permuted so that each thread ends with 16 neighbouring output
//   columns per row: the mask is applied in registers and dx leaves in
//   16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;                 // chunk edge (rows and columns)
constexpr int NTHREADS = 128;
constexpr int ZROW = CH + 8;           // padded shared row of a masked x chunk

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int row) {
  return fmix32(seed ^ (static_cast<uint32_t>(row) * 0x9E3779B1u));
}

// The 4 mask bytes of element columns 4w .. 4w+3 of a row.
__device__ __forceinline__ uint32_t mask_word(uint32_t key, int col) {
  return fmix32(key ^ static_cast<uint32_t>(col >> 2));
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

// Keep bits (bit e for element e) of 8 neighbouring elements at (row, col),
// col a multiple of 8.
__device__ __forceinline__ uint32_t keep8(const uint8_t* bits, uint32_t seed, int row0, int col0,
                                         int thr, int row, int col, int K) {
  uint32_t b[2];
  if (bits != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(bits + static_cast<size_t>(row) * K + col);
    b[0] = raw.x;
    b[1] = raw.y;
  } else {
    const uint32_t key = row_key(seed, row0 + row);
    b[0] = mask_word(key, col0 + col);
    b[1] = mask_word(key, col0 + col + 4);
  }
  uint32_t keep = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    keep |= static_cast<uint32_t>(static_cast<int>((b[e >> 2] >> (8 * (e & 3))) & 0xFFu) >= thr) << e;
  }
  return keep;
}

// mask * x * s for 8 bf16 values, each product rounded to bf16.
__device__ __forceinline__ uint4 drop8(uint4 x, uint32_t keep, __nv_bfloat162 s2) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w[i]), s2);
    v.x = ((keep >> (2 * i)) & 1u) ? v.x : zero.x;
    v.y = ((keep >> (2 * i + 1)) & 1u) ? v.y : zero.y;
    w[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One 64 x 64 chunk of x at (m0, k0), 4 x 16 bytes a thread: register
// prefetch, then masked into shared memory.
struct XChunk {
  uint4 x[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* xg, int M, int K, int m0, int k0, int tid) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = tid + u * NTHREADS;
      const int row = m0 + (c >> 3), col = k0 + (c & 7) * 8;
      x[u] = row < M ? *reinterpret_cast<const uint4*>(xg + static_cast<size_t>(row) * K + col)
                     : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store_masked(__nv_bfloat16 (*zs)[ZROW], const uint8_t* bits,
                                               uint32_t seed, int row0, int col0, int thr,
                                               __nv_bfloat162 s2,
                                               int M, int K, int m0, int k0, int tid) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = tid + u * NTHREADS;
      const int r = c >> 3, cc = (c & 7) * 8;
      const int row = m0 + r;
      const uint32_t keep = row < M ? keep8(bits, seed, row0, col0, thr, row, k0 + cc, K) : 0u;
      *reinterpret_cast<uint4*>(&zs[r][cc]) = drop8(x[u], keep, s2);
    }
  }
};

// Rows [r0, r0 + 64) x R columns of a row-major (rows, R) bf16 matrix:
// (64 * R / 8) 16-byte pieces, R / 16 a thread.
template <int R>
struct RChunk {
  uint4 v[R / 16];
  __device__ __forceinline__ void load(const __nv_bfloat16* g, int rows, int r0, int tid) {
#pragma unroll
    for (int u = 0; u < R / 16; ++u) {
      const int c = tid + u * NTHREADS;
      const int row = r0 + c / (R / 8), col = (c % (R / 8)) * 8;
      v[u] = row < rows ? *reinterpret_cast<const uint4*>(g + static_cast<size_t>(row) * R + col)
                        : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16 (*s)[R + 8], int tid) const {
#pragma unroll
    for (int u = 0; u < R / 16; ++u) {
      const int c = tid + u * NTHREADS;
      *reinterpret_cast<uint4*>(&s[c / (R / 8)][(c % (R / 8)) * 8]) = v[u];
    }
  }
};

// Forward: grid (ceil(M/64), split). part[split][M][R] f32.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
lora_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                const uint8_t* __restrict__ bits, float* __restrict__ part,
                int M, int K, int split, uint32_t seed, int row0, int col0, int thr, float scale) {
  __shared__ __align__(16) __nv_bfloat16 zs[CH][ZROW];
  __shared__ __align__(16) __nv_bfloat16 as[CH][R + 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int m0 = blockIdx.x * CH;
  const int chunks = K / CH;
  const int c_begin = static_cast<int>(static_cast<long long>(chunks) * blockIdx.y / split);
  const int c_end = static_cast<int>(static_cast<long long>(chunks) * (blockIdx.y + 1) / split);
  const __nv_bfloat162 s2 = __floats2bfloat162_rn(scale, scale);

  float acc[R / 8][4];
#pragma unroll
  for (int n = 0; n < R / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  XChunk xc;
  RChunk<R> ac;
  if (c_begin < c_end) {
    xc.load(x, M, K, m0, c_begin * CH, tid);
    ac.load(a, K, c_begin * CH, tid);
  }
  for (int c = c_begin; c < c_end; ++c) {
    xc.store_masked(zs, bits, seed, row0, col0, thr, s2, M, K, m0, c * CH, tid);
    ac.store(as, tid);
    __syncthreads();
    if (c + 1 < c_end) {
      xc.load(x, M, K, m0, (c + 1) * CH, tid);
      ac.load(a, K, (c + 1) * CH, tid);
    }
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
      uint32_t za[4];
      ldmatrix_x4(za, &zs[warp * 16 + (mat & 1) * 8 + mr][ks * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < R / 16; ++np) {
        uint32_t ab[4];
        ldmatrix_x4_trans(ab, &as[ks * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(acc[2 * np], za, ab[0], ab[1]);
        mma_bf16(acc[2 * np + 1], za, ab[2], ab[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = m0 + warp * 16 + g + 8 * e2;
    if (row < M) {
      float* dst = part + (static_cast<size_t>(blockIdx.y) * M + row) * R + 2 * t;
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
      }
    }
  }
}

// dA: grid (K/64, split). part[split][K][R] f32.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
lora_da_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dmid,
               const uint8_t* __restrict__ bits, float* __restrict__ part,
               int M, int K, int split, uint32_t seed, int row0, int col0, int thr, float scale) {
  __shared__ __align__(16) __nv_bfloat16 zs[CH][ZROW];
  __shared__ __align__(16) __nv_bfloat16 ds[CH][R + 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int k0 = blockIdx.x * CH;
  const int chunks = (M + CH - 1) / CH;
  const int c_begin = static_cast<int>(static_cast<long long>(chunks) * blockIdx.y / split);
  const int c_end = static_cast<int>(static_cast<long long>(chunks) * (blockIdx.y + 1) / split);
  const __nv_bfloat162 s2 = __floats2bfloat162_rn(scale, scale);

  float acc[R / 8][4];
#pragma unroll
  for (int n = 0; n < R / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  XChunk xc;
  RChunk<R> dc;
  if (c_begin < c_end) {
    xc.load(x, M, K, c_begin * CH, k0, tid);
    dc.load(dmid, M, c_begin * CH, tid);
  }
  for (int c = c_begin; c < c_end; ++c) {
    xc.store_masked(zs, bits, seed, row0, col0, thr, s2, M, K, c * CH, k0, tid);
    dc.store(ds, tid);
    __syncthreads();
    if (c + 1 < c_end) {
      xc.load(x, M, K, (c + 1) * CH, k0, tid);
      dc.load(dmid, M, (c + 1) * CH, tid);
    }
    // acc (16 columns of K x R) += z^T dmid over this chunk's 64 rows.
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
      uint32_t za[4];
      ldmatrix_x4_trans(za, &zs[ks * 16 + (mat >> 1) * 8 + mr][warp * 16 + (mat & 1) * 8]);
#pragma unroll
      for (int np = 0; np < R / 16; ++np) {
        uint32_t db[4];
        ldmatrix_x4_trans(db, &ds[ks * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(acc[2 * np], za, db[0], db[1]);
        mma_bf16(acc[2 * np + 1], za, db[2], db[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int col = k0 + warp * 16 + g + 8 * e2;
    float* dst = part + (static_cast<size_t>(blockIdx.y) * K + col) * R + 2 * t;
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
    }
  }
}

// dx: grid (ceil(M/16), ceil(K/256)); warp w owns 16 rows x 64 columns.
// Logical column (n-tile nt, c) of the product is physical column
// 16*(c >> 1) + 2*nt + (c & 1) of the warp's 64, so thread t's outputs are
// columns 16t .. 16t + 15 of each of its two rows.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
lora_dx_kernel(const __nv_bfloat16* __restrict__ dmid, const __nv_bfloat16* __restrict__ a,
               const uint8_t* __restrict__ bits, __nv_bfloat16* __restrict__ dx,
               int M, int K, uint32_t seed, int row0, int col0, int thr, float inv_keep) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 16;
  const int k0 = (blockIdx.y * 4 + warp) * CH;
  if (k0 >= K) return;

  // dmid's A fragments for the R/16 k-steps over the rank.
  uint32_t da[R / 16][4];
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e & 1);
      const int col = kk * 16 + 2 * t + 8 * (e >> 1);
      da[kk][e] = row < M ? *reinterpret_cast<const uint32_t*>(dmid + static_cast<size_t>(row) * R + col)
                          : 0u;
    }
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const int bcol = k0 + 16 * (g >> 1) + (g & 1);     // physical column of B's column g, nt = 0
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const __nv_bfloat16* arow = a + static_cast<size_t>(bcol + 2 * nt) * R;
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(arow + kk * 16 + 2 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(arow + kk * 16 + 8 + 2 * t);
      mma_bf16(acc[nt], da[kk], b0, b1);
    }
  }
  // Thread (g, t): rows g and g + 8, columns k0 + 16t + 2nt + {0, 1}.
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = m0 + g + 8 * e2;
    if (row >= M) continue;
    const int col = k0 + 16 * t;
    const uint32_t keep = keep8(bits, seed, row0, col0, thr, row, col, K)
                          | (keep8(bits, seed, row0, col0, thr, row, col + 8, K) << 8);
    uint32_t w[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float lo = ((keep >> (2 * nt)) & 1u) ? acc[nt][2 * e2] * inv_keep : 0.0f;
      const float hi = ((keep >> (2 * nt + 1)) & 1u) ? acc[nt][2 * e2 + 1] * inv_keep : 0.0f;
      w[nt] = pack_bf16(lo, hi);
    }
    uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * K + col);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <template <int> class Launch, typename... Args>
int dispatch_rank(int R, Args... args) {
  switch (R) {
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    case 64: return Launch<64>::run(args...);
    case 128: return Launch<128>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int R>
struct FwdLaunch {
  static int run(const void* x, const void* a, const void* bits, void* part, int M, int K,
                 int split, uint32_t seed, int row0, int col0, int thr, float scale,
                 cudaStream_t stream) {
    const dim3 grid((M + CH - 1) / CH, split);
    lora_fwd_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
        static_cast<const uint8_t*>(bits), static_cast<float*>(part), M, K, split, seed, row0, col0, thr,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int R>
struct DaLaunch {
  static int run(const void* x, const void* dmid, const void* bits, void* part, int M, int K,
                 int split, uint32_t seed, int row0, int col0, int thr, float scale,
                 cudaStream_t stream) {
    const dim3 grid(K / CH, split);
    lora_da_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dmid),
        static_cast<const uint8_t*>(bits), static_cast<float*>(part), M, K, split, seed, row0, col0, thr,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int R>
struct DxLaunch {
  static int run(const void* dmid, const void* a, const void* bits, void* dx, int M, int K,
                 uint32_t seed, int row0, int col0, int thr, float inv_keep, cudaStream_t stream) {
    const dim3 grid((M + 15) / 16, (K + 4 * CH - 1) / (4 * CH));
    lora_dx_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dmid), static_cast<const __nv_bfloat16*>(a),
        static_cast<const uint8_t*>(bits), static_cast<__nv_bfloat16*>(dx), M, K, seed, row0, col0, thr,
        inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// Plain-C launchers (bound with ctypes): the caller's current device and
// stream, K a multiple of 64, R in {16, 32, 64, 128}, bits null for the
// hash (of global rows row0 + row and columns col0 + col). Each returns
// cudaGetLastError() after its launch.
extern "C" int lora_fwd_launch(const void* x, const void* a, const void* bits, void* part,
                               int M, int K, int R, int split, uint32_t seed, int row0, int col0,
                               int thr, float scale, void* stream) {
  return dispatch_rank<FwdLaunch>(R, x, a, bits, part, M, K, split, seed, row0, col0, thr, scale,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int lora_dx_launch(const void* dmid, const void* a, const void* bits, void* dx,
                              int M, int K, int R, uint32_t seed, int row0, int col0, int thr,
                              float inv_keep, void* stream) {
  return dispatch_rank<DxLaunch>(R, dmid, a, bits, dx, M, K, seed, row0, col0, thr, inv_keep,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lora_da_launch(const void* x, const void* dmid, const void* bits, void* part,
                              int M, int K, int R, int split, uint32_t seed, int row0, int col0,
                              int thr, float scale, void* stream) {
  return dispatch_rank<DaLaunch>(R, x, dmid, bits, part, M, K, split, seed, row0, col0, thr, scale,
                                 static_cast<cudaStream_t>(stream));
}
