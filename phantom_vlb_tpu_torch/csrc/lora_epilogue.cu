// Fused LoRA rank-r epilogue for Hopper (sm_90a): forward, dz and dB.
//
// Replaces phantom_vlb_tpu/ops/lora_epilogue.py:_fwd_kernel (line 45),
// _dz_kernel (:51) and _db_kernel (:69), reached through lora_epilogue
// (:96):
//   out = bf16(y + bf16(bf16(z @ B) * s))   f32 sums, the reference's roundings
//   dz  = bf16(s * (dy @ B^T))              f32 sums
//   dB  = bf16(s * (z^T @ dy))              f32 sums
// with y, dy (M, N) bf16, z (M, r) bf16, B (r, N) bf16, r <= 128, s the
// LoRA scaling (rounded to bf16 by the caller for the forward, f32 in the
// backward, as the reference multiplies). d(y) = dy passes through in the
// caller. The TPU's rank padding to 128 lanes is not copied: the rank is
// padded in shared memory and registers to the next of 16, 32, 64, 128, and
// M and N tails are masked in the loads and stores.
//
// Bound: bytes. At M = 6144, N = 4096 the forward moves y in and out out
// (100.7 MB, 30.0 us at 3.35 TB/s); dz and dB each read dy once (50.3 MB,
// 15.0 us). At N = 14336: 105.2 us and 52.6 us. z and B are a few hundred
// KB.
//
// Design (simple and right first):
// - forward: a block of 8 warps owns 32 rows x 256 columns; each thread
//   holds 4 rows x 8 neighbouring columns, prefetches its y (16 bytes a
//   row) before the rank loop, and makes r f32 FMAs per element from z and
//   B chunks of 16 ranks staged as f32 in shared memory (z read as a
//   broadcast, B as two 16-byte reads per rank).
// - dz: a block of 4 warps owns 64 rows of M and a contiguous share of the
//   64-column chunks of N; dy's 64 x 64 chunk and B's R x 64 chunk go to
//   shared memory (next chunk prefetched into registers), and each warp
//   multiplies its 16 rows with mma.sync.m16n8k16 (B's fragments by a plain
//   ldmatrix: B is stored rank-major, as the MMA's column operand wants).
//   Partial sums per share go to an f32 (split, M, R) buffer, and a second
//   small kernel sums the shares in order, scales by s and rounds once.
// - dB: the same with the roles turned: a block owns 64 columns of N and a
//   share of the 64-row chunks of M, and transposing ldmatrix reads give
//   dy^T and z as the MMA's operands, so dB^T (N, R) partials go to
//   (split, N, R) f32; the second kernel writes dB (r, N).
// The split (a few shares per block, ~4 blocks per SM) keeps the card
// full; the order of the f32 sums is fixed, so results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;                 // chunk edge (rows and columns) of dz / dB
constexpr int NTHREADS = 128;          // dz / dB blocks
constexpr int SROW = CH + 8;           // padded shared row of a 64-wide chunk
constexpr int FWD_ROWS = 32, FWD_COLS = 256, FWD_RK = 16, FWD_THREADS = 256;

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 bf16 at (row, col .. col + 7) of a row-major matrix with leading
// dimension ld, zeros outside (rows, cols). `vec`: ld % 8 == 0 and an
// aligned base, so a piece that lies wholly inside is one 16-byte load.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ g, int rows, int cols,
                                       int ld, int row, int col, bool vec) {
  if (row >= rows || col >= cols) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = g + static_cast<size_t>(row) * ld + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < cols ? e[2 * i] : 0u;
    const uint32_t hi = col + 2 * i + 1 < cols ? e[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* __restrict__ g, size_t i) {
  return __bfloat162float(g[i]);
}

// Forward: grid (ceil(N/256), ceil(M/32)), 256 threads.
__global__ void __launch_bounds__(FWD_THREADS)
epi_fwd_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ z,
               const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out,
               int M, int N, int r, float s, bool vec_y) {
  __shared__ float zs[FWD_ROWS][FWD_RK + 1];
  __shared__ __align__(16) float bs[FWD_RK][FWD_COLS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * FWD_ROWS, n0 = blockIdx.x * FWD_COLS;
  const int col = n0 + lane * 8;
  constexpr int RPT = FWD_ROWS / (FWD_THREADS / 32);    // rows a thread: 4

  uint4 yv[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) yv[i] = load8(y, M, N, N, m0 + warp * RPT + i, col, vec_y);

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < r; k0 += FWD_RK) {
    for (int e = tid; e < FWD_ROWS * FWD_RK; e += FWD_THREADS) {
      const int row = m0 + e / FWD_RK, k = k0 + e % FWD_RK;
      zs[e / FWD_RK][e % FWD_RK] = row < M && k < r ? bf16_at(z, static_cast<size_t>(row) * r + k) : 0.0f;
    }
    for (int e = tid; e < FWD_RK * FWD_COLS; e += FWD_THREADS) {
      const int k = k0 + e / FWD_COLS, c = n0 + e % FWD_COLS;
      bs[e / FWD_COLS][e % FWD_COLS] = k < r && c < N ? bf16_at(b, static_cast<size_t>(k) * N + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FWD_RK; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][lane * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][lane * 8 + 4]);
      const float bk[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float zk = zs[warp * RPT + i][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zk, bk[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = m0 + warp * RPT + i;
    if (row >= M || col >= N) continue;
    float yf[8];
    unpack8(yv[i], yf);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = __fadd_rn(yf[2 * j], bf16_round(__fmul_rn(bf16_round(acc[i][2 * j]), s)));
      const float hi = __fadd_rn(yf[2 * j + 1], bf16_round(__fmul_rn(bf16_round(acc[i][2 * j + 1]), s)));
      __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      w[j] = *reinterpret_cast<uint32_t*>(&v);
    }
    __nv_bfloat16* dst = out + static_cast<size_t>(row) * N + col;
    if (vec_y && col + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(w);
      uint16_t* d = reinterpret_cast<uint16_t*>(dst);
      for (int j = 0; j < 8 && col + j < N; ++j) d[j] = h[j];
    }
  }
}

// A 64 x 64 chunk of a row-major (rows, cols) bf16 matrix at (r0, c0):
// 512 pieces of 16 bytes, 4 a thread, prefetched into registers.
struct Chunk64 {
  uint4 v[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* g, int rows, int cols, int ld,
                                       int r0, int c0, bool vec, int tid) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = tid + u * NTHREADS;
      v[u] = load8(g, rows, cols, ld, r0 + (c >> 3), c0 + (c & 7) * 8, vec);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16 (*s)[SROW], int tid) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = tid + u * NTHREADS;
      *reinterpret_cast<uint4*>(&s[c >> 3][(c & 7) * 8]) = v[u];
    }
  }
};

// NR rows x NC columns (NC a multiple of 8) of a row-major (rows, cols) bf16
// matrix at (r0, c0): NR * NC / 8 pieces, NR * NC / (8 * 128) a thread.
template <int NR, int NC>
struct Tile {
  static constexpr int PER = NR * NC / (8 * NTHREADS);
  uint4 v[PER];
  __device__ __forceinline__ void load(const __nv_bfloat16* g, int rows, int cols, int ld,
                                       int r0, int c0, bool vec, int tid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = tid + u * NTHREADS;
      v[u] = load8(g, rows, cols, ld, r0 + c / (NC / 8), c0 + (c % (NC / 8)) * 8, vec);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16 (*s)[NC + 8], int tid) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = tid + u * NTHREADS;
      *reinterpret_cast<uint4*>(&s[c / (NC / 8)][(c % (NC / 8)) * 8]) = v[u];
    }
  }
};

__device__ __forceinline__ void share_range(int chunks, int split, int& begin, int& end) {
  begin = static_cast<int>(static_cast<long long>(chunks) * blockIdx.y / split);
  end = static_cast<int>(static_cast<long long>(chunks) * (blockIdx.y + 1) / split);
}

// dz partials: grid (ceil(M/64), split); part[split][M][R] f32.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
epi_dz_kernel(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ b,
              float* __restrict__ part, int M, int N, int r, int split, bool vec_dy, bool vec_b) {
  __shared__ __align__(16) __nv_bfloat16 ds[CH][SROW];
  __shared__ __align__(16) __nv_bfloat16 bs[R][SROW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int m0 = blockIdx.x * CH;
  int c_begin, c_end;
  share_range((N + CH - 1) / CH, split, c_begin, c_end);

  float acc[R / 8][4];
#pragma unroll
  for (int n = 0; n < R / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  Chunk64 dc;
  Tile<R, CH> bc;
  if (c_begin < c_end) {
    dc.load(dy, M, N, N, m0, c_begin * CH, vec_dy, tid);
    bc.load(b, r, N, N, 0, c_begin * CH, vec_b, tid);
  }
  for (int c = c_begin; c < c_end; ++c) {
    dc.store(ds, tid);
    bc.store(bs, tid);
    __syncthreads();
    if (c + 1 < c_end) {
      dc.load(dy, M, N, N, m0, (c + 1) * CH, vec_dy, tid);
      bc.load(b, r, N, N, 0, (c + 1) * CH, vec_b, tid);
    }
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
      uint32_t da[4];
      ldmatrix_x4(da, &ds[warp * 16 + (mat & 1) * 8 + mr][ks * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < R / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, &bs[np * 16 + (mat >> 1) * 8 + mr][ks * 16 + (mat & 1) * 8]);
        mma_bf16(acc[2 * np], da, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], da, bb[2], bb[3]);
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

// dB^T partials: grid (ceil(N/64), split); part[split][N][R] f32.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
epi_db_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ dy,
              float* __restrict__ part, int M, int N, int r, int split, bool vec_z, bool vec_dy) {
  __shared__ __align__(16) __nv_bfloat16 ys[CH][SROW];
  __shared__ __align__(16) __nv_bfloat16 zs[CH][R + 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int n0 = blockIdx.x * CH;
  int c_begin, c_end;
  share_range((M + CH - 1) / CH, split, c_begin, c_end);

  float acc[R / 8][4];
#pragma unroll
  for (int n = 0; n < R / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  Chunk64 yc;
  Tile<CH, R> zc;
  if (c_begin < c_end) {
    yc.load(dy, M, N, N, c_begin * CH, n0, vec_dy, tid);
    zc.load(z, M, r, r, c_begin * CH, 0, vec_z, tid);
  }
  for (int c = c_begin; c < c_end; ++c) {
    yc.store(ys, tid);
    zc.store(zs, tid);
    __syncthreads();
    if (c + 1 < c_end) {
      yc.load(dy, M, N, N, (c + 1) * CH, n0, vec_dy, tid);
      zc.load(z, M, r, r, (c + 1) * CH, 0, vec_z, tid);
    }
    // acc (16 columns of N x R) += dy^T z over this chunk's 64 rows.
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
      uint32_t ya[4];
      ldmatrix_x4_trans(ya, &ys[ks * 16 + (mat >> 1) * 8 + mr][warp * 16 + (mat & 1) * 8]);
#pragma unroll
      for (int np = 0; np < R / 16; ++np) {
        uint32_t zb[4];
        ldmatrix_x4_trans(zb, &zs[ks * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(acc[2 * np], ya, zb[0], zb[1]);
        mma_bf16(acc[2 * np + 1], ya, zb[2], zb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int col = n0 + warp * 16 + g + 8 * e2;
    if (col < N) {
      float* dst = part + (static_cast<size_t>(blockIdx.y) * N + col) * R + 2 * t;
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
      }
    }
  }
}

// out = bf16(s * sum over the split of part[., i, k]) for i < rows, k < r,
// at out[i * r + k] (dz) or out[k * rows + i] (dB from dB^T partials).
__global__ void epi_finalize_kernel(const float* __restrict__ part, int split, int rows, int R,
                                    int r, float s, bool transpose, __nv_bfloat16* __restrict__ out) {
  const size_t total = static_cast<size_t>(rows) * r;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t i, k;
    if (transpose) {
      k = e / rows;
      i = e % rows;
    } else {
      i = e / r;
      k = e % r;
    }
    float v = 0.0f;
    for (int p = 0; p < split; ++p) v += part[(static_cast<size_t>(p) * rows + i) * R + k];
    out[e] = __float2bfloat16_rn(s * v);
  }
}

int finalize(const float* part, int split, int rows, int R, int r, float s, bool transpose,
             void* out, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(rows) * r;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  epi_finalize_kernel<<<blocks, 256, 0, stream>>>(part, split, rows, R, r, s, transpose,
                                                  static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int R>
struct DzLaunch {
  static int run(const void* dy, const void* b, void* part, void* dz, int M, int N, int r,
                 int split, float s, cudaStream_t stream) {
    const dim3 grid((M + CH - 1) / CH, split);
    epi_dz_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(part), M, N, r, split, N % 8 == 0 && aligned16(dy),
        N % 8 == 0 && aligned16(b));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    return finalize(static_cast<const float*>(part), split, M, R, r, s, false, dz, stream);
  }
};

template <int R>
struct DbLaunch {
  static int run(const void* z, const void* dy, void* part, void* db, int M, int N, int r,
                 int split, float s, cudaStream_t stream) {
    const dim3 grid((N + CH - 1) / CH, split);
    epi_db_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(dy),
        static_cast<float*>(part), M, N, r, split, r % 8 == 0 && aligned16(z),
        N % 8 == 0 && aligned16(dy));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    return finalize(static_cast<const float*>(part), split, N, R, r, s, true, db, stream);
  }
};

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

}  // namespace

// Plain-C launchers (bound with ctypes): the caller's current device and
// stream, contiguous row-major bf16 tensors, 0 < r <= R, R in {16, 32, 64,
// 128} the padded rank, part an f32 (split, M or N, R) scratch buffer. Each
// returns cudaGetLastError() after its last launch.
extern "C" int epi_fwd_launch(const void* y, const void* z, const void* b, void* out, int M, int N,
                              int r, float s, void* stream) {
  if (M <= 0 || N <= 0 || r <= 0 || r > 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + FWD_COLS - 1) / FWD_COLS, (M + FWD_ROWS - 1) / FWD_ROWS);
  epi_fwd_kernel<<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(z),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), M, N, r, s,
      N % 8 == 0 && aligned16(y) && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int epi_dz_launch(const void* dy, const void* b, void* part, void* dz, int M, int N,
                             int r, int R, int split, float s, void* stream) {
  if (M <= 0 || N <= 0 || r <= 0 || r > R || split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_rank<DzLaunch>(R, dy, b, part, dz, M, N, r, split, s,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int epi_db_launch(const void* z, const void* dy, void* part, void* db, int M, int N,
                             int r, int R, int split, float s, void* stream) {
  if (M <= 0 || N <= 0 || r <= 0 || r > R || split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_rank<DbLaunch>(R, z, dy, part, db, M, N, r, split, s,
                                 static_cast<cudaStream_t>(stream));
}
